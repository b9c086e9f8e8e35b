// The standalone depthwise 3x3 (TF-SAME, stride 1 or 2) on Hopper: one
// persistent kernel template for the float kernel (depthwise.cu: bf16 and
// float32) and the int8 kernel (depthwise_i8.cu).
//
// What bounds it on an H100: memory. Per output element it does 9
// multiply-adds and reads 1-4 new input elements (the 3x3 windows overlap),
// far below the card's ~295 operations per byte; the least time is the
// input read once and the output written once at 3.35 TB/s. The parent
// kernels loaded a tile's window synchronously and computed it only after a
// block-wide barrier (the float kernel), or read each tap straight from
// global memory one 4-channel word at a time (the int8 kernel), so loads and
// compute never overlapped. The design:
//   - Units: a band of TH output rows x TW output columns of one image x a
//     channel slice of NV 16-byte vectors (up to 256 bytes of a pixel). A
//     persistent block keeps one slice (block b: slice b % slices) and walks
//     that slice's bands (b / slices, stepping by the blocks a slice has), so
//     each consumer thread loads its 16 bytes of channels' weights (nine taps,
//     bias, and in int8 the multipliers) once a kernel and keeps them in
//     registers.
//   - A window ring: one producer warp stages each unit's input window,
//     (TH-1)s+3 rows x (TW-1)s+3 columns x the slice, into a ring of WS slots
//     tracked by full and empty mbarriers, while the consumers compute the
//     slot before: one TMA box of a rank-4 map (C, W, H, N), so rows and
//     columns off the image (TF-SAME padding: the low pad is total // 2, an
//     odd input at stride 2 pads both sides) load as zeros; where a pixel's
//     bytes are not a multiple of 16 (int8 with C % 16 == 8, which a TMA map
//     cannot stride) the producer's 32 lanes copy 8-byte granules with
//     cp.async instead, zero-filled off the image, and arrive on the slot's
//     full barrier when their copies land.
//   - Consumers: 8 warps; thread t takes vector t % NV of the slice and, of
//     a unit's items (a segment of SEG output rows x one output column), every
//     (256 / NV)-th. It slides down its segment holding the 3 x 3 taps in
//     registers, reading each input row's three taps from shared memory once
//     (stride 1: one new row an output row; stride 2: two), and stores 16
//     bytes of channels to NHWC global memory (8 for int8's half vector at C
//     % 16 == 8; nothing past C).
// Arithmetic: int8 is int8_tile.cuh's depthwise stage, the one the fused
// int8 block runs (exact). float is the plain version's: the taps' f32 sum in
// dy-then-dx order from 0, + the bias after the sum, ReLU or ReLU6, one
// rounding to the output type; bf16 products are exact in f32, so each step
// is an fmaf, float32 a __fmul_rn then a __fadd_rn (never contracted). The
// plan (TH, TW, SEG, NV, WS) is ops/depthwise.dw_plan's.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_tile.cuh"

namespace mnk {
namespace dwr {

constexpr int CONSUMERS = 256;           // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int VEC = 16;                  // bytes of channels a consumer thread
constexpr int MAX_VECS = 16;             // a slice: at most 256 bytes of a pixel
constexpr int MAX_SLOTS = 4;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use
constexpr int BASE_ALIGN = 128;          // TMA destinations: 128-byte aligned

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Geo {
  int N, H, W, C, elem, stride, Ho, Wo, pad_h, pad_w;
  int th, tw, seg, nv, ws;  // the plan
  int cb;                   // bytes of a pixel: C * elem
  int pix;                  // bytes of a pixel's slice in a slot: nv * 16
  int nslices, bands_h, bands_w, bands, wh, ww, nseg, lanes;
  int slot_bytes, slot_stride, bar_off, smem_bytes;
  bool tma;  // TMA boxes; else cp.async granules (cb % 16 == 8)
};

__host__ __device__ inline Geo make_geo(int N, int H, int W, int C, int elem, int stride,
                                        int th, int tw, int seg, int nv, int ws) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.elem = elem; g.stride = stride;
  g.th = th; g.tw = tw; g.seg = seg; g.nv = nv; g.ws = ws;
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.pad_h = same_pad_lo(H, stride, g.Ho);
  g.pad_w = same_pad_lo(W, stride, g.Wo);
  g.cb = C * elem;
  g.pix = nv * VEC;
  g.nslices = cdiv(cdiv(g.cb, VEC), nv);
  g.bands_h = cdiv(g.Ho, th);
  g.bands_w = cdiv(g.Wo, tw);
  g.bands = N * g.bands_h * g.bands_w;
  g.wh = (th - 1) * stride + 3;
  g.ww = (tw - 1) * stride + 3;
  g.nseg = cdiv(th, seg);
  g.lanes = CONSUMERS / nv;
  g.slot_bytes = g.wh * g.ww * g.pix;
  g.slot_stride = cdiv(g.slot_bytes, BASE_ALIGN) * BASE_ALIGN;
  g.bar_off = ws * g.slot_stride;
  g.smem_bytes = BASE_ALIGN + g.bar_off + 2 * ws * 8;
  g.tma = g.cb % VEC == 0;
  return g;
}

// cudaErrorInvalidValue if a plan breaks a rule of the kernel (the Python
// plan never gives such a plan).
inline cudaError_t check_geo(const Geo& g) {
  const bool ok = g.N > 0 && g.H > 0 && g.W > 0 && g.C > 0 && g.cb % 8 == 0 &&
                  (g.stride == 1 || g.stride == 2) && g.th >= 1 && g.tw >= 1 && g.seg >= 1 &&
                  g.seg <= g.th && g.nv >= 1 && g.nv <= MAX_VECS && g.ws >= 1 &&
                  g.ws <= MAX_SLOTS && g.wh <= 256 && g.ww <= 256 &&
                  g.smem_bytes <= SMEM_LIMIT && (long long)g.bands * g.nslices < (1LL << 31);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// A launch's tensors: x (read by the cp.async producer; the TMA map holds
// it otherwise), the weight (3, 3, 1, C), the bias (C,) or null (float), the
// int8 multipliers (C,), out; `hi`: the clamp's upper bound (int8: min(six_q,
// 127) with ReLU6, else 127; float: 6 with ReLU6, else +inf).
struct Args {
  const void* x;
  const void* w;
  const void* b;
  const float* m;
  void* out;
  float hi;
};

struct Ring {
  unsigned char* slots;
  uint64_t *full, *empty;
};

__device__ __forceinline__ Ring ring_of(const Geo& g, unsigned char* raw) {
  const uint32_t a = hop::saddr(raw);
  unsigned char* base = raw + ((BASE_ALIGN - (a & (BASE_ALIGN - 1))) & (BASE_ALIGN - 1));
  Ring r;
  r.slots = base;
  r.full = reinterpret_cast<uint64_t*>(base + g.bar_off);
  r.empty = r.full + g.ws;
  return r;
}

// The output origin of band b: image, first output row and column.
struct Band {
  int n, oh0, wo0;
};

__device__ __forceinline__ Band band_of(const Geo& g, int b) {
  const int per = g.bands_h * g.bands_w;
  Band u;
  u.n = b / per;
  const int r = b - u.n * per, bh = r / g.bands_w;
  u.oh0 = bh * g.th;
  u.wo0 = (r - bh * g.bands_w) * g.tw;
  return u;
}

// ---- the producer -------------------------------------------------------------

// Lane 0: one TMA box a unit, at (the slice's first channel, the window's
// first column, first row, image); the box may start before the image and
// end past it or past C: those elements load as zeros.
__device__ inline void produce_tma(const Geo& g, const Ring& r, const CUtensorMap* map,
                                   int slice) {
  const int c0 = slice * g.pix / g.elem;
  uint32_t k = 0;
  for (int b = blockIdx.x / g.nslices; b < g.bands; b += gridDim.x / g.nslices, ++k) {
    const Band u = band_of(g, b);
    const uint32_t s = k % g.ws;
    hop::mbar_wait(r.empty + s, ((k / g.ws) & 1) ^ 1);
    hop::mbar_arrive_expect_tx(r.full + s, g.slot_bytes);
    hop::tma_load_4d(r.slots + s * g.slot_stride, map, r.full + s, c0,
                     u.wo0 * g.stride - g.pad_w, u.oh0 * g.stride - g.pad_h, u.n);
  }
}

// All 32 lanes: the window's pixels' bytes of the slice that lie within C,
// as 8-byte granules (zeros off the image), then each lane's arrival once
// its copies land (the full barriers count 32).
__device__ inline void produce_copies(const Geo& g, const Ring& r,
                                      const unsigned char* __restrict__ x, int slice) {
  const int lane = threadIdx.x & 31;
  const int c0b = slice * g.pix;
  const int nq = min(g.pix, g.cb - c0b) / 8;  // granules of a pixel
  const int items = g.wh * g.ww * nq;
  uint32_t k = 0;
  for (int b = blockIdx.x / g.nslices; b < g.bands; b += gridDim.x / g.nslices, ++k) {
    const Band u = band_of(g, b);
    const uint32_t s = k % g.ws;
    hop::mbar_wait(r.empty + s, ((k / g.ws) & 1) ^ 1);
    unsigned char* dst = r.slots + s * g.slot_stride;
    const int h0 = u.oh0 * g.stride - g.pad_h, w0 = u.wo0 * g.stride - g.pad_w;
    for (int i = lane; i < items; i += 32) {
      const int p = i / nq, q = i - p * nq;
      const int row = p / g.ww, col = p - row * g.ww;
      const int hh = h0 + row, wc = w0 + col;
      const bool in = (unsigned)hh < (unsigned)g.H && (unsigned)wc < (unsigned)g.W;
      const unsigned char* src =
          in ? x + (((long long)u.n * g.H + hh) * g.W + wc) * g.cb + c0b + 8 * q : x;
      hop::cp_async8_zfill(dst + p * g.pix + 8 * q, src, in ? 8u : 0u);
    }
    hop::cp_async_mbar_arrive(r.full + s);
  }
  hop::cp_async_wait<0>();
}

// ---- the arithmetic -----------------------------------------------------------

// int8: a thread's 16 channels (int8_tile.cuh's stage).
struct OpI8 {
  static constexpr int kElem = 1;
  struct Weights {
    DwGroup d;
  };
  // channels [ch, ch + bytes) of the weights (bytes 16 or 8); returns
  // whether every bias allows the magic conversion
  static __device__ __forceinline__ bool load(Weights& w, const Geo& g, const Args& a, int ch,
                                              int bytes) {
    return load_dw_group(static_cast<const int8_t*>(a.w), static_cast<const int*>(a.b), a.m,
                         g.C, ch, bytes / 4, w.d);
  }
  template <bool kMagic>
  static __device__ __forceinline__ uint4 compute(const uint4 (&v)[9], const Weights& w,
                                                  float hi) {
    return dw16<kMagic>(v, w.d, hi);
  }
};

// float: 8 bf16 or 4 float32 channels, weights and bias held as f32.
template <typename T>
struct OpFloat {
  static constexpr int kElem = sizeof(T);
  static constexpr int V = VEC / sizeof(T);
  struct Weights {
    float w[9][V];
    float b[V];
  };

  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[V]) {
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(q[i] << 16);
        f[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(q[i]);
    }
  }

  static __device__ __forceinline__ bool load(Weights& w, const Geo& g, const Args& a, int ch,
                                              int) {
    const T* wt = static_cast<const T*>(a.w);
#pragma unroll
    for (int k = 0; k < 9; ++k) unpack(*reinterpret_cast<const uint4*>(wt + k * g.C + ch), w.w[k]);
    if (a.b != nullptr) {
      unpack(*reinterpret_cast<const uint4*>(static_cast<const T*>(a.b) + ch), w.b);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) w.b[j] = 0.0f;
    }
    return false;
  }

  template <bool>
  static __device__ __forceinline__ uint4 compute(const uint4 (&v)[9], const Weights& w,
                                                  float hi) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float x[V];
      unpack(v[k], x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (sizeof(T) == 2)
          acc[j] = fmaf(x[j], w.w[k][j], acc[j]);  // the product is exact
        else
          acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], w.w[k][j]));
      }
    }
    float y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = fminf(fmaxf(__fadd_rn(acc[j], w.b[j]), 0.0f), hi);
    if constexpr (sizeof(T) == 2) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
        o[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
      return make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
                        __float_as_uint(y[3]));
    }
  }
};

// ---- the consumers ------------------------------------------------------------

// The three taps (dx = 0, 1, 2) of a window row at p.
__device__ __forceinline__ void load_row(const unsigned char* p, int pix, uint4* t) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) t[dx] = *reinterpret_cast<const uint4*>(p + dx * pix);
}

// Every unit of this block: wait for its slot, compute this thread's items,
// free the slot (one arrival a warp).
template <class Op, int S, bool kFlag>
__device__ void consume(const Geo& g, const Ring& r, const Args& a, int slice,
                        const typename Op::Weights& w, int bytes) {
  const int t = threadIdx.x;
  const int v = t % g.nv, lane = t / g.nv;
  const bool work = lane < g.lanes && bytes > 0;
  const long long c0b = (long long)slice * g.pix + v * VEC;
  const int rowb = g.ww * g.pix;
  const long long ostep = (long long)g.Wo * g.cb;
  unsigned char* out = static_cast<unsigned char*>(a.out);
  uint32_t k = 0;
  for (int b = blockIdx.x / g.nslices; b < g.bands; b += gridDim.x / g.nslices, ++k) {
    const Band u = band_of(g, b);
    const uint32_t s = k % g.ws;
    hop::mbar_wait(r.full + s, (k / g.ws) & 1);
    if (work) {
      const unsigned char* win = r.slots + s * g.slot_stride + v * VEC;
      const int rows = min(g.th, g.Ho - u.oh0), cols = min(g.tw, g.Wo - u.wo0);
      for (int it = lane; it < g.nseg * g.tw; it += g.lanes) {
        const int si = it / g.tw, ow = it - si * g.tw;
        const int r0 = si * g.seg, r1 = min(rows, r0 + g.seg);
        if (ow >= cols || r0 >= r1) continue;
        const unsigned char* p = win + (r0 * S * g.ww + ow * S) * g.pix;
        long long o = (((long long)u.n * g.Ho + u.oh0 + r0) * g.Wo + u.wo0 + ow) * g.cb + c0b;
        uint4 tap[9];
        load_row(p, g.pix, tap);
        if constexpr (S == 1) load_row(p + rowb, g.pix, tap + 3);
        p += (S == 1 ? 2 : 1) * rowb;
#pragma unroll 2
        for (int rr = r0; rr < r1; ++rr, o += ostep) {
          if constexpr (S == 2) {
            load_row(p, g.pix, tap + 3);
            p += rowb;
          }
          load_row(p, g.pix, tap + 6);
          p += rowb;
          const uint4 y = Op::template compute<kFlag>(tap, w, a.hi);
          if (bytes == VEC)
            *reinterpret_cast<uint4*>(out + o) = y;
          else
            *reinterpret_cast<uint2*>(out + o) = make_uint2(y.x, y.y);
#pragma unroll
          for (int i = 0; i < (S == 1 ? 6 : 3); ++i) tap[i] = tap[i + (S == 1 ? 3 : 6)];
        }
      }
    }
    __syncwarp();
    if ((t & 31) == 0) hop::mbar_arrive(r.empty + s);
  }
}

template <class Op, int S, bool kTma>
__global__ void __launch_bounds__(THREADS, 1)
    depthwise_ring_kernel(const __grid_constant__ CUtensorMap map, const Args a, const Geo g) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_of(g, smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.ws; ++s) {
      hop::mbar_init(r.full + s, kTma ? 1 : 32);
      hop::mbar_init(r.empty + s, CONSUMERS / 32);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
  const int slice = blockIdx.x % g.nslices;
  if (threadIdx.x >= CONSUMERS) {
    if constexpr (kTma) {
      if (threadIdx.x == CONSUMERS) produce_tma(g, r, &map, slice);
    } else {
      produce_copies(g, r, static_cast<const unsigned char*>(a.x), slice);
    }
    return;
  }
  // this thread's bytes of channels: 16, 8 (int8's half vector) or 0
  const int c0b = slice * g.pix + (threadIdx.x % g.nv) * VEC;
  const int bytes = max(0, min(VEC, g.cb - c0b));
  typename Op::Weights w;
  const bool magic = bytes > 0 && Op::load(w, g, a, c0b / g.elem, bytes);
  if constexpr (Op::kElem == 1) {
    if (magic) {
      consume<Op, S, true>(g, r, a, slice, w, bytes);
      return;
    }
  }
  consume<Op, S, false>(g, r, a, slice, w, bytes);
}

// ---- host ---------------------------------------------------------------------

template <class Op>
inline CUtensorMapDataType map_type() {
  return Op::kElem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : Op::kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Host templates are static: their once-a-device cache stays this
// library's, also where a second build of it is loaded beside (a GNU unique
// symbol otherwise, shared by the process).
template <class Op, int S, bool kTma>
static cudaError_t launch_kernel(const Geo& g, const Args& a, cudaStream_t stream) {
  auto kernel = depthwise_ring_kernel<Op, S, kTma>;
  // once a device: the shared-memory limit any plan may take, and the SMs
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    int count = 0;
    if ((e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    sms[dev] = count;
  }
  CUtensorMap map{};
  if (kTma) {
    const cuuint64_t e1 = (cuuint64_t)g.elem;
    const cuuint64_t dims[4] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H,
                                (cuuint64_t)g.N};
    const cuuint64_t strides[3] = {g.C * e1, (cuuint64_t)g.W * g.C * e1,
                                   (cuuint64_t)g.H * g.W * g.C * e1};
    const cuuint32_t box[4] = {(cuuint32_t)(g.pix / g.elem), (cuuint32_t)g.ww,
                               (cuuint32_t)g.wh, 1};
    e = hop::make_map_4d(&map, map_type<Op>(), a.x, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  // blocks a slice: the bands, at most the card's SMs shared by the slices
  const int per = max(1, min(g.bands, sms[dev] / g.nslices));
  kernel<<<(unsigned)(per * g.nslices), THREADS, g.smem_bytes, stream>>>(map, a, g);
  return cudaGetLastError();
}

template <class Op>
static int launch(const Args& a, int N, int H, int W, int C, int stride, int th, int tw, int seg,
           int nv, int ws, void* stream) {
  const uintptr_t addr = (uintptr_t)a.x | (uintptr_t)a.w | (uintptr_t)a.b | (uintptr_t)a.m |
                         (uintptr_t)a.out;
  if (addr % 16) return (int)cudaErrorMisalignedAddress;
  const Geo g = make_geo(N, H, W, C, Op::kElem, stride, th, tw, seg, nv, ws);
  cudaError_t e = check_geo(g);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.tma)
    return (int)(stride == 1 ? launch_kernel<Op, 1, true>(g, a, st)
                             : launch_kernel<Op, 2, true>(g, a, st));
  if constexpr (Op::kElem == 1)
    return (int)(stride == 1 ? launch_kernel<Op, 1, false>(g, a, st)
                             : launch_kernel<Op, 2, false>(g, a, st));
  return (int)cudaErrorInvalidValue;  // a float pixel is a multiple of 16 bytes
}

}  // namespace dwr
}  // namespace mnk
