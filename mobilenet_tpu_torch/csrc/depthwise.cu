// Standalone float depthwise 3x3 (TF-SAME, stride 1 or 2) + bias + ReLU or
// ReLU6, NHWC, float32 or bf16 in and out, float32 accumulation.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_dw.py
// depthwise_conv_pallas (:112): the per-layer float route of MobileNet-V1
// ("dw" routing, the JAX package's "pallas") and the depthwise taps that
// the per-layer collect takes under "fused" routing.
//
// Arithmetic, as the TPU kernel's: out = act(sum over taps in (dy, dx)
// order of x * w, + bias), every step a float32 multiply then a float32 add
// (__fmul_rn, __fadd_rn: never contracted into an FMA, so the sum rounds as
// the plain version's does), the bias added after the sum, then max(., 0)
// and with relu6 min(., 6), rounded to the input dtype. The TPU kernel has
// no "no activation" mode; neither has this one. TF-SAME padding: the low
// pad is total // 2 (stride 2 on an even input pads (0, 1); an odd input
// pads both sides).
//
// What bounds it on an H100: memory. Per output element it does 9
// multiply-adds and reads 1-4 new input elements (the 3x3 windows overlap),
// far below the card's ~295 operations per byte; the least time is the
// input read once and the output written once at 3.35 TB/s. The design:
// channels ride the fast axis as 16-byte vectors (4 float32 or 8 bf16
// channels per thread); a block takes one image's tile of TH x TW output
// pixels and a slice of up to 16 vectors (256 bytes) of channels, stages
// the tile's input window with its halo in shared memory once (coalesced
// 16-byte loads, zeros outside the image), and each thread then keeps its
// channel vector's nine weights in registers and walks its share of the
// tile's pixels. No lane packing and no 128/256-channel tiles: those were
// the TPU's (8, 128) layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int DW_THREADS = 256;
constexpr int MAX_SLICE_VECS = 16;  // 16 x 16 bytes of channels per block

struct DwShape {
  int N, H, W, C, stride, Ho, Wo, pad_h, pad_w;
  int TH, TW, RH, RW;  // output tile, input window (with halo)
  int slice;           // channel vectors per block
  int tiles_h, tiles_w;
  bool relu6;
};

// 16 bytes of channels: 4 float32 or 8 bf16 (as their raw 16 bits).
union Vec16 {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

template <typename T> struct VecTraits;
template <> struct VecTraits<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float get(const Vec16& v, int i) { return v.f[i]; }
  __device__ __forceinline__ static void put(Vec16& v, int i, float y) { v.f[i] = y; }
};
template <> struct VecTraits<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float get(const Vec16& v, int i) {
    return __bfloat162float(__ushort_as_bfloat16(v.h[i]));
  }
  __device__ __forceinline__ static void put(Vec16& v, int i, float y) {
    v.h[i] = __bfloat16_as_ushort(__float2bfloat16(y));
  }
};

__host__ __device__ inline int same_lo(int size, int stride) {
  const int out = (size + stride - 1) / stride;
  const int total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
    depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ out, DwShape s) {
  using Tr = VecTraits<T>;
  constexpr int V = Tr::V;
  extern __shared__ uint4 win[];  // RH x RW pixels x `nv` vectors

  const int vecs = s.C / V;
  const int v0 = blockIdx.y * s.slice;  // first channel vector of the slice
  const int nv = min(s.slice, vecs - v0);
  long long t = blockIdx.x;
  const int tw_i = int(t % s.tiles_w);
  t /= s.tiles_w;
  const int th_i = int(t % s.tiles_h);
  const int n = int(t / s.tiles_h);
  const int ho0 = th_i * s.TH, wo0 = tw_i * s.TW;
  const int h0 = ho0 * s.stride - s.pad_h, w0 = wo0 * s.stride - s.pad_w;

  // Stage the input window, channel vectors fastest: consecutive threads
  // read consecutive 16 bytes of one pixel's channel slice.
  const T* xn = x + (long long)n * s.H * s.W * s.C + (long long)v0 * V;
  const int total = s.RH * s.RW * nv;
  for (int i = threadIdx.x; i < total; i += DW_THREADS) {
    const int v = i % nv;
    const int p = i / nv;
    const int hh = h0 + p / s.RW, ww = w0 + p % s.RW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < s.H && ww >= 0 && ww < s.W)
      val = *reinterpret_cast<const uint4*>(xn + ((long long)hh * s.W + ww) * s.C + v * V);
    win[i] = val;
  }
  __syncthreads();

  const int lanes = DW_THREADS / nv;
  if (int(threadIdx.x) >= lanes * nv) return;
  const int cv = threadIdx.x % nv;
  const int lane = threadIdx.x / nv;
  const int c0 = (v0 + cv) * V;
  Vec16 wv[9], bv;
#pragma unroll
  for (int k = 0; k < 9; ++k) wv[k].u = *reinterpret_cast<const uint4*>(w + k * s.C + c0);
  if (b != nullptr) bv.u = *reinterpret_cast<const uint4*>(b + c0);

  for (int o = lane; o < s.TH * s.TW; o += lanes) {
    const int oh = o / s.TW, ow = o % s.TW;
    const int ho = ho0 + oh, wo = wo0 + ow;
    if (ho >= s.Ho || wo >= s.Wo) continue;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        Vec16 xv;
        xv.u = win[((oh * s.stride + dy) * s.RW + ow * s.stride + dx) * nv + cv];
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(Tr::get(xv, j), Tr::get(wv[dy * 3 + dx], j)));
      }
    }
    Vec16 yv;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = b != nullptr ? __fadd_rn(acc[j], Tr::get(bv, j)) : acc[j];
      y = fmaxf(y, 0.0f);
      if (s.relu6) y = fminf(y, 6.0f);
      Tr::put(yv, j, y);
    }
    *reinterpret_cast<uint4*>(out + (((long long)n * s.Ho + ho) * s.Wo + wo) * s.C + c0) = yv.u;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int N, int H, int W,
           int C, int stride, int relu6, void* stream) {
  constexpr int V = VecTraits<T>::V;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)w | (uintptr_t)b | (uintptr_t)out;
  if (C <= 0 || C % V || (stride != 1 && stride != 2)) return (int)cudaErrorInvalidValue;
  if (addr % 16) return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  DwShape s;
  s.N = N; s.H = H; s.W = W; s.C = C; s.stride = stride;
  s.Ho = (H + stride - 1) / stride;
  s.Wo = (W + stride - 1) / stride;
  s.pad_h = same_lo(H, stride);
  s.pad_w = same_lo(W, stride);
  s.TH = std::min(stride == 1 ? 8 : 4, s.Ho);
  s.TW = std::min(stride == 1 ? 16 : 8, s.Wo);
  s.RH = (s.TH - 1) * stride + 3;
  s.RW = (s.TW - 1) * stride + 3;
  s.slice = std::min(C / V, MAX_SLICE_VECS);
  s.tiles_h = (s.Ho + s.TH - 1) / s.TH;
  s.tiles_w = (s.Wo + s.TW - 1) / s.TW;
  s.relu6 = relu6 != 0;
  const long long blocks = (long long)N * s.tiles_h * s.tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)((C / V + s.slice - 1) / s.slice));
  const size_t smem = (size_t)s.RH * s.RW * s.slice * 16;  // <= 46,080 bytes
  depthwise_kernel<T><<<grid, DW_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int depthwise_f32(const void* x, const void* w, const void* b, void* out, int N, int H,
                  int W, int C, int stride, int relu6, void* stream) {
  return launch<float>(x, w, b, out, N, H, W, C, stride, relu6, stream);
}

int depthwise_bf16(const void* x, const void* w, const void* b, void* out, int N, int H,
                   int W, int C, int stride, int relu6, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, out, N, H, W, C, stride, relu6, stream);
}

}  // extern "C"
