// Fused int8 depthwise-separable block: dw 3x3 (TF-SAME, stride 1 or 2) +
// int32 bias + requant -> pointwise 1x1 s8 x s8 -> s32 + int32 bias +
// requant, int8 in and out, exact (equal, bit for bit, to quant/oracle.py).
//
// Replaces the TPU kernels mobilenet_tpu/quant/pallas_block_i8.py
// separable_block_i8 (:201) and the lane-packed
// quant/pallas_block_packed_i8.py separable_block_packed_i8 (:222, both
// strides): the packing existed only for the TPU's (8,128) vector tiles, so
// narrow blocks (C = 8..64) run this same dense NHWC kernel.
//
// What bounds it on an H100: memory, at all but the last block. At batch
// 256 (MobileNet-V1 1.0-224) a block's pointwise is 6.6 to 13.2 G int8
// multiply-adds (7 to 13 us at the tensor cores' 1,979 TOP/s), while its
// int8 input and output move 26 to 308 MB (8 to 92 us at 3.35 TB/s); only
// 7x7x1024 is bound by operations. The unfused pair would also write and
// read the depthwise tensor. The design keeps the depthwise result in shared memory
// and never in device memory: a block computes a tile of TM output pixels x
// TN output channels, and for each chunk of KC input channels
//   1. computes the depthwise of its TM pixels x KC channels with the tile
//      function of int8_tile.cuh (the standalone depthwise kernel runs the
//      same function), requantized to int8 in shared memory;
//   2. loads the KC x TN slice of the pointwise weight, transposed, into
//      shared memory;
//   3. accumulates the product on the tensor cores with mma.sync m16n8k32
//      s8 x s8 -> s32 (integer sums are exact in any order).
// The epilogue adds the int32 bias, requantizes in registers and stores int8
// pairs. The output-channel tiles of one pixel tile are neighbours in launch
// order, so they find its input in L2; the depthwise is recomputed once per
// 128-channel output tile. This is the simple first version: no load
// pipelining, one barrier pair per 32-channel chunk; cp.async/TMA, wgmma
// and a persistent schedule are later work.
//
// The linear mode (entry point separable_block_i8_linear) is the packed
// kernel's pw_linear=True: the pointwise requant is the V2 linear-bottleneck
// one, clamp(rint(float32(acc + bias) * m)), with no ReLU and no six_q
// (MobileNet-V2's t == 1 block 0). It is a second instantiation of the
// kernel template, not a runtime flag: the ReLU6 epilogue of the V1 blocks
// keeps no branch.
#include "int8_tile.cuh"

namespace {

constexpr int TM = 64;         // output pixels per tile
constexpr int TN = 128;        // output channels per tile
constexpr int KC = 32;         // input channels per chunk: one m16n8k32 step
constexpr int THREADS = 256;   // 8 warps: 2 (pixels) x 4 (channels), 32 x 32 each
constexpr int LDS = KC + 16;   // smem row stride in bytes: conflict-free fragment loads

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kLinear>
__global__ void __launch_bounds__(THREADS)
    separable_block_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ dw_w,
                              const int* __restrict__ dw_b, const float* __restrict__ dw_m,
                              const int8_t* __restrict__ pw_w, const int* __restrict__ pw_b,
                              const float* __restrict__ pw_m, int8_t* __restrict__ out,
                              mnk::I8Shape s, float dw_six_q, float pw_six_q) {
  __shared__ __align__(16) int8_t As[TM * LDS];   // depthwise tile, pixel-major
  __shared__ __align__(16) int8_t Bs[TN * LDS];   // weight slice, channel-major
  __shared__ mnk::PixelWindow wins[TM];

  const int tid = threadIdx.x;
  const int n_tiles = (s.Cout + TN - 1) / TN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * TM;
  const int n0 = int(blockIdx.x % n_tiles) * TN;

  if (tid < TM) {
    const long long p = m0 + tid;
    mnk::PixelWindow w{-1, 0, 0};
    if (p < s.M) w = mnk::pixel_window(s, p);
    wins[tid] = w;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;       // mma fragment coordinates
  const int wm = warp / 4, wn = warp % 4;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < s.C; k0 += KC) {
    __syncthreads();  // window table ready; previous chunk's tiles consumed
    // 1. depthwise of TM pixels x KC channels -> As (int8)
    {
      const int cq = (tid % (KC / 4)) * 4;
      const int c = k0 + cq;
      const bool live = c < s.C;
      mnk::DwQuad q;
      if (live) q = mnk::load_dw_quad(dw_w, dw_b, dw_m, s.C, c);
      for (int r = tid / (KC / 4); r < TM; r += THREADS / (KC / 4)) {
        uint32_t v = 0;
        if (live && wins[r].base >= 0) v = mnk::dw_quad(x, q, s, wins[r], c, dw_six_q);
        *reinterpret_cast<uint32_t*>(As + r * LDS + cq) = v;
      }
    }
    // 2. pointwise weight slice (KC x TN, row-major in memory) -> Bs[n][k]
    for (int idx = tid; idx < TN * (KC / 4); idx += THREADS) {
      const int n = idx % TN, kq = (idx / TN) * 4;
      const int co = n0 + n;
      int b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kq + j;
        b[j] = (k < s.C && co < s.Cout) ? int(pw_w[(long long)k * s.Cout + co]) : 0;
      }
      *reinterpret_cast<uint32_t*>(Bs + n * LDS + kq) = mnk::pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
    // 3. one k32 step of the warp's 32 x 32 product
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* row = As + (wm * 32 + i * 16 + g) * LDS + tig * 4;
      a[i][0] = lds32(row);
      a[i][1] = lds32(row + 8 * LDS);
      a[i][2] = lds32(row + 16);
      a[i][3] = lds32(row + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* col = Bs + (wn * 32 + j * 8 + g) * LDS + tig * 4;
      b[j][0] = lds32(col);
      b[j][1] = lds32(col + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }

  // epilogue: + int32 bias, requant (linear in the linear mode), int8 pairs.
  // Cout is a multiple of 8, so an 8-channel fragment column is all in range
  // or all out.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + wn * 32 + j * 8 + tig * 2;
    if (co >= s.Cout) continue;
    const int b0 = pw_b[co], b1 = pw_b[co + 1];
    const float mm0 = pw_m[co], mm1 = pw_m[co + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (p >= s.M) continue;
        int v0, v1;
        if constexpr (kLinear) {
          v0 = mnk::requant_linear_i8(acc[i][j][2 * h] + b0, mm0);
          v1 = mnk::requant_linear_i8(acc[i][j][2 * h + 1] + b1, mm1);
        } else {
          v0 = mnk::requant_i8(acc[i][j][2 * h] + b0, mm0, pw_six_q, s.relu6);
          v1 = mnk::requant_i8(acc[i][j][2 * h + 1] + b1, mm1, pw_six_q, s.relu6);
        }
        *reinterpret_cast<char2*>(out + p * s.Cout + co) = make_char2(char(v0), char(v1));
      }
    }
  }
}

template <bool kLinear>
int launch(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
           const void* pw_w, const void* pw_b, const void* pw_m, void* out, int N, int H,
           int W, int Cin, int Cout, int stride, int relu6, float dw_six_q, float pw_six_q,
           void* stream) {
  const mnk::I8Shape s = mnk::make_i8_shape(N, H, W, Cin, Cout, stride, relu6);
  const long long tiles = ((s.M + TM - 1) / TM) * ((Cout + TN - 1) / TN);
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  separable_block_i8_kernel<kLinear><<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)dw_w, (const int*)dw_b, (const float*)dw_m,
      (const int8_t*)pw_w, (const int*)pw_b, (const float*)pw_m, (int8_t*)out, s,
      dw_six_q, pw_six_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int separable_block_i8(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
                       const void* pw_w, const void* pw_b, const void* pw_m, void* out,
                       int N, int H, int W, int Cin, int Cout, int stride, int relu6,
                       float dw_six_q, float pw_six_q, void* stream) {
  return launch<false>(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, out, N, H, W, Cin, Cout,
                       stride, relu6, dw_six_q, pw_six_q, stream);
}

// The linear mode: pw_six_q is not read.
int separable_block_i8_linear(const void* x, const void* dw_w, const void* dw_b,
                              const void* dw_m, const void* pw_w, const void* pw_b,
                              const void* pw_m, void* out, int N, int H, int W, int Cin,
                              int Cout, int stride, int relu6, float dw_six_q, float pw_six_q,
                              void* stream) {
  return launch<true>(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, out, N, H, W, Cin, Cout,
                      stride, relu6, dw_six_q, pw_six_q, stream);
}

}  // extern "C"
