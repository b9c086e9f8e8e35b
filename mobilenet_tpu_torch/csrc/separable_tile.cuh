// One output tile of a fused depthwise-separable block, shared by the
// per-block kernel (separable_block.cu) and the chain kernel (chain.cu), so
// that a chain stage computes bit for bit what one per-block launch does.
//
// A tile is TM consecutive output pixels (flattened n, ho, wo) by TN output
// channels. For each chunk of KC input channels the block
//   1. computes the depthwise 3x3 result of its TM pixels x KC channels into
//      shared memory (f32 sum over taps in dy-then-dx order, + dw bias in
//      f32, activation, cast to the weight dtype): the depthwise tensor never
//      reaches device memory;
//   2. loads the KC x TN slice of the pointwise weight into shared memory;
//   3. accumulates the product in f32: bf16 on the tensor cores through WMMA
//      (mma.sync) 16x16x16 fragments, float32 on the CUDA cores by FMA, so
//      the float32 instantiation stays exact float32.
// The epilogue adds the pointwise bias in f32, applies the activation (none
// in the linear-projection instantiation kPwAct = false, MobileNet-V2's
// t == 1 block 0) and casts to the activation dtype. TF-SAME padding: stride 1 pads one pixel on
// each side; stride 2 (even input) pads only at the high end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "numerics.cuh"

namespace mnk {

constexpr int TM = 64;        // output pixels per tile
constexpr int TN = 128;       // output channels per tile
constexpr int KC = 32;        // input channels per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int LDC = TN + 4;   // f32 result tile row stride (floats)

template <typename T> struct TileLayout {
  static constexpr int LDA = KC + 8;   // A: TM x KC, row major
  static constexpr int LDB = TN + 8;   // B: KC x TN, row major
  static constexpr int A_BYTES = TM * LDA * int(sizeof(T));
  static constexpr int B_BYTES = KC * LDB * int(sizeof(T));
  static constexpr int AB_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_BYTES = TM * LDC * 4;
  // The f32 result tile reuses the A/B space after the last chunk.
  static constexpr int WORK_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static constexpr int PIX_BYTES = 3 * TM * 4;
  static constexpr int SMEM_BYTES = WORK_BYTES + PIX_BYTES;
};

// Largest shared-memory footprint of either instantiation: kernels declare
// one static buffer of this size (below the 48 KB static limit).
constexpr int TILE_SMEM_BYTES =
    TileLayout<float>::SMEM_BYTES > TileLayout<__nv_bfloat16>::SMEM_BYTES
        ? TileLayout<float>::SMEM_BYTES
        : TileLayout<__nv_bfloat16>::SMEM_BYTES;
static_assert(TILE_SMEM_BYTES <= 48 * 1024, "tile exceeds static smem");

struct BlockShape {
  int N, H, W, Cin, Cout, stride, Ho, Wo;
  long long M;  // N * Ho * Wo output pixels
  bool relu6;
};

__host__ __device__ inline BlockShape make_shape(int N, int H, int W, int Cin,
                                                 int Cout, int stride, int relu6) {
  BlockShape s;
  s.N = N; s.H = H; s.W = W; s.Cin = Cin; s.Cout = Cout; s.stride = stride;
  s.Ho = (H + stride - 1) / stride;
  s.Wo = (W + stride - 1) / stride;
  s.M = (long long)N * s.Ho * s.Wo;
  s.relu6 = relu6 != 0;
  return s;
}

__host__ __device__ inline long long num_tiles(const BlockShape& s) {
  return ((s.M + TM - 1) / TM) * ((s.Cout + TN - 1) / TN);
}

// Input loads. A chain stage reads what other blocks wrote before the last
// grid barrier of the same launch, so it loads through L2 (ld.global.cg),
// never through the non-coherent L1/texture path that `const __restrict__`
// permits.
template <bool kCoherent, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return *p;
}

// Computes tile `tile` = m_tile * n_tiles + n_tile of out = block(x). The
// output-channel tiles of one pixel tile are neighbours in launch order, so
// they find the pixel tile's input in L2; the pointwise weight (at most
// 1024 x 1024) stays in L2 throughout.
template <typename T, bool kCoherent, bool kPwAct = true>
__device__ void separable_tile(const T* __restrict__ x, const T* __restrict__ dw_w,
                               const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                               const T* __restrict__ pw_b, T* __restrict__ out,
                               const BlockShape& s, long long tile,
                               unsigned char* smem) {
  using L = TileLayout<T>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  int* pix_base = reinterpret_cast<int*>(smem + L::WORK_BYTES);  // n*H*W
  int* pix_h0 = pix_base + TM;
  int* pix_w0 = pix_h0 + TM;

  const int tid = threadIdx.x;
  const int n_tiles = (s.Cout + TN - 1) / TN;
  const long long m0 = (tile / n_tiles) * TM;
  const int n0 = int(tile % n_tiles) * TN;
  const int pad = s.stride == 1 ? 1 : 0;

  if (tid < TM) {
    long long p = m0 + tid;
    if (p < s.M) {
      int hw = s.Ho * s.Wo;
      int n = int(p / hw);
      int r = int(p % hw);
      pix_base[tid] = n * s.H * s.W;
      pix_h0[tid] = (r / s.Wo) * s.stride - pad;
      pix_w0[tid] = (r % s.Wo) * s.stride - pad;
    } else {
      pix_base[tid] = -1;
      pix_h0[tid] = 0;
      pix_w0[tid] = 0;
    }
  }

  // fma-path accumulators: rows ty + 16*i, cols tx + 16*j
  float acc[4][8];
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[2][2];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(cf[i][j], 0.0f);
  }

  for (int k0 = 0; k0 < s.Cin; k0 += KC) {
    __syncthreads();  // pixel table ready; previous chunk's A/B consumed
    // 1. depthwise of TM pixels x KC channels -> As (weight dtype)
    {
      const int c = tid % KC;
      const int kc = k0 + c;
      float wt[9];
      float bias = 0.0f;
      if (kc < s.Cin) {
#pragma unroll
        for (int t = 0; t < 9; ++t) wt[t] = to_f(dw_w[t * s.Cin + kc]);
        bias = to_f(dw_b[kc]);
      }
      for (int r = tid / KC; r < TM; r += THREADS / KC) {
        float v = 0.0f;
        const int base = pix_base[r];
        if (kc < s.Cin && base >= 0) {
          float a = 0.0f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int hi = pix_h0[r] + dy;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int wi = pix_w0[r] + dx;
              float xv = 0.0f;
              if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
                xv = to_f(load_x<kCoherent>(x + ((long long)base + hi * s.W + wi) * s.Cin + kc));
              a = a + xv * wt[dy * 3 + dx];
            }
          }
          v = act(a + bias, s.relu6);
        }
        As[r * L::LDA + c] = from_f<T>(v);
      }
    }
    // 2. pointwise weight slice KC x TN -> Bs
    for (int idx = tid; idx < KC * TN; idx += THREADS) {
      const int kr = idx / TN, cc = idx % TN;
      const int k = k0 + kr, co = n0 + cc;
      Bs[kr * L::LDB + cc] =
          (k < s.Cin && co < s.Cout) ? pw_w[(long long)k * s.Cout + co] : from_f<T>(0.0f);
    }
    __syncthreads();
    // 3. product
    if constexpr (std::is_same<T, float>::value) {
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * L::LDA + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[k * L::LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    } else {
      using namespace nvcuda;
      const int warp = tid / 32, wm = warp / 4, wn = warp % 4;  // 2 x 4 warps
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * L::LDA + kk, L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * L::LDB + wn * 32 + j * 16, L::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
      }
    }
  }
  __syncthreads();  // all products done before Cs overwrites A/B
  if constexpr (std::is_same<T, float>::value) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  } else {
    using namespace nvcuda;
    const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                cf[i][j], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  // epilogue: + pw bias (f32), activation, cast; coalesced along channels
  for (int idx = tid; idx < TM * TN; idx += THREADS) {
    const int r = idx / TN, cc = idx % TN;
    const long long p = m0 + r;
    const int co = n0 + cc;
    if (p < s.M && co < s.Cout) {
      float v = Cs[r * LDC + cc] + to_f(pw_b[co]);
      if constexpr (kPwAct) v = act(v, s.relu6);
      out[p * s.Cout + co] = from_f<T>(v);
    }
  }
  __syncthreads();  // Cs and the pixel table are reused by the next tile
}

}  // namespace mnk
