// Pieces shared by the float inverted-residual kernels (inverted_residual.cu,
// v3_block.cu): 16-byte vector moves and the chunk's expansion product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace mnk {

// Loads and stores of 16 bytes (kVec<T> elements of T): every channel count
// is a multiple of 8 and every tensor 16-byte aligned (the wrappers check
// both), so a row of channels moves as whole vectors, and a thread's loads of
// one loop are few and independent instead of a chain of dependent L2 trips.
template <typename T> constexpr int kVec = 16 / int(sizeof(T));

template <typename T> union Vec16 {
  uint4 u;
  T t[kVec<T>];
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// Zf (Pp x KE, f32, row stride LDZ) = Xs (Pp x CinP, row stride s.ldx) @
// Es (CinP x KE, row stride LDE), by THREADS threads; Pp and CinP are
// multiples of 16. bf16: WMMA 16x16x16 on the tensor cores, one 16x16 tile a
// warp at a time; float32: FMA on the CUDA cores (exact float32), a thread
// owning one column and the rows p, p + THREADS / KE.
template <typename T, int THREADS, int KE, int LDZ, int LDE, typename Shape>
__device__ __forceinline__ void expand_product(const T* Xs, const T* Es, float* Zf,
                                               const Shape& s) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    const int k = tid % KE;
    for (int p = tid / KE; p < s.Pp; p += 2 * (THREADS / KE)) {
      const float* x0 = Xs + p * s.ldx;
      const float* x1 = x0 + (THREADS / KE) * s.ldx;  // row p + 8 (Pp % 16 == 0)
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < s.CinP; ++c) {
        const float w = Es[c * LDE + k];
        a0 = fmaf(x0[c], w, a0);
        a1 = fmaf(x1[c], w, a1);
      }
      Zf[p * LDZ + k] = a0;
      Zf[(p + THREADS / KE) * LDZ + k] = a1;
    }
  } else {
    using namespace nvcuda;
    const int warp = tid / 32;
    const int frags = (s.Pp / 16) * (KE / 16);
    for (int f = warp; f < frags; f += THREADS / 32) {
      const int mi = f / (KE / 16), ni = f % (KE / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      wmma::fill_fragment(cf, 0.0f);
      for (int kk = 0; kk < s.CinP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(af, Xs + mi * 16 * s.ldx + kk, s.ldx);
        wmma::load_matrix_sync(bf, Es + kk * LDE + ni * 16, LDE);
        wmma::mma_sync(cf, af, bf, cf);
      }
      wmma::store_matrix_sync(Zf + mi * 16 * LDZ + ni * 16, cf, LDZ, wmma::mem_row_major);
    }
  }
}

}  // namespace mnk
