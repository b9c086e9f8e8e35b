// The s8 tensor-core pieces of the int8 bottleneck kernels
// (inverted_residual_i8.cu, v3_block_i8.cu): the mma.sync m16n8k32
// s8.s8.s32 product, its fragment loads from shared memory (the layout of
// separable_block_i8.cu), the 4 x 8 transpose that stages a weight slice
// with K contiguous, and the int8 clamp.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mnk {

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

__device__ __forceinline__ uint2 ld8(const int8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The A fragment (16 rows x 32 int8) at `row` (this lane's first element)
// and the B fragment (32 x 8, stored n-major) at `col`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* row, int ld) {
  a[0] = lds32(row);
  a[1] = lds32(row + 8 * ld);
  a[2] = lds32(row + 16);
  a[3] = lds32(row + 8 * ld + 16);
}

__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* col) {
  b[0] = lds32(col);
  b[1] = lds32(col + 16);
}

// Rows r[0..3] of 8 int8 each -> 8 words at dst + t * ld (t = 0..7), word t
// holding byte t of the four rows (row 0 in the low byte): a 4 x 8 transpose
// of a weight slice, so that the staged slice has K contiguous.
__device__ __forceinline__ void store_transposed(int8_t* dst, int ld, const uint2 (&r)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t r0 = half ? r[0].y : r[0].x, r1 = half ? r[1].y : r[1].x;
    const uint32_t r2 = half ? r[2].y : r[2].x, r3 = half ? r[3].y : r[3].x;
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
    int8_t* d = dst + 4 * half * ld;
    *reinterpret_cast<uint32_t*>(d) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + ld) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(d + 2 * ld) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + 3 * ld) = __byte_perm(hi01, hi23, 0x7632);
  }
}

__device__ __forceinline__ int clamp_i8(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }

}  // namespace mnk
