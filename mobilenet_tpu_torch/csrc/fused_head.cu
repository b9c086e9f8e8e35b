// Fused classifier head for V1: global average pool -> fc, one launch.
//
// Replaces the pool+fc form of the TPU kernel mobilenet_tpu/ops/pallas_head.py
// fused_head (:168); its conv_last and multi-matmul forms (V2/V3) are not
// ported yet. Numerics follow pallas_head.py:67-78: the pool is an f32 mean
// over H*W cast to the activation dtype, the fc accumulates in f32, adds the
// bias in f32 and casts.
//
// What bounds it on an H100: at batch 256 the head reads 25.7 MB of bf16
// features and a 2 MB weight, and does 0.5 GFLOP: a memory- and
// latency-bound stretch. Unfused it is a pool kernel, a GEMM and an epilogue
// with a (N, 1024) tensor between them. Here each block pools HB images once
// into shared memory and computes every class for them on the CUDA cores,
// CPT classes per thread: weight reads are coalesced along classes and come
// from L2 (every block reads the whole weight), pooled values are broadcast
// from shared memory. At batch 256 that is 128 blocks; at batch 1, one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "numerics.cuh"

namespace {

using mnk::from_f;
using mnk::to_f;

constexpr int HB = 2;                           // images per block
constexpr int HEAD_THREADS = 512;
constexpr int CPT = 2;                          // classes per thread
constexpr int MAX_CLASSES = HEAD_THREADS * CPT;  // 1024
constexpr int MAX_C = 1024;                     // pooled row capacity

template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
    fused_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ out, int N, int HW,
                      int C, int classes) {
  __shared__ T pooled[HB * MAX_C];
  const int img0 = blockIdx.x * HB;
  const int nb = min(HB, N - img0);
  for (int idx = threadIdx.x; idx < HB * C; idx += HEAD_THREADS) {
    const int bi = idx / C, c = idx % C;
    float s = 0.0f;
    if (bi < nb) {
      const T* px = x + ((long long)(img0 + bi) * HW) * C + c;
#pragma unroll 7
      for (int p = 0; p < HW; ++p) s += to_f(px[(long long)p * C]);
    }
    pooled[bi * C + c] = from_f<T>(s / float(HW));
  }
  __syncthreads();
  float acc[CPT][HB];
#pragma unroll
  for (int q = 0; q < CPT; ++q)
#pragma unroll
    for (int bi = 0; bi < HB; ++bi) acc[q][bi] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < C; ++k) {
    float pv[HB];
#pragma unroll
    for (int bi = 0; bi < HB; ++bi) pv[bi] = to_f(pooled[bi * C + k]);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int j = threadIdx.x + q * HEAD_THREADS;
      if (j < classes) {
        const float wv = to_f(w[(long long)k * classes + j]);
#pragma unroll
        for (int bi = 0; bi < HB; ++bi) acc[q][bi] = fmaf(pv[bi], wv, acc[q][bi]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int j = threadIdx.x + q * HEAD_THREADS;
    if (j >= classes) continue;
    const float bias = to_f(b[j]);
    for (int bi = 0; bi < nb; ++bi)
      out[(long long)(img0 + bi) * classes + j] = from_f<T>(acc[q][bi] + bias);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int N, int HW,
           int C, int classes, void* stream) {
  if (C > MAX_C || classes > MAX_CLASSES) return (int)cudaErrorInvalidValue;
  if (N <= 0 || classes <= 0) return (int)cudaSuccess;
  fused_head_kernel<T><<<(N + HB - 1) / HB, HEAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, N, HW, C, classes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_head_bf16(const void* x, const void* w, const void* b, void* out, int N,
                    int HW, int C, int classes, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, out, N, HW, C, classes, stream);
}

int fused_head_f32(const void* x, const void* w, const void* b, void* out, int N,
                   int HW, int C, int classes, void* stream) {
  return launch<float>(x, w, b, out, N, HW, C, classes, stream);
}

}  // extern "C"
