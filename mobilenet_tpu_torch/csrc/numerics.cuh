// Conversions and the activation shared by the kernels: f32 arithmetic on
// bf16 or f32 storage, rounding to nearest even on the way back (as JAX's
// astype does).
#pragma once

#include <cuda_bf16.h>

namespace mnk {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float act(float y, bool relu6) {
  y = fmaxf(y, 0.0f);
  return relu6 ? fminf(y, 6.0f) : y;
}

}  // namespace mnk
