// Conversions and the activations shared by the kernels: f32 arithmetic on
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

// Named activations by code (ops/head.py ACTS): hswish = y * (clip(y + 3, 0,
// 6) * (1/6)), the constant multiplied, as the TPU kernels write it.
enum Act { kNone = -1, kLinear = 0, kRelu = 1, kRelu6 = 2, kHswish = 3 };

__device__ __forceinline__ float act_named(float y, int a) {
  switch (a) {
    case kRelu: return fmaxf(y, 0.0f);
    case kRelu6: return fminf(fmaxf(y, 0.0f), 6.0f);
    case kHswish: return y * (fminf(fmaxf(y + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f));
    default: return y;
  }
}

}  // namespace mnk
