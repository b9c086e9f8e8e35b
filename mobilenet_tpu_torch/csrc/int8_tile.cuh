// The int8 depthwise stage shared by the standalone depthwise kernel
// (depthwise_i8.cu) and the fused int8 block (separable_block_i8.cu), so that
// the per-layer route and the fused route compute the same integers.
//
// One call computes 4 consecutive channels of one output pixel: the 9-tap
// 3x3 TF-SAME sum in exact int32 arithmetic (dy-then-dx order), + the int32
// bias, then the requant of quant/ops.py:
//   v = float32(acc) * m; v = max(v, 0); v = min(v, six_q) when relu6;
//   round half to even (rintf); clamp to [-128, 127].
// The multiply is __fmul_rn, so no multiply-add contraction can change it,
// and the library is built without --use_fast_math.
//
// Alignment: the wrappers require every tensor to start on a 16-byte
// boundary and every channel count to be a multiple of 8, so 4-channel
// groups load and store as one 32-bit word and bias/multiplier groups as
// one 16-byte vector.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mnk {

struct I8Shape {
  int N, H, W, C;    // input; C = the depthwise channels (Cin of a block)
  int Cout;          // pointwise output channels (the fused block only)
  int stride, Ho, Wo, pad_h, pad_w;
  long long M;       // N * Ho * Wo output pixels
  bool relu6;
};

__host__ __device__ inline int same_pad_lo(int size, int stride, int out) {
  const int total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

__host__ __device__ inline I8Shape make_i8_shape(int N, int H, int W, int C, int Cout,
                                                 int stride, int relu6) {
  I8Shape s;
  s.N = N; s.H = H; s.W = W; s.C = C; s.Cout = Cout; s.stride = stride;
  s.Ho = (H + stride - 1) / stride;
  s.Wo = (W + stride - 1) / stride;
  s.pad_h = same_pad_lo(H, stride, s.Ho);
  s.pad_w = same_pad_lo(W, stride, s.Wo);
  s.M = (long long)N * s.Ho * s.Wo;
  s.relu6 = relu6 != 0;
  return s;
}

// Where output pixel p reads its window: the image's first input pixel and
// the window's top-left corner (may be negative: padding).
struct PixelWindow {
  int base, h0, w0;
};

__device__ __forceinline__ PixelWindow pixel_window(const I8Shape& s, long long p) {
  const int hw = s.Ho * s.Wo;
  const int n = int(p / hw), r = int(p % hw);
  PixelWindow win;
  win.base = n * s.H * s.W;
  win.h0 = (r / s.Wo) * s.stride - s.pad_h;
  win.w0 = (r % s.Wo) * s.stride - s.pad_w;
  return win;
}

__device__ __forceinline__ int requant_i8(int acc, float m, float six_q, bool relu6) {
  float v = __fmul_rn(__int2float_rn(acc), m);
  v = fmaxf(v, 0.0f);
  if (relu6) v = fminf(v, six_q);
  v = rintf(v);
  return int(fminf(fmaxf(v, -128.0f), 127.0f));
}

// The linear requant of MobileNet-V2's projections (quant/v2.py): the same
// multiply and rounding with no ReLU: clamp(rint(float32(acc) * m)).
__device__ __forceinline__ int requant_linear_i8(int acc, float m) {
  const float v = rintf(__fmul_rn(__int2float_rn(acc), m));
  return int(fminf(fmaxf(v, -128.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8) |
         ((uint32_t(c) & 0xffu) << 16) | ((uint32_t(d) & 0xffu) << 24);
}

// The depthwise weights, bias and multipliers of channels [c, c+4).
struct DwQuad {
  char4 w[9];
  int4 b;
  float4 m;
};

__device__ __forceinline__ DwQuad load_dw_quad(const int8_t* __restrict__ dw_w,
                                               const int* __restrict__ dw_b,
                                               const float* __restrict__ dw_m, int C,
                                               int c) {
  DwQuad q;
#pragma unroll
  for (int t = 0; t < 9; ++t) q.w[t] = *reinterpret_cast<const char4*>(dw_w + t * C + c);
  q.b = *reinterpret_cast<const int4*>(dw_b + c);
  q.m = *reinterpret_cast<const float4*>(dw_m + c);
  return q;
}

// Channels [c, c+4) of the depthwise output at the window `win`, requantized
// and packed into one little-endian 32-bit word (channel c in the low byte).
__device__ __forceinline__ uint32_t dw_quad(const int8_t* __restrict__ x, const DwQuad& q,
                                            const I8Shape& s, const PixelWindow& win,
                                            int c, float six_q) {
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hi = win.h0 + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int wi = win.w0 + dx;
      if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W) {
        const char4 v = *reinterpret_cast<const char4*>(
            x + ((long long)win.base + hi * s.W + wi) * s.C + c);
        const char4 w = q.w[dy * 3 + dx];
        a0 += int(v.x) * int(w.x);
        a1 += int(v.y) * int(w.y);
        a2 += int(v.z) * int(w.z);
        a3 += int(v.w) * int(w.w);
      }
    }
  }
  return pack4(requant_i8(a0 + q.b.x, q.m.x, six_q, s.relu6),
               requant_i8(a1 + q.b.y, q.m.y, six_q, s.relu6),
               requant_i8(a2 + q.b.z, q.m.z, six_q, s.relu6),
               requant_i8(a3 + q.b.w, q.m.w, six_q, s.relu6));
}

}  // namespace mnk
