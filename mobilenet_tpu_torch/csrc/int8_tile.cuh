// The int8 depthwise stage shared by the fused int8 block
// (separable_i8_wgmma.cuh, through separable_block_i8.cu) and the standalone
// int8 depthwise kernel (depthwise_ring.cuh, through depthwise_i8.cu), so
// that the per-layer route and the fused route compute the same integers in
// the same way.
//
// A pixel's 16 channels from its nine 16-byte tap vectors: the taps are
// transposed 4 x 4 in bytes (__byte_perm) so that one dp4a sums four taps of
// one channel (taps 0-3, 4-7, and tap 8 against a weight word that holds its
// byte in the channel's lane), starting from the int32 bias, exactly. The
// requant is quant/ops.py's: v = float32(acc) * m (__fmul_rn), clamped to
// [0, hi] (hi = min(six_q, 127) with ReLU6, else 127), rounded half to even;
// clamping to an integer bound before rounding equals clamping after. The
// conversions run on the full-rate adders: float32(acc) is float(0x4B400000
// + acc) - 1.5 * 2^23, exact while |acc| < 2^22, taken for a 16-channel
// group whose biases are all within 2^21 (nine taps add at most 9 * 128 *
// 128); a group with a larger bias converts with __int2float_rn. The
// clamped value is rounded by adding 1.5 * 2^23 (round to nearest even), and
// the low byte of the sum's bits is the int8 result. The library is built
// without --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mnk {

__host__ __device__ inline int same_pad_lo(int size, int stride, int out) {
  const int total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

constexpr int MAGIC_I = 0x4B400000;     // the bits of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.0f;  // 1.5 * 2^23
constexpr int SMALL_BIAS = 1 << 21;     // |bias| <= this: |acc| < 2^22 (magic conversion)

// Byte t of the four words a[0..3] -> word t (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140), lo23 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362), hi23 = __byte_perm(a[2], a[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// quant/ops.py's requant of float32(acc) = f: v = f * m, clamped to [lo, hi]
// (integer bounds: lo 0 or -128, hi min(six_q, 127) or 127) before the
// rounding; the low byte of the result is the int8 value.
__device__ __forceinline__ uint32_t requant_bits(float f, float m, float lo, float hi) {
  const float v = fminf(fmaxf(__fmul_rn(f, m), lo), hi);
  return __float_as_uint(__fadd_rn(v, MAGIC_F));
}

// float32 of a depthwise sum carried with 0x4B400000 added (the bias word):
// the magic-number conversion (kMagic: the true sum within 2^22), or
// __int2float_rn of the true sum.
template <bool kMagic>
__device__ __forceinline__ float dw_float(int acc) {
  if constexpr (kMagic)
    return __fsub_rn(__int_as_float(acc), MAGIC_F);
  else
    return __int2float_rn(int(uint32_t(acc) - uint32_t(MAGIC_I)));
}

// The depthwise weights of 4 channels: for channel e, t03[e] and t47[e] hold
// its taps 0-3 and 4-7 (tap 0 in the low byte), t8[e] its tap 8 in byte e;
// b[e] its bias + 0x4B400000, m[e] its multiplier.
struct DwQuad {
  uint32_t t03[4], t47[4], t8[4];
  int b[4];
  float m[4];
};

// A thread's 16 channels: quad i holds channels 4i..4i+3.
struct DwGroup {
  DwQuad q[4];
};

// The tap words of channels [ch, ch+4) of a (3, 3, 1, C) int8 weight (C a
// multiple of 4).
__device__ __forceinline__ void dw_tap_words(const int8_t* __restrict__ dw_w, int C, int ch,
                                             uint32_t (&t03)[4], uint32_t (&t47)[4],
                                             uint32_t (&t8)[4]) {
  uint32_t a[4], b[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t] = *reinterpret_cast<const uint32_t*>(dw_w + t * C + ch);
    b[t] = *reinterpret_cast<const uint32_t*>(dw_w + (4 + t) * C + ch);
  }
  transpose4(a, t03);
  transpose4(b, t47);
  const uint32_t w8 = *reinterpret_cast<const uint32_t*>(dw_w + 8 * C + ch);
  t8[0] = w8 & 0xffu;
  t8[1] = w8 & 0xff00u;
  t8[2] = w8 & 0xff0000u;
  t8[3] = w8 & 0xff000000u;
}

// Whether four biases allow the magic conversion.
__device__ __forceinline__ bool small_biases(const int4& b) {
  return b.x >= -SMALL_BIAS && b.x <= SMALL_BIAS && b.y >= -SMALL_BIAS && b.y <= SMALL_BIAS &&
         b.z >= -SMALL_BIAS && b.z <= SMALL_BIAS && b.w >= -SMALL_BIAS && b.w <= SMALL_BIAS;
}

// Channels [ch, ch + 4 * quads) of the weights, biases and multipliers into
// a group held in registers (quads 1, 2 or 4); the group's other quads hold
// zeros (their outputs are not stored). Returns whether every bias read
// allows the magic conversion.
__device__ __forceinline__ bool load_dw_group(const int8_t* __restrict__ dw_w,
                                              const int* __restrict__ dw_b,
                                              const float* __restrict__ dw_m, int C, int ch,
                                              int quads, DwGroup& d) {
  bool small = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    DwQuad& q = d.q[i];
    if (i < quads) {
      dw_tap_words(dw_w, C, ch + 4 * i, q.t03, q.t47, q.t8);
      const int4 b = *reinterpret_cast<const int4*>(dw_b + ch + 4 * i);
      const float4 m = *reinterpret_cast<const float4*>(dw_m + ch + 4 * i);
      small &= small_biases(b);
      q.b[0] = int(uint32_t(b.x) + uint32_t(MAGIC_I));
      q.b[1] = int(uint32_t(b.y) + uint32_t(MAGIC_I));
      q.b[2] = int(uint32_t(b.z) + uint32_t(MAGIC_I));
      q.b[3] = int(uint32_t(b.w) + uint32_t(MAGIC_I));
      q.m[0] = m.x; q.m[1] = m.y; q.m[2] = m.z; q.m[3] = m.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q.t03[e] = q.t47[e] = q.t8[e] = 0u;
        q.b[e] = MAGIC_I;
        q.m[e] = 0.0f;
      }
    }
  }
  return small;
}

// Channels 4i..4i+3 of a pixel from its nine tap vectors v (tap dy * 3 +
// dx; 16 channels each) and their weights q: dp4a over taps 0-3, 4-7 and 8
// from the bias, the requant to [0, hi]; one word, channel 4i in the low
// byte.
template <bool kMagic>
__device__ __forceinline__ uint32_t dw_quad(const uint4 (&v)[9], int i, const DwQuad& q,
                                            float hi) {
  uint32_t x03[4], x47[4], r[4];
  transpose4({word(v[0], i), word(v[1], i), word(v[2], i), word(v[3], i)}, x03);
  transpose4({word(v[4], i), word(v[5], i), word(v[6], i), word(v[7], i)}, x47);
  const int x8 = int(word(v[8], i));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int acc = __dp4a(int(x03[e]), int(q.t03[e]), q.b[e]);
    acc = __dp4a(int(x47[e]), int(q.t47[e]), acc);
    acc = __dp4a(x8, int(q.t8[e]), acc);
    r[e] = requant_bits(dw_float<kMagic>(acc), q.m[e], 0.0f, hi);
  }
  return low_bytes(r[0], r[1], r[2], r[3]);
}

// A pixel's 16 channels, the group's weights in registers.
template <bool kMagic>
__device__ __forceinline__ uint4 dw16(const uint4 (&v)[9], const DwGroup& d, float hi) {
  return make_uint4(dw_quad<kMagic>(v, 0, d.q[0], hi), dw_quad<kMagic>(v, 1, d.q[1], hi),
                    dw_quad<kMagic>(v, 2, d.q[2], hi), dw_quad<kMagic>(v, 3, d.q[3], hi));
}

}  // namespace mnk
