// cpu_ref: native C++ float32 + int8 golden reference for every layer.
//
// Reference analog: C8 "Golden CPU reference model" (SURVEY.md SS2) — the
// reference's pure-C host implementation whose per-layer float outputs the
// accelerated path must match (BASELINE.json:5). This library keeps that role
// native, mirroring the reference's C host code, with a ctypes binding
// (pybind11 is not available in this image).
//
// Accumulation contract (shared with oracle/numpy_ref.py, which is the NumPy
// twin): float32 accumulators, taps in (dy, dx, cin) order, no FMA contraction
// (built with -ffp-contract=off), so the two oracles agree BIT-FOR-BIT.
//
// Layout: NHWC activations, HWIO weights — identical to the JAX pipeline.
// Padding: TF/XLA 'SAME' (stride 1 -> (1,1); stride 2, even input -> (0,1)).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

static inline float act(float v, int relu6) {
  v = v > 0.0f ? v : 0.0f;
  if (relu6 && v > 6.0f) v = 6.0f;
  return v;
}

// Named activations for the V3 family (keras mobilenet_v3.py:542-553),
// same formula order as the NumPy twin (oracle/numpy_ref.act_named_ref):
// 0 = linear, 1 = relu, 2 = relu6, 3 = hswish, 4 = hsigmoid.
static inline float act_named(float v, int kind) {
  if (kind == 0) return v;
  if (kind == 1) return v > 0.0f ? v : 0.0f;
  if (kind == 2) { v = v > 0.0f ? v : 0.0f; return v > 6.0f ? 6.0f : v; }
  float g = v + 3.0f;
  g = g > 0.0f ? g : 0.0f;
  if (g > 6.0f) g = 6.0f;
  g = g * (1.0f / 6.0f);
  return kind == 3 ? v * g : g;  // 3 = hswish, 4 = hsigmoid
}

static inline void same_pad(int in, int stride, int k, int* lo) {
  int out = (in + stride - 1) / stride;
  int total = (out - 1) * stride + k - in;
  if (total < 0) total = 0;
  *lo = total / 2;
}

// Standard 3x3 conv. x: (N,H,W,Cin), w: (3,3,Cin,Cout), bias: (Cout) or null.
void conv3x3_f32(const float* x, const float* w, const float* bias,
                 float* out, int n, int h, int wdim, int cin, int cout,
                 int stride, int relu6, int apply_act) {
  int pad_lo;
  same_pad(h, stride, 3, &pad_lo);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  for (int b = 0; b < n; ++b)
    for (int oy = 0; oy < h_out; ++oy)
      for (int ox = 0; ox < w_out; ++ox) {
        float* o = out + (((int64_t)b * h_out + oy) * w_out + ox) * cout;
        for (int oc = 0; oc < cout; ++oc) o[oc] = 0.0f;
        for (int dy = 0; dy < 3; ++dy) {
          const int iy = oy * stride + dy - pad_lo;
          if (iy < 0 || iy >= h) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ix = ox * stride + dx - pad_lo;
            if (ix < 0 || ix >= wdim) continue;
            const float* px = x + (((int64_t)b * h + iy) * wdim + ix) * cin;
            const float* pw = w + ((int64_t)dy * 3 + dx) * cin * cout;
            for (int ic = 0; ic < cin; ++ic) {
              const float xv = px[ic];
              const float* wrow = pw + (int64_t)ic * cout;
              for (int oc = 0; oc < cout; ++oc) o[oc] += xv * wrow[oc];
            }
          }
        }
        if (bias) for (int oc = 0; oc < cout; ++oc) o[oc] += bias[oc];
        if (apply_act) for (int oc = 0; oc < cout; ++oc) o[oc] = act(o[oc], relu6);
      }
}

// Depthwise 3x3. x: (N,H,W,C), w: (3,3,1,C) flattened as (9, C).
void dw3x3_f32(const float* x, const float* w, const float* bias, float* out,
               int n, int h, int wdim, int c, int stride, int relu6,
               int apply_act) {
  int pad_lo;
  same_pad(h, stride, 3, &pad_lo);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  for (int b = 0; b < n; ++b)
    for (int oy = 0; oy < h_out; ++oy)
      for (int ox = 0; ox < w_out; ++ox) {
        float* o = out + (((int64_t)b * h_out + oy) * w_out + ox) * c;
        for (int ch = 0; ch < c; ++ch) o[ch] = 0.0f;
        for (int dy = 0; dy < 3; ++dy) {
          const int iy = oy * stride + dy - pad_lo;
          if (iy < 0 || iy >= h) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ix = ox * stride + dx - pad_lo;
            if (ix < 0 || ix >= wdim) continue;
            const float* px = x + (((int64_t)b * h + iy) * wdim + ix) * c;
            const float* pw = w + ((int64_t)dy * 3 + dx) * c;
            for (int ch = 0; ch < c; ++ch) o[ch] += px[ch] * pw[ch];
          }
        }
        if (bias) for (int ch = 0; ch < c; ++ch) o[ch] += bias[ch];
        if (apply_act) for (int ch = 0; ch < c; ++ch) o[ch] = act(o[ch], relu6);
      }
}

// Pointwise 1x1: per-pixel (Cin) x (Cin,Cout) matvec, cin-major accumulation.
void pw_f32(const float* x, const float* w, const float* bias, float* out,
            int64_t pixels, int cin, int cout, int relu6, int apply_act) {
  for (int64_t p = 0; p < pixels; ++p) {
    const float* px = x + p * cin;
    float* o = out + p * cout;
    for (int oc = 0; oc < cout; ++oc) o[oc] = 0.0f;
    for (int ic = 0; ic < cin; ++ic) {
      const float xv = px[ic];
      const float* wrow = w + (int64_t)ic * cout;
      for (int oc = 0; oc < cout; ++oc) o[oc] += xv * wrow[oc];
    }
    if (bias) for (int oc = 0; oc < cout; ++oc) o[oc] += bias[oc];
    if (apply_act) for (int oc = 0; oc < cout; ++oc) o[oc] = act(o[oc], relu6);
  }
}

// Depthwise kxk with a NAMED activation (V3: k in {3,5}, relu/hswish).
// x: (N,H,W,C), w: (k,k,1,C) flattened as (k*k, C).
void dwka_f32(const float* x, const float* w, const float* bias, float* out,
              int n, int h, int wdim, int c, int k, int stride,
              int act_kind) {
  int pad_lo;
  same_pad(h, stride, k, &pad_lo);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  for (int b = 0; b < n; ++b)
    for (int oy = 0; oy < h_out; ++oy)
      for (int ox = 0; ox < w_out; ++ox) {
        float* o = out + (((int64_t)b * h_out + oy) * w_out + ox) * c;
        for (int ch = 0; ch < c; ++ch) o[ch] = 0.0f;
        for (int dy = 0; dy < k; ++dy) {
          const int iy = oy * stride + dy - pad_lo;
          if (iy < 0 || iy >= h) continue;
          for (int dx = 0; dx < k; ++dx) {
            const int ix = ox * stride + dx - pad_lo;
            if (ix < 0 || ix >= wdim) continue;
            const float* px = x + (((int64_t)b * h + iy) * wdim + ix) * c;
            const float* pw = w + ((int64_t)dy * k + dx) * c;
            for (int ch = 0; ch < c; ++ch) o[ch] += px[ch] * pw[ch];
          }
        }
        if (bias) for (int ch = 0; ch < c; ++ch) o[ch] += bias[ch];
        for (int ch = 0; ch < c; ++ch) o[ch] = act_named(o[ch], act_kind);
      }
}

// Pointwise 1x1 with a NAMED activation (V3 expand/project/head matmuls).
void pwa_f32(const float* x, const float* w, const float* bias, float* out,
             int64_t pixels, int cin, int cout, int act_kind) {
  for (int64_t p = 0; p < pixels; ++p) {
    const float* px = x + p * cin;
    float* o = out + p * cout;
    for (int oc = 0; oc < cout; ++oc) o[oc] = 0.0f;
    for (int ic = 0; ic < cin; ++ic) {
      const float xv = px[ic];
      const float* wrow = w + (int64_t)ic * cout;
      for (int oc = 0; oc < cout; ++oc) o[oc] += xv * wrow[oc];
    }
    if (bias) for (int oc = 0; oc < cout; ++oc) o[oc] += bias[oc];
    for (int oc = 0; oc < cout; ++oc) o[oc] = act_named(o[oc], act_kind);
  }
}

// Standard 3x3 conv with a NAMED activation (V3 stem: hswish).
void conv3x3a_f32(const float* x, const float* w, const float* bias,
                  float* out, int n, int h, int wdim, int cin, int cout,
                  int stride, int act_kind) {
  conv3x3_f32(x, w, bias, out, n, h, wdim, cin, cout, stride, 0, 0);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  const int64_t total = (int64_t)n * h_out * w_out * cout;
  for (int64_t i = 0; i < total; ++i) out[i] = act_named(out[i], act_kind);
}

// Global average pool: (N,H,W,C) -> (N,C); row-major spatial accumulation.
void avgpool_f32(const float* x, float* out, int n, int h, int w, int c) {
  const float inv = 1.0f / (float)(h * w);
  for (int b = 0; b < n; ++b) {
    float* o = out + (int64_t)b * c;
    for (int ch = 0; ch < c; ++ch) o[ch] = 0.0f;
    for (int i = 0; i < h * w; ++i) {
      const float* px = x + ((int64_t)b * h * w + i) * c;
      for (int ch = 0; ch < c; ++ch) o[ch] += px[ch];
    }
    for (int ch = 0; ch < c; ++ch) o[ch] *= inv;
  }
}

// FC: (N,C) @ (C,classes) + bias.
void fc_f32(const float* x, const float* w, const float* bias, float* out,
            int n, int c, int classes) {
  for (int b = 0; b < n; ++b) {
    const float* px = x + (int64_t)b * c;
    float* o = out + (int64_t)b * classes;
    for (int k = 0; k < classes; ++k) o[k] = 0.0f;
    for (int ic = 0; ic < c; ++ic) {
      const float xv = px[ic];
      const float* wrow = w + (int64_t)ic * classes;
      for (int k = 0; k < classes; ++k) o[k] += xv * wrow[k];
    }
    if (bias) for (int k = 0; k < classes; ++k) o[k] += bias[k];
  }
}

// ---------------------------------------------------------------------------
// INT8 fixed-point twins (SURVEY.md SS2 C7): int8 inputs/weights, int32
// accumulation, per-layer requantization out_int8 = clamp(rint(acc * m) + zp).
// Rounding: round-half-to-even via nearbyintf (FE_TONEAREST default), matching
// jnp.round / np.rint in the device path.
// ---------------------------------------------------------------------------

static inline int8_t requant(int32_t acc, float m, int relu6, float s_out,
                             int apply_act) {
  float v = (float)acc * m;  // back to int8 domain of the output scale
  if (apply_act) {
    if (v < 0.0f) v = 0.0f;
    if (relu6) {
      const float six_q = 6.0f / s_out;  // 6.0 expressed in output quant units
      if (v > six_q) v = six_q;
    }
  }
  float r = nearbyintf(v);
  if (r > 127.0f) r = 127.0f;
  if (r < -128.0f) r = -128.0f;
  return (int8_t)r;
}

// Depthwise 3x3 int8: per-channel weight scale folded into m[ch].
// m[ch] = s_in * s_w[ch] / s_out; bias_i32 is the BN bias in acc units.
void dw3x3_i8(const int8_t* x, const int8_t* w, const int32_t* bias,
              const float* m, float s_out, int8_t* out, int n, int h,
              int wdim, int c, int stride, int relu6) {
  int pad_lo;
  same_pad(h, stride, 3, &pad_lo);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  for (int b = 0; b < n; ++b)
    for (int oy = 0; oy < h_out; ++oy)
      for (int ox = 0; ox < w_out; ++ox) {
        int8_t* o = out + (((int64_t)b * h_out + oy) * w_out + ox) * c;
        for (int ch = 0; ch < c; ++ch) {
          int32_t acc = bias ? bias[ch] : 0;
          for (int dy = 0; dy < 3; ++dy) {
            const int iy = oy * stride + dy - pad_lo;
            if (iy < 0 || iy >= h) continue;
            for (int dx = 0; dx < 3; ++dx) {
              const int ix = ox * stride + dx - pad_lo;
              if (ix < 0 || ix >= wdim) continue;
              const int8_t xv = x[(((int64_t)b * h + iy) * wdim + ix) * c + ch];
              const int8_t wv = w[((int64_t)dy * 3 + dx) * c + ch];
              acc += (int32_t)xv * (int32_t)wv;
            }
          }
          o[ch] = requant(acc, m[ch], relu6, s_out, 1);
        }
      }
}

// Pointwise int8: int32 accumulate over cin, per-out-channel requant.
void pw_i8(const int8_t* x, const int8_t* w, const int32_t* bias,
           const float* m, float s_out, int8_t* out, int64_t pixels, int cin,
           int cout, int relu6) {
  for (int64_t p = 0; p < pixels; ++p) {
    const int8_t* px = x + p * cin;
    int8_t* o = out + p * cout;
    for (int oc = 0; oc < cout; ++oc) {
      int32_t acc = bias ? bias[oc] : 0;
      for (int ic = 0; ic < cin; ++ic)
        acc += (int32_t)px[ic] * (int32_t)w[(int64_t)ic * cout + oc];
      o[oc] = requant(acc, m[oc], relu6, s_out, 1);
    }
  }
}

// Standard 3x3 conv int8 (stem layer).
void conv3x3_i8(const int8_t* x, const int8_t* w, const int32_t* bias,
                const float* m, float s_out, int8_t* out, int n, int h,
                int wdim, int cin, int cout, int stride, int relu6) {
  int pad_lo;
  same_pad(h, stride, 3, &pad_lo);
  const int h_out = (h + stride - 1) / stride;
  const int w_out = (wdim + stride - 1) / stride;
  for (int b = 0; b < n; ++b)
    for (int oy = 0; oy < h_out; ++oy)
      for (int ox = 0; ox < w_out; ++ox) {
        int8_t* o = out + (((int64_t)b * h_out + oy) * w_out + ox) * cout;
        for (int oc = 0; oc < cout; ++oc) {
          int32_t acc = bias ? bias[oc] : 0;
          for (int dy = 0; dy < 3; ++dy) {
            const int iy = oy * stride + dy - pad_lo;
            if (iy < 0 || iy >= h) continue;
            for (int dx = 0; dx < 3; ++dx) {
              const int ix = ox * stride + dx - pad_lo;
              if (ix < 0 || ix >= wdim) continue;
              const int8_t* px = x + (((int64_t)b * h + iy) * wdim + ix) * cin;
              const int8_t* pw = w + (((int64_t)dy * 3 + dx) * cin) * cout;
              for (int ic = 0; ic < cin; ++ic)
                acc += (int32_t)px[ic] * (int32_t)pw[(int64_t)ic * cout + oc];
            }
          }
          o[oc] = requant(acc, m[oc], relu6, s_out, 1);
        }
      }
}

}  // extern "C"
