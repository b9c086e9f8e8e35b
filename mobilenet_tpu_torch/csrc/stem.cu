// The MobileNet stem kernels, NHWC, float32 or bf16 storage, float32 sums.
//
// stem_block0: uint8 normalize + the 3x3 s2 stem conv (+bias+act) + block
// 0's depthwise 3x3 s1 (+bias+act) and pointwise 1x1 (+bias+act), in one
// launch. Replaces the TPU kernel mobilenet_tpu/ops/pallas_stem_b0.py
// stem_block0_fused (:124), the route of InferencePipeline(fuse_stem=True).
// stem_conv: the stem conv (+bias+act) alone on a preprocessed float input,
// the stem of every forward whose block 0 is routed "fused". Replaces
// mobilenet_tpu/ops/pallas_stem.py stem_conv_packed (:146), and also takes
// odd sizes: TF-SAME pads (0, 1) on an even axis and (1, 1) on an odd one.
// Both share one device function for a stem output pixel (stem_pixel).
//
// Arithmetic, in the TPU kernels' order:
//   1. (stem_block0) x = u8 * scale + offset in float32 (a multiply, then an
//      add), rounded to the weights' dtype; the stem's TF-SAME pad (0, 1)
//      is 0 in the normalized domain (not normalize(0) = -1);
//   2. the stem: 27 taps in (dy, dx, c) order, each a float32 multiply then
//      add (__fmul_rn, __fadd_rn: never contracted into an FMA), + bias in
//      float32, ReLU or ReLU6, rounded to the dtype;
//   3. (stem_block0) the depthwise 3x3 s1 on the rounded stem activations,
//      with a zero SAME pad in that domain, taps in (dy, dx) order, the same
//      multiply-then-add, + bias, activation, rounded to the dtype;
//   4. (stem_block0) the pointwise 32 -> Cout: float32 sums over k in
//      order (fmaf), + bias, activation, rounded to the dtype.
// Steps 1-3 are those of the plain versions (ops/stem.py) operation for
// operation, so the kernels differ from them only by the pointwise's FMA
// contraction. Float32 stays IEEE float32: the products run on the CUDA
// cores, never through TF32.
//
// What bounds them on an H100. stem_block0 at 1.0-224, batch 256: it reads
// 38.5 MB of uint8 and writes 411 MB of bf16 (822 MB of float32), ~0.13 ms
// at 3.35 TB/s; its 2.8 G stem + 0.9 G depthwise + 6.6 G pointwise
// multiply-adds are ~0.14 ms at the CUDA cores' 67 TFLOP/s (the pointwise
// would be 0.013 ms on the tensor cores). Bytes and CUDA-core operations
// are near each other; the unfused sequence it replaces also writes and
// reads the 205 MB normalized input, the 411 MB stem output and the
// depthwise tensor through device memory. The design: one block per
// (image, 8 x 16 tile of block 0's output); it stages the tile's uint8
// window (rows and cols 2(t0 - 1) .. 2(t0 + T) + 2, normalized, loaded as
// bytes: a pixel is 3 bytes wide) in shared memory, computes the stem on
// the tile and its one-pixel halo (10 x 18 pixels, 1.4x the stem work;
// halo pixels outside the stem grid are 0, not computed), keeps the
// rounded stem activations in shared memory, runs the 32-channel depthwise
// from there into shared memory and the pointwise from that, one output
// channel per lane, 16 pixels per thread. Nothing between the stages
// reaches device memory. stem_conv is bound by its bytes (the float input
// read once, the output written once): one block per 8 x 16 tile of output
// pixels stages its 17 x 33 x 3 input window and the 27 x Cout weights in
// shared memory, one output channel per lane. wgmma, TMA and a persistent
// schedule are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"

namespace {

using mnk::act;
using mnk::from_f;
using mnk::to_f;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int C1 = 32;        // block 0's width (alpha 1.0)
constexpr int TH = 8, TW = 16;  // output tile (block 0's output = the stem grid)
constexpr int HH = TH + 2, HW = TW + 2;        // the stem tile with its halo
constexpr int WR = 2 * HH + 1, WC = 2 * HW + 1;  // its input window: 21 x 37 pixels
constexpr int STEM_LD = C1 + 1;  // stem activations: one row of 32 per pixel, +1 (banks)
constexpr int DW_LD = C1 + 4;    // depthwise result rows, float4-aligned
constexpr int PIX_PER_WARP = TH * TW / WARPS;  // 16 pointwise pixels per thread
constexpr int WIN_FLOATS = WR * WC * 3;
constexpr int DW_FLOATS = TH * TW * DW_LD;
constexpr int WORK_FLOATS = WIN_FLOATS > DW_FLOATS ? WIN_FLOATS : DW_FLOATS;
// stem_conv's tile and window
constexpr int SR = 2 * TH + 1, SC = 2 * TW + 1;  // 17 x 33 pixels

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// One stem output: the 27 taps of a window whose top-left input pixel is
// win[0] (row stride `ld` floats, 3 channels a pixel) against the weights
// w[t * wstride] of one output channel, t = (dy * 3 + dx) * 3 + c.
__device__ __forceinline__ float stem_pixel(const float* win, int ld, const float* w,
                                            int wstride) {
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc = __fadd_rn(acc, __fmul_rn(win[dy * ld + dx * 3 + c],
                                       w[((dy * 3 + dx) * 3 + c) * wstride]));
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stem_block0_kernel(const uint8_t* __restrict__ x, const T* __restrict__ stem_w,
                       const T* __restrict__ stem_b, const T* __restrict__ dw_w,
                       const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                       const T* __restrict__ pw_b, T* __restrict__ out, int H, int W,
                       int Cout, int tiles_h, int tiles_w, bool relu6, float scale,
                       float offset) {
  __shared__ float stem[HH * HW * STEM_LD];
  __shared__ __align__(16) float work[WORK_FLOATS];  // the window, then the dw result
  float* win = work;
  float* dws = work;

  const int Hs = H / 2, Ws = W / 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  long long t = blockIdx.x;
  const int tw_i = int(t % tiles_w);
  t /= tiles_w;
  const int th_i = int(t % tiles_h);
  const int n = int(t / tiles_h);
  const int t0 = th_i * TH, u0 = tw_i * TW;

  // 1. the window, one row of 3 * WC bytes at a time, normalized and
  // rounded; outside the image (the stem's pad) 0
  const int r0 = 2 * (t0 - 1), c0 = 2 * (u0 - 1);
  const uint8_t* xn = x + (long long)n * H * W * 3;
  for (int i = tid; i < WIN_FLOATS; i += THREADS) {
    const int r = i / (WC * 3), b = i % (WC * 3);
    const int hi = r0 + r, wi = c0 + b / 3;
    float v = 0.0f;
    if (hi >= 0 && hi < H && wi >= 0 && wi < W)
      v = round_to<T>(__fadd_rn(__fmul_rn(float(xn[((long long)hi * W + c0) * 3 + b]), scale),
                                offset));
    win[i] = v;
  }
  __syncthreads();

  // 2. the stem on the tile and its halo: channel = lane, pixels by warp
  {
    float wreg[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) wreg[k] = to_f(stem_w[k * C1 + lane]);
    const float bias = to_f(stem_b[lane]);
    for (int q = warp; q < HH * HW; q += WARPS) {
      const int hr = q / HW, hc = q % HW;
      const int i = t0 - 1 + hr, j = u0 - 1 + hc;
      float v = 0.0f;
      if (i >= 0 && i < Hs && j >= 0 && j < Ws)
        v = round_to<T>(act(__fadd_rn(stem_pixel(win + (2 * hr * WC + 2 * hc) * 3, WC * 3,
                                                 wreg, 1),
                                      bias),
                            relu6));
      stem[q * STEM_LD + lane] = v;
    }
  }
  __syncthreads();  // the window is consumed: dws overlays it

  // 3. block 0's depthwise 3x3 s1: channel = lane
  {
    float wd[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wd[k] = to_f(dw_w[k * C1 + lane]);
    const float bias = to_f(dw_b[lane]);
    for (int p = warp; p < TH * TW; p += WARPS) {
      const int r = p / TW, col = p % TW;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = __fadd_rn(acc, __fmul_rn(stem[((r + dy) * HW + col + dx) * STEM_LD + lane],
                                         wd[dy * 3 + dx]));
      dws[p * DW_LD + lane] = round_to<T>(act(__fadd_rn(acc, bias), relu6));
    }
  }
  __syncthreads();

  // 4. the pointwise: 32 output channels a pass, one per lane; warp w takes
  // pixels w, w + 8, ..., each read as float4 broadcasts, one pixel's sum
  // at a time
  for (int co0 = 0; co0 < Cout; co0 += 32) {
    const int co = co0 + lane;
    const bool valid = co < Cout;
    float wp[C1];
#pragma unroll
    for (int k = 0; k < C1; ++k) wp[k] = valid ? to_f(pw_w[k * Cout + co]) : 0.0f;
    const float bias = valid ? to_f(pw_b[co]) : 0.0f;
#pragma unroll 4
    for (int j = 0; j < PIX_PER_WARP; ++j) {
      const int p = warp + WARPS * j;
      const float* a = dws + p * DW_LD;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < C1; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(a + k);
        acc = fmaf(v.x, wp[k], acc);
        acc = fmaf(v.y, wp[k + 1], acc);
        acc = fmaf(v.z, wp[k + 2], acc);
        acc = fmaf(v.w, wp[k + 3], acc);
      }
      const int ho = t0 + p / TW, wo = u0 + p % TW;
      if (valid && ho < Hs && wo < Ws)
        out[(((long long)n * Hs + ho) * Ws + wo) * Cout + co] = from_f<T>(act(acc + bias, relu6));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ out, int H, int W, int Cout,
                     int tiles_h, int tiles_w, bool relu6) {
  extern __shared__ float smem[];  // weights 27 x Cout, bias Cout, window SR x SC x 3
  float* sw = smem;
  float* sb = sw + 27 * Cout;
  float* win = sb + Cout;

  const int Hs = (H + 1) / 2, Ws = (W + 1) / 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  long long t = blockIdx.x;
  const int tw_i = int(t % tiles_w);
  t /= tiles_w;
  const int th_i = int(t % tiles_h);
  const int n = int(t / tiles_h);
  const int t0 = th_i * TH, u0 = tw_i * TW;

  for (int i = tid; i < 27 * Cout; i += THREADS) sw[i] = to_f(w[i]);
  for (int i = tid; i < Cout; i += THREADS) sb[i] = to_f(b[i]);
  // the window's top-left input pixel: the TF-SAME top/left pad is 1 on an
  // odd axis, 0 on an even one
  const int r0 = 2 * t0 - H % 2, c0 = 2 * u0 - W % 2;
  const T* xn = x + (long long)n * H * W * 3;
  for (int i = tid; i < SR * SC * 3; i += THREADS) {
    const int r = i / (SC * 3), e = i % (SC * 3);
    const int hi = r0 + r, wi = c0 + e / 3;
    win[i] = (hi >= 0 && hi < H && wi >= 0 && wi < W)
                 ? to_f(xn[((long long)hi * W + c0) * 3 + e])
                 : 0.0f;
  }
  __syncthreads();

  for (int co0 = 0; co0 < Cout; co0 += 32) {
    const int co = co0 + lane;
    if (co >= Cout) break;
    const float bias = sb[co];
    for (int p = warp; p < TH * TW; p += WARPS) {
      const int r = p / TW, col = p % TW;
      const int ho = t0 + r, wo = u0 + col;
      if (ho >= Hs || wo >= Ws) continue;
      const float acc = stem_pixel(win + (2 * r * SC + 2 * col) * 3, SC * 3, sw + co, Cout);
      out[(((long long)n * Hs + ho) * Ws + wo) * Cout + co] =
          from_f<T>(act(__fadd_rn(acc, bias), relu6));
    }
  }
}

// The grid over the (H+1)/2 x (W+1)/2 stem grid; `even`: H and W must be even.
int grid_of(int N, int H, int W, bool even, int* tiles_h, int* tiles_w, unsigned* blocks) {
  if (N < 0 || H < 0 || W < 0 || (even && (H % 2 || W % 2))) return (int)cudaErrorInvalidValue;
  *tiles_h = ((H + 1) / 2 + TH - 1) / TH;
  *tiles_w = ((W + 1) / 2 + TW - 1) / TW;
  const long long b = (long long)N * *tiles_h * *tiles_w;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

template <typename T>
int launch_stem_block0(const void* x, const void* stem_w, const void* stem_b,
                       const void* dw_w, const void* dw_b, const void* pw_w,
                       const void* pw_b, void* out, int N, int H, int W, int Cout,
                       int relu6, float scale, float offset, void* stream) {
  int tiles_h, tiles_w;
  unsigned blocks;
  if (Cout <= 0) return (int)cudaErrorInvalidValue;
  int err = grid_of(N, H, W, true, &tiles_h, &tiles_w, &blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  stem_block0_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const T*)stem_w, (const T*)stem_b, (const T*)dw_w,
      (const T*)dw_b, (const T*)pw_w, (const T*)pw_b, (T*)out, H, W, Cout, tiles_h,
      tiles_w, relu6 != 0, scale, offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stem_conv(const void* x, const void* w, const void* b, void* out, int N, int H,
                     int W, int Cout, int relu6, void* stream) {
  int tiles_h, tiles_w;
  unsigned blocks;
  if (Cout <= 0 || Cout > 256) return (int)cudaErrorInvalidValue;
  int err = grid_of(N, H, W, false, &tiles_h, &tiles_w, &blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  const size_t smem = (size_t)(28 * Cout + SR * SC * 3) * sizeof(float);  // <= 35,412 bytes
  stem_conv_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, H, W, Cout, tiles_h, tiles_w,
      relu6 != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stem_block0_f32(const void* x, const void* stem_w, const void* stem_b, const void* dw_w,
                    const void* dw_b, const void* pw_w, const void* pw_b, void* out, int N,
                    int H, int W, int Cout, int relu6, float scale, float offset,
                    void* stream) {
  return launch_stem_block0<float>(x, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out, N, H, W,
                                   Cout, relu6, scale, offset, stream);
}

int stem_block0_bf16(const void* x, const void* stem_w, const void* stem_b,
                     const void* dw_w, const void* dw_b, const void* pw_w, const void* pw_b,
                     void* out, int N, int H, int W, int Cout, int relu6, float scale,
                     float offset, void* stream) {
  return launch_stem_block0<__nv_bfloat16>(x, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out,
                                           N, H, W, Cout, relu6, scale, offset, stream);
}

int stem_conv_f32(const void* x, const void* w, const void* b, void* out, int N, int H,
                  int W, int Cout, int relu6, void* stream) {
  return launch_stem_conv<float>(x, w, b, out, N, H, W, Cout, relu6, stream);
}

int stem_conv_bf16(const void* x, const void* w, const void* b, void* out, int N, int H,
                   int W, int Cout, int relu6, void* stream) {
  return launch_stem_conv<__nv_bfloat16>(x, w, b, out, N, H, W, Cout, relu6, stream);
}

}  // extern "C"
