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
//
// What bounds them on an H100. stem_block0 at 1.0-224, batch 256: it reads
// 38.5 MB of uint8 and writes 411 MB of bf16 (822 MB of float32), ~0.13 ms
// at 3.35 TB/s; stem_conv reads 77 MB of bf16 and writes 205 MB, ~0.084 ms.
// Their 2.8 G stem + 0.9 G depthwise + 6.6 G pointwise multiply-adds take
// ~0.12 ms with the stem and depthwise on the CUDA cores (as stem_block0
// runs them, to stay exact) and the pointwise on the tensor cores;
// stem_conv's stem on the tensor cores takes ~0.006: bytes bound both. The
// unfused sequence stem_block0 replaces also writes and reads the
// normalized input, the stem output and the depthwise tensor through device
// memory.
//
// bf16 (stem_wgmma.cuh): no shared-memory operand per multiply-add.
// stem_conv's stem is an im2col product on wgmma; stem_block0's stem is an
// exact FMA chain a pixel (its taps in registers, the weights as 16-byte
// broadcasts), its depthwise from registers, its pointwise on wgmma with the
// weight resident. A persistent grid over the tiles of ops/stem.stem_plan,
// each tile's window staged by cp.async in 16-byte granules while the last
// tile computes.
//
// float32 (below): the verify and anchor path, exact IEEE float32 on the
// CUDA cores, in the plain versions' order (ops/stem.py):
//   1. (stem_block0) x = u8 * scale + offset in float32 (a multiply, then an
//      add); the stem's TF-SAME pad (0, 1) is 0 in the normalized domain
//      (not normalize(0) = -1);
//   2. the stem: 27 taps in (dy, dx, c) order, each a float32 multiply then
//      add (__fmul_rn, __fadd_rn: never contracted into an FMA), + bias in
//      float32, ReLU or ReLU6;
//   3. (stem_block0) the depthwise 3x3 s1 on the stem activations, with a
//      zero SAME pad in that domain, taps in (dy, dx) order, the same
//      multiply-then-add, + bias, activation;
//   4. (stem_block0) the pointwise 32 -> Cout: float32 sums over k in
//      order (fmaf), + bias, activation.
// One block per (image, 8 x 16 tile): stem_block0 stages the tile's uint8
// window in shared memory, computes the stem on the tile and its one-pixel
// halo (halo pixels outside the stem grid are 0), then the depthwise and
// the pointwise from shared memory, one output channel per lane;
// stem_conv stages its 17 x 33 x 3 window and the 27 x Cout weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"
#include "stem_wgmma.cuh"

namespace {

using mnk::act;

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

// One stem output: the 27 taps of a window whose top-left input pixel is
// win[0] (row stride `ld` floats, 3 channels a pixel) against the weights
// w[t * wstride] of one output channel, t = (dy * 3 + dx) * 3 + c.
__device__ __forceinline__ float stem_sum(const float* win, int ld, const float* w,
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

__global__ void __launch_bounds__(THREADS)
    stem_block0_kernel(const uint8_t* __restrict__ x, const float* __restrict__ stem_w,
                       const float* __restrict__ stem_b, const float* __restrict__ dw_w,
                       const float* __restrict__ dw_b, const float* __restrict__ pw_w,
                       const float* __restrict__ pw_b, float* __restrict__ out, int H, int W,
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

  // 1. the window, one row of 3 * WC bytes at a time, normalized; outside
  // the image (the stem's pad) 0
  const int r0 = 2 * (t0 - 1), c0 = 2 * (u0 - 1);
  const uint8_t* xn = x + (long long)n * H * W * 3;
  for (int i = tid; i < WIN_FLOATS; i += THREADS) {
    const int r = i / (WC * 3), b = i % (WC * 3);
    const int hi = r0 + r, wi = c0 + b / 3;
    float v = 0.0f;
    if (hi >= 0 && hi < H && wi >= 0 && wi < W)
      v = __fadd_rn(__fmul_rn(float(xn[((long long)hi * W + c0) * 3 + b]), scale), offset);
    win[i] = v;
  }
  __syncthreads();

  // 2. the stem on the tile and its halo: channel = lane, pixels by warp
  {
    float wreg[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) wreg[k] = stem_w[k * C1 + lane];
    const float bias = stem_b[lane];
    for (int q = warp; q < HH * HW; q += WARPS) {
      const int hr = q / HW, hc = q % HW;
      const int i = t0 - 1 + hr, j = u0 - 1 + hc;
      float v = 0.0f;
      if (i >= 0 && i < Hs && j >= 0 && j < Ws)
        v = act(__fadd_rn(stem_sum(win + (2 * hr * WC + 2 * hc) * 3, WC * 3, wreg, 1), bias),
                relu6);
      stem[q * STEM_LD + lane] = v;
    }
  }
  __syncthreads();  // the window is consumed: dws overlays it

  // 3. block 0's depthwise 3x3 s1: channel = lane
  {
    float wd[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wd[k] = dw_w[k * C1 + lane];
    const float bias = dw_b[lane];
    for (int p = warp; p < TH * TW; p += WARPS) {
      const int r = p / TW, col = p % TW;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = __fadd_rn(acc, __fmul_rn(stem[((r + dy) * HW + col + dx) * STEM_LD + lane],
                                         wd[dy * 3 + dx]));
      dws[p * DW_LD + lane] = act(__fadd_rn(acc, bias), relu6);
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
    for (int k = 0; k < C1; ++k) wp[k] = valid ? pw_w[k * Cout + co] : 0.0f;
    const float bias = valid ? pw_b[co] : 0.0f;
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
        out[(((long long)n * Hs + ho) * Ws + wo) * Cout + co] = act(acc + bias, relu6);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int H, int W, int Cout,
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

  for (int i = tid; i < 27 * Cout; i += THREADS) sw[i] = w[i];
  for (int i = tid; i < Cout; i += THREADS) sb[i] = b[i];
  // the window's top-left input pixel: the TF-SAME top/left pad is 1 on an
  // odd axis, 0 on an even one
  const int r0 = 2 * t0 - H % 2, c0 = 2 * u0 - W % 2;
  const float* xn = x + (long long)n * H * W * 3;
  for (int i = tid; i < SR * SC * 3; i += THREADS) {
    const int r = i / (SC * 3), e = i % (SC * 3);
    const int hi = r0 + r, wi = c0 + e / 3;
    win[i] = (hi >= 0 && hi < H && wi >= 0 && wi < W)
                 ? (xn[((long long)hi * W + c0) * 3 + e])
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
      const float acc = stem_sum(win + (2 * r * SC + 2 * col) * 3, SC * 3, sw + co, Cout);
      out[(((long long)n * Hs + ho) * Ws + wo) * Cout + co] = act(__fadd_rn(acc, bias), relu6);
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

int launch_stem_block0_f32(const void* x, const void* stem_w, const void* stem_b,
                           const void* dw_w, const void* dw_b, const void* pw_w,
                           const void* pw_b, void* out, int N, int H, int W, int Cout,
                           int relu6, float scale, float offset, void* stream) {
  int tiles_h, tiles_w;
  unsigned blocks;
  if (Cout <= 0) return (int)cudaErrorInvalidValue;
  int err = grid_of(N, H, W, true, &tiles_h, &tiles_w, &blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  stem_block0_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const float*)stem_w, (const float*)stem_b, (const float*)dw_w,
      (const float*)dw_b, (const float*)pw_w, (const float*)pw_b, (float*)out, H, W, Cout,
      tiles_h, tiles_w, relu6 != 0, scale, offset);
  return (int)cudaGetLastError();
}

int launch_stem_conv_f32(const void* x, const void* w, const void* b, void* out, int N, int H,
                         int W, int Cout, int relu6, void* stream) {
  int tiles_h, tiles_w;
  unsigned blocks;
  if (Cout <= 0 || Cout > 256) return (int)cudaErrorInvalidValue;
  int err = grid_of(N, H, W, false, &tiles_h, &tiles_w, &blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  const size_t smem = (size_t)(28 * Cout + SR * SC * 3) * sizeof(float);  // <= 35,412 bytes
  stem_conv_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, H, W, Cout, tiles_h,
      tiles_w, relu6 != 0);
  return (int)cudaGetLastError();
}

namespace stw = mnk::stw;

__global__ void __launch_bounds__(stw::CONV_THREADS, 4)
    stem_conv_bf16_kernel(const __grid_constant__ stw::Geo g, const stw::bf16* __restrict__ x,
                          const stw::bf16* __restrict__ w, const stw::bf16* __restrict__ b,
                          stw::bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  stw::conv_run(g, x, w, b, out, smem_raw);
}

template <int kTH>
__global__ void __launch_bounds__(stw::B0_THREADS, 2)
    stem_block0_bf16_kernel(const __grid_constant__ stw::Geo g, const uint8_t* __restrict__ x,
                            const stw::bf16* __restrict__ stem_w,
                            const stw::bf16* __restrict__ stem_b,
                            const stw::bf16* __restrict__ dw_w,
                            const stw::bf16* __restrict__ dw_b,
                            const stw::bf16* __restrict__ pw_w,
                            const stw::bf16* __restrict__ pw_b, stw::bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  stw::b0_run<kTH>(g, x, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out, smem_raw);
}

// The tiles of a plan as an int, or an error if they do not fit one.
int tiles_ok(long long N, int tiles_h, int tiles_w) {
  return N * tiles_h * tiles_w > 0x7fffffffLL ? (int)cudaErrorInvalidConfiguration
                                              : (int)cudaSuccess;
}

template <class Kernel, class... Args>
int launch_persistent(Kernel kernel, int threads, const stw::Geo& g, int grid, void* stream,
                      Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = grid < g.tiles ? grid : g.tiles;
  kernel<<<blocks, threads, g.smem_bytes, (cudaStream_t)stream>>>(g, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stem_block0_f32(const void* x, const void* stem_w, const void* stem_b, const void* dw_w,
                    const void* dw_b, const void* pw_w, const void* pw_b, void* out, int N,
                    int H, int W, int Cout, int relu6, float scale, float offset,
                    void* stream) {
  return launch_stem_block0_f32(x, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out, N, H, W, Cout,
                                relu6, scale, offset, stream);
}

// plan: th (12 or 6), grid (ops/stem.stem_plan; the tile is th x 16)
int stem_block0_bf16(const void* x, const void* stem_w, const void* stem_b,
                     const void* dw_w, const void* dw_b, const void* pw_w, const void* pw_b,
                     void* out, int N, int H, int W, int Cout, int relu6, float scale,
                     float offset, int th, int grid, void* stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const stw::Geo g = stw::b0_geo(N, H, W, Cout, relu6, th, scale, offset);
  int err = (int)stw::check_b0(g, grid);
  if (err == (int)cudaSuccess) err = tiles_ok(N, g.tiles_h, g.tiles_w);
  if (err != (int)cudaSuccess || g.tiles == 0) return err;
  auto kernel = th == 12 ? stem_block0_bf16_kernel<12> : stem_block0_bf16_kernel<6>;
  return launch_persistent(kernel, stw::B0_THREADS, g, grid, stream, (const uint8_t*)x,
                           (const stw::bf16*)stem_w, (const stw::bf16*)stem_b,
                           (const stw::bf16*)dw_w, (const stw::bf16*)dw_b,
                           (const stw::bf16*)pw_w, (const stw::bf16*)pw_b, (stw::bf16*)out);
}

int stem_conv_f32(const void* x, const void* w, const void* b, void* out, int N, int H,
                  int W, int Cout, int relu6, void* stream) {
  return launch_stem_conv_f32(x, w, b, out, N, H, W, Cout, relu6, stream);
}

// plan: th, tw, grid (ops/stem.stem_plan)
int stem_conv_bf16(const void* x, const void* w, const void* b, void* out, int N, int H,
                   int W, int Cout, int relu6, int th, int tw, int grid, void* stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const stw::Geo g = stw::conv_geo(N, H, W, Cout, relu6, th, tw);
  int err = (int)stw::check_conv(g, grid);
  if (err == (int)cudaSuccess) err = tiles_ok(N, g.tiles_h, g.tiles_w);
  if (err != (int)cudaSuccess || g.tiles == 0) return err;
  return launch_persistent(stem_conv_bf16_kernel, stw::CONV_THREADS, g, grid, stream,
                           (const stw::bf16*)x, (const stw::bf16*)w, (const stw::bf16*)b,
                           (stw::bf16*)out);
}

// Dynamic shared memory of a bf16 plan (the CPU tests mirror it): block0
// 1 for stem_block0 (tile th x 16), 0 for stem_conv (th x tw).
int stem_smem_bytes(int block0, int th, int tw, int cout) {
  return block0 ? stw::b0_geo(1, 2, 2, cout, 1, th, 0.0f, 0.0f).smem_bytes
                : stw::conv_geo(1, 2, 2, cout, 1, th, tw).smem_bytes;
}

}  // extern "C"
