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
// float32 (stem_f32.cuh): exact IEEE float32 on the CUDA cores, in the
// plain versions' order, bit-equal to them in the stem and the depthwise.
// A lane is an output channel with its 27 stem weights in registers and
// computes a strip of pixels from 16-byte window broadcasts; a producer
// warp stages the next tile's window into a ring on mbarriers (stem_block0:
// the uint8 granules, normalized once into a float32 window) while the
// consumer warps compute; stem_block0's depthwise slides down its rows in
// registers and its pointwise runs 8 x 8 fmaf micro-tiles with the weight
// resident. A persistent grid over the tiles of ops/stem.f32_stem_plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"
#include "stem_f32.cuh"
#include "stem_wgmma.cuh"

namespace {

namespace stf = mnk::stf;

__global__ void __launch_bounds__(stf::THREADS, 2)
    stem_conv_f32_kernel(const __grid_constant__ stf::Geo g, const float* __restrict__ x,
                         const float* __restrict__ w, const float* __restrict__ b,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  stf::conv_run(g, x, w, b, out, smem_f32);
}

__global__ void __launch_bounds__(stf::B0_THREADS, 2)
    stem_block0_f32_kernel(const __grid_constant__ stf::Geo g, const uint8_t* __restrict__ x,
                           const float* __restrict__ stem_w, const float* __restrict__ stem_b,
                           const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                           const float* __restrict__ pw_w, const float* __restrict__ pw_b,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  stf::b0_run(g, x, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out, smem_f32);
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

// A persistent launch of min(grid, work) blocks.
template <class Geo, class Kernel, class... Args>
int launch_persistent(Kernel kernel, int threads, const Geo& g, int grid, int work,
                      void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = grid < work ? grid : work;
  kernel<<<blocks, threads, g.smem_bytes, (cudaStream_t)stream>>>(g, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plan: th (16, 8, 4 or 2), cpu, grid (ops/stem.f32_stem_plan; the tile is
// th x 16, a unit cpu tiles down a column band)
int stem_block0_f32(const void* x, const void* stem_w, const void* stem_b, const void* dw_w,
                    const void* dw_b, const void* pw_w, const void* pw_b, void* out, int N,
                    int H, int W, int Cout, int relu6, float scale, float offset, int th,
                    int cpu, int grid, void* stream) {
  if (N < 0 || H < 0 || W < 0 || cpu < 1) return (int)cudaErrorInvalidValue;
  const stf::Geo g = stf::b0_geo(N, H, W, Cout, relu6, th, cpu, scale, offset);
  int err = (int)stf::check_b0(g, grid);
  if (err == (int)cudaSuccess) err = tiles_ok(N, g.tiles_h, g.tiles_w);
  if (err != (int)cudaSuccess || g.tiles == 0) return err;
  return launch_persistent(stem_block0_f32_kernel, stf::B0_THREADS, g, grid, g.units, stream,
                           (const uint8_t*)x, (const float*)stem_w, (const float*)stem_b,
                           (const float*)dw_w, (const float*)dw_b, (const float*)pw_w,
                           (const float*)pw_b, (float*)out);
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
  return launch_persistent(kernel, stw::B0_THREADS, g, grid, g.tiles, stream, (const uint8_t*)x,
                           (const stw::bf16*)stem_w, (const stw::bf16*)stem_b,
                           (const stw::bf16*)dw_w, (const stw::bf16*)dw_b,
                           (const stw::bf16*)pw_w, (const stw::bf16*)pw_b, (stw::bf16*)out);
}

// plan: th, tw, grid (ops/stem.f32_stem_plan)
int stem_conv_f32(const void* x, const void* w, const void* b, void* out, int N, int H,
                  int W, int Cout, int relu6, int th, int tw, int grid, void* stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const stf::Geo g = stf::conv_geo(N, H, W, Cout, relu6, th, tw);
  int err = (int)stf::check_conv(g, grid);
  if (err == (int)cudaSuccess) err = tiles_ok(N, g.tiles_h, g.tiles_w);
  if (err != (int)cudaSuccess || g.tiles == 0) return err;
  return launch_persistent(stem_conv_f32_kernel, stf::THREADS, g, grid, g.tiles, stream,
                           (const float*)x, (const float*)w, (const float*)b, (float*)out);
}

// plan: th, tw, grid (ops/stem.stem_plan)
int stem_conv_bf16(const void* x, const void* w, const void* b, void* out, int N, int H,
                   int W, int Cout, int relu6, int th, int tw, int grid, void* stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const stw::Geo g = stw::conv_geo(N, H, W, Cout, relu6, th, tw);
  int err = (int)stw::check_conv(g, grid);
  if (err == (int)cudaSuccess) err = tiles_ok(N, g.tiles_h, g.tiles_w);
  if (err != (int)cudaSuccess || g.tiles == 0) return err;
  return launch_persistent(stem_conv_bf16_kernel, stw::CONV_THREADS, g, grid, g.tiles, stream,
                           (const stw::bf16*)x, (const stw::bf16*)w, (const stw::bf16*)b,
                           (stw::bf16*)out);
}

// Dynamic shared memory of a bf16 plan (the CPU tests mirror it): block0
// 1 for stem_block0 (tile th x 16), 0 for stem_conv (th x tw).
int stem_smem_bytes(int block0, int th, int tw, int cout) {
  return block0 ? stw::b0_geo(1, 2, 2, cout, 1, th, 0.0f, 0.0f).smem_bytes
                : stw::conv_geo(1, 2, 2, cout, 1, th, tw).smem_bytes;
}

// Dynamic shared memory of a float32 plan (ops/stem.f32_stem_smem_bytes):
// block0 1 for stem_block0 (tile th x 16), 0 for stem_conv (th x tw).
int stem_f32_smem_bytes(int block0, int th, int tw, int cout) {
  return block0 ? stf::b0_geo(1, 2, 2, cout, 1, th, 1, 0.0f, 0.0f).smem_bytes
                : stf::conv_geo(1, 2, 2, cout, 1, th, tw).smem_bytes;
}

}  // extern "C"
