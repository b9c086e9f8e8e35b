// K stride-1 C->C separable blocks in one cooperative launch.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_chain_systolic.py
// chain_systolic (:120), which runs V1 blocks 6-10 (14x14x512, K=5) on the
// batch-1 route. Its output equals K per-block launches in sequence, bit for
// bit: every stage runs the per-block kernel's code on the same plan, bf16
// the Hopper stage of separable_wgmma.cuh (plan from
// ops/separable_block.separable_plan, passed by the caller), float32 the
// tile of separable_tile.cuh.
//
// What bounds it on an H100: at batch 1 each block is 1.3 MFLOP of depthwise
// and 51 MFLOP of pointwise work, so a per-block launch leaves most SMs idle
// and pays a launch and a kernel boundary per block. Here one persistent
// grid runs all K stages; stage k+1 waits for stage k at a grid-wide barrier
// (cooperative_groups::this_grid().sync()), since blocks run in no order.
// The launch is cooperative so the whole grid is co-resident; its size is
// the unit (bf16) or tile (float32) count capped by what
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows at the kernel's
// dynamic shared memory. The activation between stages goes through two
// ping-pong scratch buffers that the caller allocates (200 KB per image at
// 14x14x512 bf16), which stay in L2. In bf16 a stage's input windows load by
// TMA (the async proxy): after each grid barrier the producer fences the
// other blocks' stores into that proxy (fence.proxy.async.global); the
// float32 stages load through L2 (__ldcg). Keeping the activations in
// distributed shared memory across a thread-block cluster is later work.
#include <cooperative_groups.h>

#include "separable_tile.cuh"
#include "separable_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using mnk::sw::bf16;

__global__ void __launch_bounds__(mnk::THREADS)
    chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ dw_ws,
                     const float* __restrict__ dw_bs, const float* __restrict__ pw_ws,
                     const float* __restrict__ pw_bs, float* scratch0, float* scratch1,
                     float* out, mnk::BlockShape s, int K) {
  __shared__ __align__(128) unsigned char smem[mnk::TILE_SMEM_BYTES];
  cg::grid_group grid = cg::this_grid();
  const int C = s.Cin;
  const long long tiles = mnk::num_tiles(s);
  const float* src = x;
  for (int k = 0; k < K; ++k) {
    float* dst = (k == K - 1) ? out : ((k % 2 == 0) ? scratch0 : scratch1);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
      mnk::separable_tile<true>(src, dw_ws + (long long)k * 9 * C, dw_bs + (long long)k * C,
                                pw_ws + (long long)k * C * C, pw_bs + (long long)k * C, dst, s,
                                t, smem);
    if (k + 1 < K) grid.sync();
    src = dst;
  }
}

// maps.x[0] is the input, x[1] and x[2] the scratch buffers; weight map
// block k is stage k's weight.
template <int NWG>
__global__ void __launch_bounds__(mnk::sw::threads_of(NWG), 1)
    chain_bf16_kernel(const __grid_constant__ mnk::sw::Maps maps, const mnk::sw::Launch l,
                      const mnk::sw::Geo g) {
  extern __shared__ unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  mnk::sw::run<NWG, true>(g, smem_raw, maps, l, [&] { grid.sync(); });
}

// The cooperative launch: grid = units capped by co-residency.
int cooperative(const void* kernel, long long units, int threads, int smem, void** args,
                void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long cap = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(units < cap ? units : cap);
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
               const void* pw_bs, void* scratch0, void* scratch1, void* out, int N, int H,
               int W, int C, int K, int relu6, void* stream) {
  mnk::BlockShape s = mnk::make_shape(N, H, W, C, C, 1, relu6);
  const long long tiles = mnk::num_tiles(s);
  if (tiles <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const float* xp = (const float*)x;
  const float* dwp = (const float*)dw_ws;
  const float* dbp = (const float*)dw_bs;
  const float* pwp = (const float*)pw_ws;
  const float* pbp = (const float*)pw_bs;
  float* s0 = (float*)scratch0;
  float* s1 = (float*)scratch1;
  float* op = (float*)out;
  void* args[] = {&xp, &dwp, &dbp, &pwp, &pbp, &s0, &s1, &op, &s, &K};
  return cooperative((const void*)chain_f32_kernel, tiles, mnk::THREADS, 0, args, stream);
}

template <int NWG>
int launch_bf16(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
                const void* pw_bs, void* scratch0, void* scratch1, void* out,
                const mnk::sw::Geo& g, int K, void* stream) {
  auto kernel = chain_bf16_kernel<NWG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  mnk::sw::Maps maps;
  const void* srcs[3] = {x, scratch0, scratch1};
  for (int i = 0; i < 3; ++i)
    if ((e = mnk::sw::make_x_map(&maps.x[i], srcs[i], g)) != cudaSuccess) return (int)e;
  if ((e = mnk::sw::make_w_maps(maps, pw_ws, g, K)) != cudaSuccess) return (int)e;
  mnk::sw::Launch l{(const bf16*)dw_ws, (const bf16*)dw_bs, (const bf16*)pw_bs, (bf16*)out,
                    (bf16*)scratch0, (bf16*)scratch1, K};
  mnk::sw::Geo gg = g;
  void* args[] = {&maps, &l, &gg};
  return cooperative((const void*)kernel, g.units, mnk::sw::threads_of(NWG), g.smem_bytes, args,
                     stream);
}

}  // namespace

extern "C" {

// plan: nwg, th, tw, kp, split, cw, ws, bs (ops/separable_block.separable_plan
// of one block of the chain's shape)
int chain_bf16(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
               const void* pw_bs, void* scratch0, void* scratch1, void* out, int N,
               int H, int W, int C, int K, int relu6, int nwg, int th, int tw, int kp,
               int split, int cw, int ws, int bs, void* stream) {
  const mnk::sw::Plan p{nwg, th, tw, kp, split, cw, ws, bs};
  const mnk::sw::Geo g = mnk::sw::make_geo(N, H, W, C, C, 1, relu6, p);
  cudaError_t e = mnk::sw::check_geo(g);
  if (e != cudaSuccess) return (int)e;
  if (g.units <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return nwg == 2 ? launch_bf16<2>(x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out, g,
                                   K, stream)
                  : launch_bf16<1>(x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out, g,
                                   K, stream);
}

int chain_f32(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
              const void* pw_bs, void* scratch0, void* scratch1, void* out, int N,
              int H, int W, int C, int K, int relu6, void* stream) {
  return launch_f32(x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out, N, H, W, C, K,
                    relu6, stream);
}

}  // extern "C"
