// K stride-1 C->C separable blocks in one cooperative launch.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_chain_systolic.py
// chain_systolic (:120), which runs V1 blocks 6-10 (14x14x512, K=5) on the
// batch-1 route. Its output equals K per-block launches in sequence, bit for
// bit: every stage runs the per-block kernel's code on the same plan, bf16
// the Hopper stage of separable_wgmma.cuh (plan from
// ops/separable_block.separable_plan, passed by the caller), float32 the
// stage of separable_f32.cuh (plan from ops/separable_block.f32_sep_plan).
//
// What bounds it on an H100: at batch 1 each block is 1.3 MFLOP of depthwise
// and 51 MFLOP of pointwise work, so a per-block launch leaves most SMs idle
// and pays a launch and a kernel boundary per block. Here one persistent
// grid runs all K stages; stage k+1 waits for stage k at a grid-wide barrier
// (cooperative_groups::this_grid().sync()), since blocks run in no order.
// The launch is cooperative so the whole grid is co-resident; its size is
// the unit count capped by what
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows at the kernel's
// dynamic shared memory. The activation between stages goes through two
// ping-pong scratch buffers that the caller allocates (200 KB per image at
// 14x14x512 bf16), which stay in L2. In bf16 a stage's input windows load by
// TMA (the async proxy): after each grid barrier the producer fences the
// other blocks' stores into that proxy (fence.proxy.async.global); the
// float32 stages' cp.async copies (cp.async.cg) read through L2, which holds
// the other blocks' stores once the barrier has passed. Keeping the
// activations in distributed shared memory across a thread-block cluster is
// later work.
#include <cooperative_groups.h>

#include "separable_f32.cuh"
#include "separable_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using mnk::sw::bf16;

namespace sf = mnk::sf;

// p: the input, stage 0's weights (stage k's follow at k x their size) and the
// output; scratch0/1 between the stages.
template <int MG>
__global__ void __launch_bounds__(sf::THREADS, 1)
    chain_f32_kernel(const __grid_constant__ sf::Geo g, const sf::Ptrs p, float* scratch0,
                     float* scratch1, int K) {
  extern __shared__ __align__(128) unsigned char smem_cf[];
  cg::grid_group grid = cg::this_grid();
  sf::setup(smem_cf);
  sf::Ring wr, br;
  const long long C = g.Cin;
  const float* src = p.x;
  for (int k = 0; k < K; ++k) {
    float* dst = (k == K - 1) ? p.out : ((k % 2 == 0) ? scratch0 : scratch1);
    const sf::Ptrs ps{src, p.dw + k * 9 * C, p.db + k * C, p.pw + k * C * C, p.pb + k * C, dst};
    sf::run<MG>(g, ps, smem_cf, wr, br);
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
  mnk::sw::run<NWG, mnk::kBiasAct>(g, smem_raw, maps, l, [&] { grid.sync(); });
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

sf::Launcher f32_launcher{{(const void*)chain_f32_kernel<1>, (const void*)chain_f32_kernel<2>},
                          {0, 0}};

int launch_f32(const sf::Geo& g, const sf::Ptrs& p, void* scratch0, void* scratch1, int K,
               void* stream) {
  const void* kernel = nullptr;
  unsigned grid = 0;
  cudaError_t e = sf::prepare(f32_launcher, g, &kernel, &grid);
  if (e != cudaSuccess) return (int)e;
  sf::Geo gg = g;
  sf::Ptrs pp = p;
  float* s0 = (float*)scratch0;
  float* s1 = (float*)scratch1;
  void* args[] = {&gg, &pp, &s0, &s1, &K};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(sf::THREADS), args, g.smem_bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// plan: mg, th, tw, kp, split, cw, ns, ws, bs (ops/separable_block.f32_sep_plan
// of one block of the chain's shape)
int chain_f32(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
              const void* pw_bs, void* scratch0, void* scratch1, void* out, int N,
              int H, int W, int C, int K, int relu6, int mg, int th, int tw, int kp, int split,
              int cw, int ns, int ws, int bs, void* stream) {
  const sf::Geo g = sf::make_geo(N, H, W, C, C, 1, relu6, 1,
                                 sf::Plan{mg, th, tw, kp, split, cw, ns, ws, bs});
  if (!sf::geo_ok(g) || K <= 0) return (int)cudaErrorInvalidValue;
  using F = const float*;
  const sf::Ptrs p{(F)x, (F)dw_ws, (F)dw_bs, (F)pw_ws, (F)pw_bs, static_cast<float*>(out)};
  return launch_f32(g, p, scratch0, scratch1, K, stream);
}

}  // extern "C"
