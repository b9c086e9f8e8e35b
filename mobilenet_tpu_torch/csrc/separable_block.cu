// Fused depthwise 3x3 (+bias+act) -> pointwise 1x1 (+bias+act) block.
//
// Replaces the TPU kernels mobilenet_tpu/ops/pallas_block.py
// separable_block_pallas (:217), and the lane-packed
// ops/pallas_block_packed.py separable_block_packed (:132) and
// separable_block_packed_s2 (:371) and ops/pallas_block_packed_mxu.py
// separable_block_packed_mxu (:264): the packing existed only for the TPU's
// (8,128) vector tiles, so narrow blocks (C = 32/64) run this same dense
// NHWC kernel. The pointwise epilogue `epi` (numerics.cuh Epilogue): kBiasAct
// the block as above; kBias the packed kernels' pw_epilogue=False mode (the
// depthwise keeps its activation, the projection is bias only: the linear
// bottleneck of MobileNet-V2's t == 1 block 0); kRaw separable_block_pallas's
// pw_epilogue=False mode (:300-304): the raw float32 pointwise accumulation,
// no bias and no activation, a float32 output whatever x's dtype (the
// tensor-parallel partial of a channel shard, parallel/tp_fused.py).
//
// What bounds it on an H100: at batch 256 a block is a bf16 GEMM of
// M = N*Ho*Wo pixels by K = Cin by Cout (13 to 26 GFLOP a block, 276 for the
// 13 blocks of V1 1.0-224) after a 9-tap stencil; its compulsory bytes (the
// input and output once, 0.9 ms for the 13 blocks at 3.35 TB/s) bound it,
// not the products (0.28 ms at 989 TFLOP/s). The unfused pair would also
// write and read the depthwise tensor (up to 205 MB a block).
//
// bf16 (separable_wgmma.cuh): a persistent grid over units of a pixel tile x
// a part of Cout (the plan, ops/separable_block.separable_plan). The
// depthwise runs once per pixel and channel of a unit from an input window
// that TMA stages asynchronously into shared memory (ring of 1-2 slots),
// into a swizzled A panel (TM x Cin bf16) that every output slice reuses;
// the pointwise weight streams through a TMA ring while wgmma (m64nNk16,
// N = 128/64/32/16/8, no padded columns) multiplies; the epilogue stores
// 16-byte vectors. A producer warp runs each ring, so the next unit's window
// and the next weight chunk load while the warpgroups compute.
//
// float32 (separable_f32.cuh, the plan of ops/separable_block.f32_sep_plan):
// exact IEEE float32 by fmaf on the CUDA cores; a persistent grid over units
// of a pixel tile x a part of Cout, a producer warp's cp.async rings of window
// chunks and weight stages, the depthwise once per pixel and channel of a
// unit into a K-major panel, 8 x 8 (or 4 x 4) register micro-tiles with
// float4 operands for the pointwise (the header says what held the old tile).
#include "separable_f32.cuh"
#include "separable_wgmma.cuh"

namespace {

using mnk::sw::bf16;

namespace sf = mnk::sf;

template <int MG>
__global__ void __launch_bounds__(sf::THREADS, 1)
    separable_block_f32_kernel(const __grid_constant__ sf::Geo g, const sf::Ptrs p) {
  extern __shared__ __align__(128) unsigned char smem_sf[];
  sf::setup(smem_sf);
  sf::Ring wr, br;
  sf::run<MG>(g, p, smem_sf, wr, br);
}

template <int NWG, int kEpi>
__global__ void __launch_bounds__(mnk::sw::threads_of(NWG), 1)
    separable_block_bf16_kernel(const __grid_constant__ mnk::sw::Maps maps,
                                const mnk::sw::Launch l, const mnk::sw::Geo g) {
  extern __shared__ unsigned char smem_raw[];
  mnk::sw::run<NWG, kEpi>(g, smem_raw, maps, l, [] {});
}

sf::Launcher f32_launcher{
    {(const void*)separable_block_f32_kernel<1>, (const void*)separable_block_f32_kernel<2>},
    {0, 0}};

// A persistent grid of at most the co-resident blocks over the plan's units.
int launch_f32(const sf::Geo& g, const sf::Ptrs& p, void* stream) {
  const void* kernel = nullptr;
  unsigned grid = 0;
  cudaError_t e = sf::prepare(f32_launcher, g, &kernel, &grid);
  if (e != cudaSuccess) return (int)e;
  sf::Geo gg = g;
  sf::Ptrs pp = p;
  void* args[] = {&gg, &pp};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(sf::THREADS), args, g.smem_bytes,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_bf16(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                const void* pw_b, void* out, const mnk::sw::Geo& g, int epi, void* stream) {
  auto kernel = epi == mnk::kRaw    ? separable_block_bf16_kernel<NWG, mnk::kRaw>
                : epi == mnk::kBias ? separable_block_bf16_kernel<NWG, mnk::kBias>
                                    : separable_block_bf16_kernel<NWG, mnk::kBiasAct>;
  const int threads = mnk::sw::threads_of(NWG);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  mnk::sw::Maps maps;
  if ((e = mnk::sw::make_x_map(&maps.x[0], x, g)) != cudaSuccess) return (int)e;
  if ((e = mnk::sw::make_w_maps(maps, pw_w, g, 1)) != cudaSuccess) return (int)e;
  const long long cap = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(g.units < cap ? g.units : cap);
  const mnk::sw::Launch l{(const bf16*)dw_w, (const bf16*)dw_b, (const bf16*)pw_b, out,
                          nullptr, nullptr, 1};
  kernel<<<grid, threads, g.smem_bytes, (cudaStream_t)stream>>>(maps, l, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// epi: 0 kBias, 1 kBiasAct, 2 kRaw (out float32); plan: nwg, th, tw, kp,
// split, cw, ws, bs (ops/separable_block.separable_plan)
int separable_block_bf16(const void* x, const void* dw_w, const void* dw_b,
                         const void* pw_w, const void* pw_b, void* out, int N, int H,
                         int W, int Cin, int Cout, int stride, int relu6, int epi,
                         int nwg, int th, int tw, int kp, int split, int cw, int ws, int bs,
                         void* stream) {
  const mnk::sw::Plan p{nwg, th, tw, kp, split, cw, ws, bs};
  const mnk::sw::Geo g = mnk::sw::make_geo(N, H, W, Cin, Cout, stride, relu6, p);
  cudaError_t e = mnk::sw::check_geo(g);
  if (e != cudaSuccess) return (int)e;
  if (g.units <= 0) return (int)cudaSuccess;
  if (epi < mnk::kBias || epi > mnk::kRaw) return (int)cudaErrorInvalidValue;
  return nwg == 2 ? launch_bf16<2>(x, dw_w, dw_b, pw_w, pw_b, out, g, epi, stream)
                  : launch_bf16<1>(x, dw_w, dw_b, pw_w, pw_b, out, g, epi, stream);
}

// epi as above; plan: mg, th, tw, kp, split, cw, ns, ws, bs
// (ops/separable_block.f32_sep_plan)
int separable_block_f32(const void* x, const void* dw_w, const void* dw_b,
                        const void* pw_w, const void* pw_b, void* out, int N, int H,
                        int W, int Cin, int Cout, int stride, int relu6, int epi,
                        int mg, int th, int tw, int kp, int split, int cw, int ns, int ws,
                        int bs, void* stream) {
  const sf::Geo g = sf::make_geo(N, H, W, Cin, Cout, stride, relu6, epi,
                                 sf::Plan{mg, th, tw, kp, split, cw, ns, ws, bs});
  if (!sf::geo_ok(g) || epi < mnk::kBias || epi > mnk::kRaw) return (int)cudaErrorInvalidValue;
  using F = const float*;
  const sf::Ptrs p{(F)x, (F)dw_w, (F)dw_b, (F)pw_w, (F)pw_b, static_cast<float*>(out)};
  return launch_f32(g, p, stream);
}

// Dynamic shared memory of a float32 plan (ops/separable_block.f32_sep_smem_bytes
// mirrors it).
int separable_f32_smem_bytes(int mg, int th, int tw, int kp, int ns, int ws, int bs,
                             int stride) {
  const sf::Plan p{mg, th, tw, kp, 1, 8, ns, ws, bs};
  return sf::make_geo(1, 8, 8, 8, 8, stride, 1, 1, p).smem_bytes;
}

// Dynamic shared memory of a bf16 plan (the CPU tests mirror it).
int separable_bf16_smem_bytes(int nwg, int th, int tw, int kp, int ws, int bs, int stride) {
  const mnk::sw::Plan p{nwg, th, tw, kp, 1, 8, ws, bs};
  return mnk::sw::make_geo(1, 8, 8, 8, 8, stride, 1, p).smem_bytes;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
