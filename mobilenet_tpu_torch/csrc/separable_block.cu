// Fused depthwise 3x3 (+bias+act) -> pointwise 1x1 (+bias+act) block.
//
// Replaces the TPU kernels mobilenet_tpu/ops/pallas_block.py
// separable_block_pallas (:217), and the lane-packed
// ops/pallas_block_packed.py separable_block_packed (:132) and
// separable_block_packed_s2 (:371) and ops/pallas_block_packed_mxu.py
// separable_block_packed_mxu (:264): the packing existed only for the TPU's
// (8,128) vector tiles, so narrow blocks (C = 32/64) run this same dense
// NHWC kernel. pw_act = 0 is the packed kernels' pw_epilogue=False mode:
// the depthwise keeps its activation, the projection is bias only (the
// linear bottleneck of MobileNet-V2's t == 1 block 0).
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
// float32 (separable_tile.cuh): exact IEEE float32 by FMA on the CUDA cores,
// one 64-pixel x 128-channel tile a block (the verify path, unchanged).
#include "separable_tile.cuh"
#include "separable_wgmma.cuh"

namespace {

using mnk::sw::bf16;

template <bool kPwAct>
__global__ void __launch_bounds__(mnk::THREADS)
    separable_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                               const float* __restrict__ dw_b, const float* __restrict__ pw_w,
                               const float* __restrict__ pw_b, float* __restrict__ out,
                               mnk::BlockShape s) {
  __shared__ __align__(128) unsigned char smem[mnk::TILE_SMEM_BYTES];
  mnk::separable_tile<false, kPwAct>(x, dw_w, dw_b, pw_w, pw_b, out, s, blockIdx.x, smem);
}

template <int NWG, bool kPwAct>
__global__ void __launch_bounds__(mnk::sw::threads_of(NWG), 1)
    separable_block_bf16_kernel(const __grid_constant__ mnk::sw::Maps maps,
                                const mnk::sw::Launch l, const mnk::sw::Geo g) {
  extern __shared__ unsigned char smem_raw[];
  mnk::sw::run<NWG, kPwAct>(g, smem_raw, maps, l, [] {});
}

int launch_f32(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
               const void* pw_b, void* out, int N, int H, int W, int Cin, int Cout, int stride,
               int relu6, int pw_act, void* stream) {
  mnk::BlockShape s = mnk::make_shape(N, H, W, Cin, Cout, stride, relu6);
  long long tiles = mnk::num_tiles(s);
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // pw_act picks the instantiation: the activated epilogue has no runtime branch
  auto kernel = pw_act ? separable_block_f32_kernel<true> : separable_block_f32_kernel<false>;
  kernel<<<(unsigned)tiles, mnk::THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dw_w, (const float*)dw_b, (const float*)pw_w,
      (const float*)pw_b, (float*)out, s);
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_bf16(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                const void* pw_b, void* out, const mnk::sw::Geo& g, int pw_act, void* stream) {
  auto kernel = pw_act ? separable_block_bf16_kernel<NWG, true>
                       : separable_block_bf16_kernel<NWG, false>;
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
  const mnk::sw::Launch l{(const bf16*)dw_w, (const bf16*)dw_b, (const bf16*)pw_b, (bf16*)out,
                          nullptr, nullptr, 1};
  kernel<<<grid, threads, g.smem_bytes, (cudaStream_t)stream>>>(maps, l, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plan: nwg, th, tw, kp, split, cw, ws, bs (ops/separable_block.separable_plan)
int separable_block_bf16(const void* x, const void* dw_w, const void* dw_b,
                         const void* pw_w, const void* pw_b, void* out, int N, int H,
                         int W, int Cin, int Cout, int stride, int relu6, int pw_act,
                         int nwg, int th, int tw, int kp, int split, int cw, int ws, int bs,
                         void* stream) {
  const mnk::sw::Plan p{nwg, th, tw, kp, split, cw, ws, bs};
  const mnk::sw::Geo g = mnk::sw::make_geo(N, H, W, Cin, Cout, stride, relu6, p);
  cudaError_t e = mnk::sw::check_geo(g);
  if (e != cudaSuccess) return (int)e;
  if (g.units <= 0) return (int)cudaSuccess;
  return nwg == 2 ? launch_bf16<2>(x, dw_w, dw_b, pw_w, pw_b, out, g, pw_act, stream)
                  : launch_bf16<1>(x, dw_w, dw_b, pw_w, pw_b, out, g, pw_act, stream);
}

int separable_block_f32(const void* x, const void* dw_w, const void* dw_b,
                        const void* pw_w, const void* pw_b, void* out, int N, int H,
                        int W, int Cin, int Cout, int stride, int relu6, int pw_act,
                        void* stream) {
  return launch_f32(x, dw_w, dw_b, pw_w, pw_b, out, N, H, W, Cin, Cout, stride, relu6,
                    pw_act, stream);
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
