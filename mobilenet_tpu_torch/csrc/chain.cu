// K stride-1 C->C separable blocks in one cooperative launch.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_chain_systolic.py
// chain_systolic (:120), which runs V1 blocks 6-10 (14x14x512, K=5) on the
// batch-1 route. Its output equals K per-block launches in sequence, bit for
// bit: every stage computes its tiles with the same separable_tile code
// (separable_tile.cuh) as separable_block.cu.
//
// What bounds it on an H100: at batch 1 each block is 1.3 MFLOP of depthwise
// and 51 MFLOP of pointwise work over 16 tiles, so a per-block launch leaves
// most SMs idle and pays a launch and a kernel boundary per block. Here one
// persistent grid runs all K stages; stage k+1 waits for stage k at a
// grid-wide barrier (cooperative_groups::this_grid().sync()), since blocks
// run in no order. The launch is cooperative so the whole grid is
// co-resident; its size is the tile count capped by what
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows. The activation
// between stages goes through two ping-pong scratch buffers that the caller
// allocates (200 KB per image at 14x14x512 bf16), which stay in L2. Keeping
// them in distributed shared memory across a thread-block cluster, and
// splitting tiles finer to occupy more SMs, are later work.
#include <cooperative_groups.h>

#include "separable_tile.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(mnk::THREADS)
    chain_kernel(const T* __restrict__ x, const T* __restrict__ dw_ws,
                 const T* __restrict__ dw_bs, const T* __restrict__ pw_ws,
                 const T* __restrict__ pw_bs, T* scratch0, T* scratch1, T* out,
                 mnk::BlockShape s, int K) {
  __shared__ __align__(128) unsigned char smem[mnk::TILE_SMEM_BYTES];
  cg::grid_group grid = cg::this_grid();
  const int C = s.Cin;
  const long long tiles = mnk::num_tiles(s);
  const T* src = x;
  for (int k = 0; k < K; ++k) {
    T* dst = (k == K - 1) ? out : ((k % 2 == 0) ? scratch0 : scratch1);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
      mnk::separable_tile<T, true>(src, dw_ws + (long long)k * 9 * C, dw_bs + (long long)k * C,
                             pw_ws + (long long)k * C * C, pw_bs + (long long)k * C,
                             dst, s, t, smem);
    if (k + 1 < K) grid.sync();
    src = dst;
  }
}

template <typename T>
int launch(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
           const void* pw_bs, void* scratch0, void* scratch1, void* out, int N, int H,
           int W, int C, int K, int relu6, void* stream) {
  mnk::BlockShape s = mnk::make_shape(N, H, W, C, C, 1, relu6);
  const long long tiles = mnk::num_tiles(s);
  if (tiles <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<T>,
                                                    mnk::THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long cap = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(tiles < cap ? tiles : cap);
  const T* xp = (const T*)x;
  const T* dwp = (const T*)dw_ws;
  const T* dbp = (const T*)dw_bs;
  const T* pwp = (const T*)pw_ws;
  const T* pbp = (const T*)pw_bs;
  T* s0 = (T*)scratch0;
  T* s1 = (T*)scratch1;
  T* op = (T*)out;
  void* args[] = {&xp, &dwp, &dbp, &pwp, &pbp, &s0, &s1, &op, &s, &K};
  e = cudaLaunchCooperativeKernel((const void*)chain_kernel<T>, dim3(blocks),
                                  dim3(mnk::THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int chain_bf16(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
               const void* pw_bs, void* scratch0, void* scratch1, void* out, int N,
               int H, int W, int C, int K, int relu6, void* stream) {
  return launch<__nv_bfloat16>(x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out,
                               N, H, W, C, K, relu6, stream);
}

int chain_f32(const void* x, const void* dw_ws, const void* dw_bs, const void* pw_ws,
              const void* pw_bs, void* scratch0, void* scratch1, void* out, int N,
              int H, int W, int C, int K, int relu6, void* stream) {
  return launch<float>(x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out, N, H,
                       W, C, K, relu6, stream);
}

}  // extern "C"
