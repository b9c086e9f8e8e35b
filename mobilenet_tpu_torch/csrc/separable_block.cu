// Fused depthwise 3x3 (+bias+act) -> pointwise 1x1 (+bias+act) block.
//
// Replaces the TPU kernels mobilenet_tpu/ops/pallas_block.py
// separable_block_pallas (:217), and the lane-packed
// ops/pallas_block_packed.py separable_block_packed (:132) and
// separable_block_packed_s2 (:371): the packing existed only for the TPU's
// (8,128) vector tiles, so narrow blocks (C = 32/64) run this same dense
// NHWC kernel. pw_act = 0 is the packed kernels' pw_epilogue=False mode:
// the depthwise keeps its activation, the projection is bias only (the
// linear bottleneck of MobileNet-V2's t == 1 block 0).
//
// What bounds it on an H100: at batch 256 the block is a bf16 GEMM of
// M = N*Ho*Wo pixels by K = Cin by Cout (13 to 26 GFLOP per block, ~290 for
// the 13 blocks of a forward), preceded by a memory-bound 9-tap stencil. The
// unfused pair writes and reads the depthwise tensor through device memory
// (up to 205 MB per batch-256 block, at 112x112x32 and 56x56x128); at the
// tensor cores' rate a block's product takes tens of microseconds, so that
// traffic would bound it. This kernel keeps the depthwise tile in shared memory
// (separable_tile.cuh) and reads the input tile from L2 once per output
// channel tile. The product runs on the tensor cores through WMMA fragments
// with no load pipelining: the simple first version. The depthwise stencil
// is recomputed once per 128-channel output tile (9/128 of the product's
// FMAs). TMA loads, wgmma and a persistent schedule are later work.
#include "separable_tile.cuh"

namespace {

template <typename T, bool kPwAct>
__global__ void __launch_bounds__(mnk::THREADS)
    separable_block_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                           const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                           const T* __restrict__ pw_b, T* __restrict__ out,
                           mnk::BlockShape s) {
  __shared__ __align__(128) unsigned char smem[mnk::TILE_SMEM_BYTES];
  mnk::separable_tile<T, false, kPwAct>(x, dw_w, dw_b, pw_w, pw_b, out, s, blockIdx.x, smem);
}

template <typename T>
int launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
           const void* pw_b, void* out, int N, int H, int W, int Cin, int Cout,
           int stride, int relu6, int pw_act, void* stream) {
  mnk::BlockShape s = mnk::make_shape(N, H, W, Cin, Cout, stride, relu6);
  long long tiles = mnk::num_tiles(s);
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // pw_act picks the instantiation: the activated epilogue has no runtime branch
  auto kernel = pw_act ? separable_block_kernel<T, true> : separable_block_kernel<T, false>;
  kernel<<<(unsigned)tiles, mnk::THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)dw_w, (const T*)dw_b, (const T*)pw_w, (const T*)pw_b,
      (T*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int separable_block_bf16(const void* x, const void* dw_w, const void* dw_b,
                         const void* pw_w, const void* pw_b, void* out, int N, int H,
                         int W, int Cin, int Cout, int stride, int relu6, int pw_act,
                         void* stream) {
  return launch<__nv_bfloat16>(x, dw_w, dw_b, pw_w, pw_b, out, N, H, W, Cin, Cout,
                               stride, relu6, pw_act, stream);
}

int separable_block_f32(const void* x, const void* dw_w, const void* dw_b,
                        const void* pw_w, const void* pw_b, void* out, int N, int H,
                        int W, int Cin, int Cout, int stride, int relu6, int pw_act,
                        void* stream) {
  return launch<float>(x, dw_w, dw_b, pw_w, pw_b, out, N, H, W, Cin, Cout, stride,
                       relu6, pw_act, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
