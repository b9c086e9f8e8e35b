// Standalone int8 depthwise 3x3 (TF-SAME, stride 1 or 2) + int32 bias +
// requant, int8 in and out.
//
// Replaces the TPU kernel mobilenet_tpu/quant/pallas_dw_i8.py
// depthwise_i8_pallas (:74), the per-layer int8 route that the int8 verify
// gate runs.
//
// What bounds it on an H100: memory. Per output element it does 9 int8
// multiply-adds and reads 1-4 bytes of new input (the 3x3 windows overlap),
// far below the card's ~295 operations per byte; the least time is the
// input read once plus the output written once, at 3.35 TB/s. The design:
// one thread per output pixel and 4-channel group, so a warp reads and
// writes 128 consecutive bytes of one pixel row as 32-bit words; the 9
// overlapping window reads of neighbouring pixels are served by L1/L2, so
// device memory sees each input byte about once. The arithmetic is the tile
// function of int8_tile.cuh, which the fused block kernel runs too.
#include "int8_tile.cuh"

namespace {

constexpr int DW_THREADS = 256;

__global__ void __launch_bounds__(DW_THREADS)
    depthwise_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ dw_w,
                        const int* __restrict__ dw_b, const float* __restrict__ dw_m,
                        int8_t* __restrict__ out, mnk::I8Shape s, float six_q) {
  const int groups = s.C / 4;
  const long long idx = (long long)blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= s.M * groups) return;
  const int c = int(idx % groups) * 4;
  const long long p = idx / groups;
  const mnk::DwQuad q = mnk::load_dw_quad(dw_w, dw_b, dw_m, s.C, c);
  *reinterpret_cast<uint32_t*>(out + p * s.C + c) =
      mnk::dw_quad(x, q, s, mnk::pixel_window(s, p), c, six_q);
}

}  // namespace

extern "C" {

int depthwise_i8(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
                 void* out, int N, int H, int W, int C, int stride, int relu6,
                 float six_q, void* stream) {
  const mnk::I8Shape s = mnk::make_i8_shape(N, H, W, C, C, stride, relu6);
  const long long threads = s.M * (C / 4);
  if (threads <= 0) return (int)cudaSuccess;
  const long long blocks = (threads + DW_THREADS - 1) / DW_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  depthwise_i8_kernel<<<(unsigned)blocks, DW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)dw_w, (const int*)dw_b, (const float*)dw_m,
      (int8_t*)out, s, six_q);
  return (int)cudaGetLastError();
}

}  // extern "C"
