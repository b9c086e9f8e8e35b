// Fused int8 depthwise-separable block: dw 3x3 (TF-SAME, stride 1 or 2) +
// int32 bias + requant -> pointwise 1x1 s8 x s8 -> s32 + int32 bias +
// requant, int8 in and out, exact (equal, bit for bit, to quant/oracle.py).
//
// Replaces the TPU kernels mobilenet_tpu/quant/pallas_block_i8.py
// separable_block_i8 (:201) and the lane-packed
// quant/pallas_block_packed_i8.py separable_block_packed_i8 (:222, both
// strides): the packing existed only for the TPU's (8,128) vector tiles, so
// narrow blocks (C = 8..64) run this same dense NHWC kernel.
//
// What bounds it on an H100: memory, at all but the last blocks. At batch
// 256 (MobileNet-V1 1.0-224) a block's pointwise is 6.6 to 13.2 G int8
// multiply-adds (7 to 13 us at the tensor cores' 1,979 TOP/s), while its
// int8 input and output move 26 to 308 MB (8 to 92 us at 3.35 TB/s). The
// unfused pair would also write and read the depthwise tensor. The design
// (separable_i8_wgmma.cuh, on the PTX pieces of hopper.cuh) is the bf16
// kernel's plan with int8 operands: a persistent grid over units of a pixel tile x a
// part of Cout (ops/separable_block_i8.separable_i8_plan); TMA stages each
// unit's input window through a ring while the consumer warpgroups compute
// the depthwise once per pixel and channel (dp4a on byte-transposed taps,
// the requant's conversions on the full-rate adders) into a swizzled A panel
// (TM x Cin int8); the K-major pointwise weight streams through a second TMA
// ring into s8 wgmma (m64nNk32, s32 accumulators); the epilogue requantizes
// in registers. The product's integer sums are exact in any order.
//
// The linear mode (entry point separable_block_i8_linear) is the packed
// kernel's pw_linear=True: the pointwise requant is the V2 linear-bottleneck
// one, clamp(rint(float32(acc + bias) * m)), with no ReLU and no six_q
// (MobileNet-V2's t == 1 block 0). It is a second instantiation of the
// kernel template, not a runtime flag.
#include "separable_i8_wgmma.cuh"

namespace {

template <int NWG, bool kLinear>
__global__ void __launch_bounds__(mnk::si8::threads_of(NWG), 1)
    separable_block_i8_kernel(const __grid_constant__ mnk::si8::Maps maps,
                              const mnk::si8::Launch l, const mnk::si8::Geo g) {
  extern __shared__ unsigned char smem_raw[];
  mnk::si8::run<NWG, kLinear>(g, smem_raw, maps, l);
}

template <int NWG, bool kLinear>
int launch(const void* x, const void* pw_wt, const mnk::si8::Launch& l,
           const mnk::si8::Geo& g, void* stream) {
  auto kernel = separable_block_i8_kernel<NWG, kLinear>;
  const int threads = mnk::si8::threads_of(NWG);
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
  mnk::si8::Maps maps;
  if ((e = mnk::si8::make_x_map(&maps.x, x, g)) != cudaSuccess) return (int)e;
  if ((e = mnk::si8::make_w_maps(maps, pw_wt, g)) != cudaSuccess) return (int)e;
  const long long cap = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(g.units < cap ? g.units : cap);
  kernel<<<grid, threads, g.smem_bytes, (cudaStream_t)stream>>>(maps, l, g);
  return (int)cudaGetLastError();
}

template <bool kLinear>
int launch_plan(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
                const void* pw_wt, const void* pw_b, const void* pw_m, void* out, int N, int H,
                int W, int Cin, int Cout, int stride, int relu6, float dw_six_q,
                float pw_six_q, const mnk::sw::Plan& p, void* stream) {
  const mnk::si8::Geo g = mnk::si8::make_geo(N, H, W, Cin, Cout, stride, p);
  cudaError_t e = mnk::si8::check_geo(g);
  if (e != cudaSuccess) return (int)e;
  if (g.units <= 0) return (int)cudaSuccess;
  // the requants' upper bounds: min(six_q, 127) with ReLU6 (the linear mode
  // has no ReLU and no six_q), else 127
  const float dw_hi = relu6 ? fminf(dw_six_q, 127.0f) : 127.0f;
  const float pw_hi = relu6 && !kLinear ? fminf(pw_six_q, 127.0f) : 127.0f;
  const mnk::si8::Launch l{(const int8_t*)dw_w, (const int*)dw_b, (const int*)pw_b,
                           (const float*)dw_m, (const float*)pw_m, (int8_t*)out, dw_hi, pw_hi};
  switch (p.nwg) {
    case 4: return launch<4, kLinear>(x, pw_wt, l, g, stream);
    case 2: return launch<2, kLinear>(x, pw_wt, l, g, stream);
    default: return launch<1, kLinear>(x, pw_wt, l, g, stream);
  }
}

}  // namespace

extern "C" {

// pw_wt: the K-major (Cout, Cin) pointwise weight; Cin a multiple of 16.
// plan: nwg, th, tw, kp, split, cw, ws, bs (ops/separable_block_i8.separable_i8_plan)
int separable_block_i8(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
                       const void* pw_wt, const void* pw_b, const void* pw_m, void* out,
                       int N, int H, int W, int Cin, int Cout, int stride, int relu6,
                       float dw_six_q, float pw_six_q, int nwg, int th, int tw, int kp,
                       int split, int cw, int ws, int bs, void* stream) {
  const mnk::sw::Plan p{nwg, th, tw, kp, split, cw, ws, bs};
  return launch_plan<false>(x, dw_w, dw_b, dw_m, pw_wt, pw_b, pw_m, out, N, H, W, Cin, Cout,
                            stride, relu6, dw_six_q, pw_six_q, p, stream);
}

// The linear mode: pw_six_q is not read.
int separable_block_i8_linear(const void* x, const void* dw_w, const void* dw_b,
                              const void* dw_m, const void* pw_wt, const void* pw_b,
                              const void* pw_m, void* out, int N, int H, int W, int Cin,
                              int Cout, int stride, int relu6, float dw_six_q, float pw_six_q,
                              int nwg, int th, int tw, int kp, int split, int cw, int ws,
                              int bs, void* stream) {
  const mnk::sw::Plan p{nwg, th, tw, kp, split, cw, ws, bs};
  return launch_plan<true>(x, dw_w, dw_b, dw_m, pw_wt, pw_b, pw_m, out, N, H, W, Cin, Cout,
                           stride, relu6, dw_six_q, pw_six_q, p, stream);
}

// Dynamic shared memory of an int8 plan (the CPU tests mirror it).
int separable_i8_smem_bytes(int nwg, int th, int tw, int kp, int ws, int bs, int stride,
                            int cin) {
  const mnk::sw::Plan p{nwg, th, tw, kp, 1, 8, ws, bs};
  return mnk::si8::make_geo(1, 8, 8, cin, 8, stride, p).smem_bytes;
}

}  // extern "C"
