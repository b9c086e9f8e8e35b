// Standalone float depthwise 3x3 (TF-SAME, stride 1 or 2) + bias + ReLU or
// ReLU6, NHWC, float32 or bf16 in and out, float32 accumulation.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_dw.py
// depthwise_conv_pallas (:112): the per-layer float route of MobileNet-V1
// ("dw" routing, the JAX package's "pallas") and the depthwise taps that
// the per-layer collect takes under "fused" routing.
//
// Arithmetic, as the TPU kernel's: out = act(sum over taps in (dy, dx)
// order of x * w, + bias), every step a float32 multiply then a float32 add
// (bf16 products are exact in float32, so there an fmaf rounds the same;
// float32 products are not, so there __fmul_rn, __fadd_rn: never contracted),
// the bias added after the sum, then max(., 0) and with relu6 min(., 6),
// rounded to the input dtype. The TPU kernel has no "no activation" mode;
// neither has this one. TF-SAME padding: the low pad is total // 2 (stride 2
// on an even input pads (0, 1); an odd input pads both sides).
//
// What bounds it on an H100: memory (9 multiply-adds an output element
// against 1-4 new input elements; the least time is the input read once and
// the output written once at 3.35 TB/s). The design is depthwise_ring.cuh's,
// shared with the int8 kernel: persistent blocks, each on one channel slice
// of up to 256 bytes, walk bands of output rows whose input windows a
// producer warp stages through a ring of shared-memory slots as TMA boxes
// (zeros off the image), while 8 consumer warps compute the slot before,
// each thread 16 bytes of channels (8 bf16, 4 float32) with its nine f32
// weight vectors and bias in registers for the whole kernel, sliding down
// its rows so that each input row is read from shared memory once.
#include "depthwise_ring.cuh"

extern "C" {

// plan: th, tw, seg, nv, ws (ops/depthwise.dw_plan); b may be null
int depthwise_f32(const void* x, const void* w, const void* b, void* out, int N, int H, int W,
                  int C, int stride, int relu6, int th, int tw, int seg, int nv, int ws,
                  void* stream) {
  const mnk::dwr::Args a{x, w, b, nullptr, out, relu6 ? 6.0f : INFINITY};
  return mnk::dwr::launch<mnk::dwr::OpFloat<float>>(a, N, H, W, C, stride, th, tw, seg, nv, ws,
                                                    stream);
}

int depthwise_bf16(const void* x, const void* w, const void* b, void* out, int N, int H,
                   int W, int C, int stride, int relu6, int th, int tw, int seg, int nv, int ws,
                   void* stream) {
  const mnk::dwr::Args a{x, w, b, nullptr, out, relu6 ? 6.0f : INFINITY};
  return mnk::dwr::launch<mnk::dwr::OpFloat<__nv_bfloat16>>(a, N, H, W, C, stride, th, tw, seg,
                                                            nv, ws, stream);
}

// Dynamic shared memory of a plan (ops/depthwise.dw_smem_bytes mirrors it).
int depthwise_smem_bytes(int elem, int stride, int th, int tw, int nv, int ws) {
  return mnk::dwr::make_geo(1, 8, 8, 8, elem, stride, th, tw, 1, nv, ws).smem_bytes;
}

}  // extern "C"
