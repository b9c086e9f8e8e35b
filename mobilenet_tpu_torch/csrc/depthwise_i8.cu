// Standalone int8 depthwise 3x3 (TF-SAME, stride 1 or 2) + int32 bias +
// requant, int8 in and out, exact (equal, bit for bit, to quant/ops.py).
//
// Replaces the TPU kernel mobilenet_tpu/quant/pallas_dw_i8.py
// depthwise_i8_pallas (:74), the per-layer int8 route that the int8 verify
// gate runs.
//
// What bounds it on an H100: memory (9 int8 multiply-adds an output element
// against 1-4 new input bytes; the least time is the input read once and the
// output written once at 3.35 TB/s). The design is depthwise_ring.cuh's,
// shared with the float kernel: persistent blocks, each on one channel
// slice, walk bands of output rows whose input windows a producer warp
// stages through a ring of shared-memory slots (TMA boxes, zeros off the
// image; cp.async granules where C % 16 == 8, which a TMA map cannot
// stride), while 8 consumer warps compute the slot before, each thread 16
// channels with its weights held in registers for the whole kernel, sliding
// down its rows so that each input row is read from shared memory once. The
// arithmetic is int8_tile.cuh's depthwise stage, the one the fused int8
// block runs: dp4a over byte-transposed taps from the bias, the requant's
// conversions by the 1.5 * 2^23 magic number (__int2float_rn for a group
// with a bias beyond 2^21).
#include "depthwise_ring.cuh"

extern "C" {

// plan: th, tw, seg, nv, ws (ops/depthwise.dw_plan at 1 byte an element)
int depthwise_i8(const void* x, const void* dw_w, const void* dw_b, const void* dw_m,
                 void* out, int N, int H, int W, int C, int stride, int relu6, float six_q,
                 int th, int tw, int seg, int nv, int ws, void* stream) {
  const mnk::dwr::Args a{x, dw_w, dw_b, (const float*)dw_m, out,
                         relu6 ? fminf(six_q, 127.0f) : 127.0f};
  return mnk::dwr::launch<mnk::dwr::OpI8>(a, N, H, W, C, stride, th, tw, seg, nv, ws, stream);
}

}  // extern "C"
