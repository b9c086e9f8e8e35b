// Fused MobileNet-V3 bottleneck:
//   expand 1x1 + bias + act (or the identity, no activation) -> depthwise
//   k x k (k = 3 or 5, stride 1 or 2, TF-SAME) + bias + act -> [squeeze-excite
//   gate] -> linear projection 1x1 + bias [+ residual].
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_ir_v3.py v3_block_pallas
// (:414), which runs the V3 bottlenecks, and on MobileNet-V3-Large 1.0-224
// also takes blocks 0 and 1, which the JAX package sends to the lane-packed
// separable_block_packed (linear mode + a residual add) and
// expand_block_packed_s2: every block of V3-Large is one call of this kernel.
// MobileNet-V2's blocks 1-16 (ops/inverted_residual.py: ReLU6, k 3, no SE)
// run it too, in both dtypes, in place of pallas_ir_block.py
// inverted_residual_pallas (:364) and pallas_expand_s2.py
// expand_block_packed_s2 (:238). Activations (numerics.cuh act_named): relu,
// relu6, hswish.
//
// Numerics (pallas_ir_v3.py _v3_kernel :244-312, _se_gate :206-219): the
// expansion accumulates in f32, adds its bias in f32, applies its activation
// and rounds to the activation dtype (the identity expansion of block 0 passes
// the input through); the k*k taps sum in f32 in dy-then-dx order, + bias, act,
// unrounded; the SE pool is the f32 sum over the Ho x Wo outputs times
// 1/(Ho*Wo), rounded to the dtype, then an f32 product + b1, relu, rounded,
// an f32 product + b2, and the hard sigmoid clip(g + 3, 0, 6) * (1/6) in f32;
// the activation is multiplied by that gate in f32 and rounded; the projection
// accumulates in f32, adds its bias in f32, rounds; the residual is added
// after that, in the activation dtype. TF-SAME pads the EXPANDED activation
// with zeros: (k-1)/2 on each side at stride 1, (k-2)/2 low and the rest high
// at stride 2 on an even input ((0, 1) at k 3, (1, 2) at k 5).
//
// bf16 (v3_wgmma.cuh, the plan of ops/v3_block.v3_wgmma_plan): a
// persistent grid over units of an output tile of one image x a part of
// Cout. The tile's input window arrives by TMA (a ring of whole windows);
// the expanded channels are walked in chunks of 64 whose expand and
// projection weights stream through a TMA ring; the expansion and the
// projection run on wgmma with f32 accumulators in registers (the
// projection's live across the chunks), the expansion's epilogue rounds
// into a bf16 expanded tile in shared memory, the depthwise reads it and
// rounds into the projection's A panel. Two consumer warpgroups and a
// producer warpgroup (its warps run the two rings). The expanded tensor
// never reaches device memory. Channels past E in the last chunk are zero
// in the expansion and the depthwise, add nothing to the projection and
// are never pooled.
//
// float32 (v3_f32.cuh, the plan of ops/v3_block.v3_plan): the same
// persistent units (an output tile, every output channel) on the CUDA cores:
// a producer warp stages the tile's in-image input pixels and each 32-channel
// chunk of E's weights by cp.async into mbarrier rings; the expansion and the
// projection are register-blocked fmaf products (4 pixels x 4 channels a
// thread, float4 operands), the expansion into an f32 expanded tile, the
// depthwise from it with a tap row's weights in registers, the projection's
// accumulators live across the chunks. Exact IEEE float32 (no tensor core).
//
// The squeeze-excite gate is a reduction over the whole image in the middle
// of the block, which one tile cannot see. A block with SE runs two passes
// of its tile loop (design (a); one block an image, design (b), needs the
// whole input image and an f32 output accumulator in shared memory: 275 KB
// at V3-Large's block 3, over the 227 KB limit):
//   pass 1: expand -> depthwise -> act per tile, and each tile's
//     per-channel f32 sums of its outputs in a fixed order into a scratch
//     `partial` (N x tiles x E f32); nothing else is written;
//   then the image's gate: its tiles' sums in tile order, the two SE
//     products and the hard sigmoid (bf16: once an image, by a launch of
//     its own into N x E f32; float32: by each unit of pass 2 into shared
//     memory, once for consecutive units of one image);
//   pass 2: bf16: the tile loop again with the gate applied before the
//     projection (pass 2 alone splits Cout); float32: pass 1 also stores
//     the depthwise's f32 output, and pass 2 projects it, gated, alone.
// The pooled sum is deterministic (no atomics) and the expanded tensor still
// never reaches device memory; bf16 SE blocks pay the expansion and
// depthwise twice.
//
// What bounds it on an H100: V3-Large 1.0-224 at batch 256 does ~100 GFLOP
// of products over its 15 blocks; the blocks at 112-28 squared are bound by
// their bytes (inputs and outputs once at 3.35 TB/s), those at 14 and 7
// squared by their operations (989 TFLOP/s bf16): 0.24 ms the sum of the
// blocks' bounds.
//
// The tile loops live in v3_wgmma.cuh and v3_f32.cuh, which the chain
// kernel (v3_chain.cu) shares.
#include "v3_f32.cuh"
#include "v3_wgmma.cuh"

namespace {

namespace f = mnk::v3f;

template <int K>
__global__ void __launch_bounds__(f::THREADS, 1)
    v3_f32_kernel(const __grid_constant__ f::Geo g, const f::Ptrs p, int pool) {
  extern __shared__ __align__(128) unsigned char smem_f32[];
  f::setup(smem_f32);
  f::Ring wr, br;
  f::run_pass<K>(g, p, smem_f32, pool != 0, wr, br);
}

// Pass 1 of an SE block (the per-tile sums), then the block's output, on a
// persistent grid of at most the co-resident blocks.
int launch_f32(const f::Geo& g, const f::Ptrs& p, void* stream) {
  const auto kernel = g.K == 3 ? v3_f32_kernel<3> : v3_f32_kernel<5>;
  static int smem_set[2] = {0, 0};  // per instantiation: the opt-in granted so far
  int& set = smem_set[g.K == 3 ? 0 : 1];
  cudaError_t e;
  if (g.smem_bytes > set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f::SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    set = f::SMEM_LIMIT;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, f::THREADS, g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long units = (long long)g.N * g.tiles_img, cap = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(units < cap ? units : cap);
  cudaStream_t st = (cudaStream_t)stream;
  if (g.Se > 0) {
    kernel<<<grid, f::THREADS, g.smem_bytes, st>>>(g, p, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  kernel<<<grid, f::THREADS, g.smem_bytes, st>>>(g, p, 0);
  return (int)cudaGetLastError();
}

namespace w = mnk::v3w;

__global__ void __launch_bounds__(w::THREADS, 1)
    v3_wgmma_kernel(const __grid_constant__ w::Maps maps, const w::Ptrs p, const w::Geo g,
                    int pool) {
  extern __shared__ unsigned char smem_raw[];
  const w::Rings r = w::rings_of(g, w::setup_smem(smem_raw));
  w::by_role([&](auto consumer) {
    w::Ring wring, bring;
    w::run_pass<decltype(consumer)::value>(g, r, &maps, p, pool != 0, wring, bring);
  });
}

// Each image's SE gate from pass 1's sums: one block an image.
constexpr int GATE_THREADS = 512;
__global__ void __launch_bounds__(GATE_THREADS) v3_gate_kernel(const w::Ptrs p, const w::Geo g) {
  extern __shared__ float gate_smem[];
  w::se_gate(g, p, blockIdx.x, gate_smem, threadIdx.x, GATE_THREADS, [] { __syncthreads(); });
}

int launch_bf16(const void* x, const void* ew, const void* eb, const void* dw, const void* db,
                const void* pw, const void* pb, const w::Ptrs& p, const w::Geo& g, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(v3_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v3_wgmma_kernel, w::THREADS,
                                                    g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  w::Maps maps;
  if ((e = w::make_maps(maps, x, ew, eb, dw, db, pw, pb, p.gate, g)) != cudaSuccess)
    return (int)e;
  const long long cap = (long long)per_sm * sms;
  const auto grid = [&](bool pool) {
    const long long units = w::units_of(g, pool);
    return (unsigned)(units < cap ? units : cap);
  };
  cudaStream_t st = (cudaStream_t)stream;
  if (g.Se > 0) {
    v3_wgmma_kernel<<<grid(true), w::THREADS, g.smem_bytes, st>>>(maps, p, g, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    v3_gate_kernel<<<g.N, GATE_THREADS, w::gate_floats(g.E, g.Se) * sizeof(float), st>>>(p, g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  v3_wgmma_kernel<<<grid(false), w::THREADS, g.smem_bytes, st>>>(maps, p, g, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// partial: pass 1's sums (N x tiles x E f32) then the gates (N x E f32),
// SE blocks only; plan: th, tw, split, cw, ws, bs (ops/v3_block.v3_wgmma_plan).
int v3_block_bf16(const void* x, const void* ew, const void* eb, const void* dw,
                  const void* db, const void* pw, const void* pb, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* partial, void* out,
                  int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                  int act_exp, int act, int residual, int identity, int th, int tw, int split,
                  int cw, int ws, int bs, void* stream) {
  const w::Geo g = w::make_geo(N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                               identity, w::Plan{th, tw, split, cw, ws, bs});
  if (!w::geo_ok(g)) return (int)cudaErrorInvalidValue;
  if ((!identity && (ew == nullptr || eb == nullptr)) ||
      (Se > 0 && (w1 == nullptr || b1 == nullptr || w2 == nullptr || b2 == nullptr ||
                  partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  using bf16 = w::bf16;
  float* part = static_cast<float*>(partial);
  const w::Ptrs p{(const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                  (bf16*)out, part,
                  part == nullptr ? nullptr : part + (long long)N * g.tiles_img * E};
  return launch_bf16(x, ew, eb, dw, db, pw, pb, p, g, stream);
}

// partial: pass 1's sums (N x tiles x E f32) then its pre-gate tensor (N x
// Ho x Wo x E f32), SE blocks only; plan: th, tw, ws, bs (ops/v3_block.v3_plan).
int v3_block_f32(const void* x, const void* ew, const void* eb, const void* dw,
                 const void* db, const void* pw, const void* pb, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* partial, void* out,
                 int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                 int act_exp, int act, int residual, int identity, int th, int tw, int ws,
                 int bs, void* stream) {
  const f::Geo g = f::make_geo(N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                               identity, f::Plan{th, tw, ws, bs});
  if (!f::geo_ok(g) || (long long)N * g.tiles_img > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((!identity && (ew == nullptr || eb == nullptr)) ||
      (Se > 0 && (w1 == nullptr || b1 == nullptr || w2 == nullptr || b2 == nullptr ||
                  partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  using F = const float*;
  float* part = static_cast<float*>(partial);
  const f::Ptrs p{(F)x, (F)ew, (F)eb, (F)dw, (F)db, (F)pw, (F)pb, (F)w1, (F)b1, (F)w2, (F)b2,
                  part, part == nullptr ? nullptr : part + (long long)N * g.tiles_img * E,
                  static_cast<float*>(out)};
  return launch_f32(g, p, stream);
}

// Dynamic shared memory of a float32 plan (ops/v3_block.v3_smem_bytes
// mirrors it).
int v3_f32_smem_bytes(int th, int tw, int H, int W, int Cin, int E, int Cout, int Se, int K,
                      int stride, int ws, int bs, int identity) {
  return f::make_geo(1, H, W, Cin, E, Cout, Se, K, stride, mnk::kRelu, mnk::kRelu, 0, identity,
                     f::Plan{th, tw, ws, bs})
      .smem_bytes;
}

// Dynamic shared memory of a bf16 plan (ops/v3_block.v3_wgmma_smem_bytes
// mirrors it).
int v3_wgmma_smem_bytes(int th, int tw, int Cin, int E, int Cout, int K, int stride, int cw,
                        int ws, int bs, int identity) {
  return w::make_geo(1, 16, 16, Cin, E, Cout, 0, K, stride, mnk::kRelu, mnk::kRelu, 0, identity,
                     w::Plan{th, tw, Cout / cw, cw, ws, bs})
      .smem_bytes;
}

}  // extern "C"
