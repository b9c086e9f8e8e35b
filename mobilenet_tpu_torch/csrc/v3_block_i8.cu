// Fused int8 MobileNet-V3 bottleneck, one call, int8 in and int8 out, exact
// (equal, bit for bit, to quant/v3.py's oracle sequence):
//   expand 1x1 s8 x s8 -> s32 + int32 bias -> named requant (relu, relu6
//     or hswish), or the identity with no activation (block 0: no expansion)
//   -> depthwise k x k (k = 3 or 5, stride 1 or 2, TF-SAME) in exact int32
//      taps + int32 bias -> named requant
//   -> [quantized squeeze-excite: the int32 sum of the requantized depthwise
//      output over the Ho x Wo image, times f32(1/(Ho*Wo)), rint, clamp;
//      g1 = relu requant of an int dot + bias; acc2 = int dot + bias; gate
//      = clip(f32(acc2) * a2 + 3, 0, 6) * f32(1/6); out = clamp(rint(f32(z)
//      * gate))]
//   -> projection 1x1 s8 x s8 -> s32 + int32 bias -> LINEAR requant
//   [-> residual: clamp(int32(projection) + int32(x), -128, 127)].
// The named requant, folded order (quant/v3.py FOLDED_REQUANT):
//   relu, linear: clamp(rint(f32(acc) * m), 0 or -128, 127), m = f32(a) * f32(inv_s);
//   hswish: v = f32(acc) * a; t = clip(v + 3, 0, 6);
//           clamp(rint((v * t) * m6), -128, 127), m6 = f32(inv_s) * f32(1/6);
// and MobileNet-V2's ReLU6 (quant/ops.requantize): v = f32(acc) * m;
//   clamp(rint(clamp(v, 0, six_q)), -128, 127), six_q = f32(6) / f32(s_out)
//   per layer: the relu requant with the upper bound f32(min(six_q, 127))
//   in place of 127 (rint is monotone and leaves integers fixed).
// Every f32 step is __fmul_rn / __fadd_rn, so no multiply-add contraction
// can round once where numpy rounds twice; the rounding adds 1.5 x 2^23
// (half to even); the library is built without --use_fast_math. The host
// computes m, m6, the gate's f32(1/6) and the pool's f32(1/(Ho*Wo)) in numpy
// float32 and passes them in; the kernel never recomputes a constant.
//
// Runs MobileNet-V2's int8 inverted-residual blocks 1-16 (ReLU6, k 3, no
// SE; ops/inverted_residual_i8.py), which replace the TPU kernels
// mobilenet_tpu/quant/pallas_ir_i8.py inverted_residual_pallas_i8 (:237),
// quant/pallas_expand_s2_i8.py expand_block_packed_s2_i8 (:163, block 1) and
// the V2 bridge form of pallas_ir_v3_i8.py v3_block_pallas_i8 (block 13).
// Replaces four TPU kernels of MobileNet-V3's int8 paths:
//   mobilenet_tpu/quant/pallas_ir_v3_i8.py v3_block_pallas_i8 (:290), its V3
//     forms (hswish, k 5, the quantized SE; V3-L blocks 2-14, V3-S 1-10);
//   quant/pallas_block_packed_i8.py packed_block_i8_named (:436), V3-L block
//     0: the identity expansion at stride 1 (the residual, which the JAX
//     package adds outside the kernel, is this kernel's epilogue);
//   quant/pallas_block_packed_i8.py packed_block_i8_named_s2 (:632), V3-L
//     block 1, together with the XLA expansion packed_expand_i8_named before
//     it: here the expansion at stride 2 is the kernel's own;
//   quant/pallas_block_packed_i8.py packed_block_i8_named_s2_se (:821), V3-S
//     block 0: the identity at stride 2 with the quantized SE.
// Lane packing, bf16 integer carriage, the kron block-diagonal weights and
// the 128-column projection padding were the TPU's (8,128) layout; here
// activations stay int8 NHWC and a tile expands each window pixel once.
//
// Design: the Hopper tile of v3_i8_wgmma.cuh (its header), on the plan of
// ops/v3_block_i8.v3_i8_wgmma_plan: a persistent grid over units of an
// output tile x a part of Cout; TMA rings of whole input windows and of
// 128-channel chunks of E's weights; s8 wgmma expansion and projection; the
// dp4a depthwise from an int8 expanded tile in shared memory. The expanded
// tensor never reaches device memory. A block with SE runs three launches:
// pass 1 writes the int8 pre-gate tensor (exact, so pass 2 need not expand
// again) and the channel sums, the gate launch computes each image's gate
// once, and pass 2 gates that tensor and projects it.
//
// What bounds it on an H100: bytes. At batch 256 the 15 blocks of
// MobileNet-V3-Large 1.0-224 move their int8 activations once (~0.4 GB,
// ~0.12 ms at 3.35 TB/s) and do ~0.1 T int8 operations (~0.05 ms at 1,979
// TOP/s); the SE blocks' pre-gate tensors add ~0.15 GB written and read once
// (most of it within the 50 MB L2).
#include "v3_i8_wgmma.cuh"

namespace {

namespace v = mnk::v3i8;

template <int K, int MODE>
__global__ void __launch_bounds__(v::THREADS, 1)
    v3_i8_kernel(const __grid_constant__ v::Maps maps, const v::Ptrs p, const v::Geo g,
                 const int* __restrict__ pb, float m6_exp, float m6_dw) {
  extern __shared__ unsigned char smem_raw[];
  const v::Rings r = v::rings_of(g, mnk::v3w::setup_smem(smem_raw));
  const bool magic = MODE != v::kPool && v::pw_magic(g, pb);
  v::run<K, MODE>(g, r, &maps, p, m6_exp, m6_dw, magic);
}

// The images' SE gates from pass 1's channel sums, GATE_IMGS images a
// block: pooled = clamp(rint(f32(sum) * hw_inv)); g1 = relu requant of
// pooled @ w1 + b1; acc2 = g1 @ w2 + b2; gate = clip(f32(acc2) * a2 + 3, 0,
// 6) * sixth. A thread of a product takes 4 output columns of a segment of
// its input for the block's images (one 4-byte weight load for 16
// multiply-adds); the segments' int32 sums meet in shared memory by atomics
// (exact in any order).
constexpr int GATE_THREADS = 512, GATE_IMGS = 4;

struct Gate {
  const int* pooled;
  const int8_t* w1;
  const int* b1;
  const float* m1;
  const int8_t* w2;
  const int* b2;
  const float* a2;
  float* gate;
  int N, E, Se;
  float hw_inv, sixth;
};

// Shared memory of the gate launch: the images' pooled rows and second
// sums (E each), their hidden rows and first sums (Se each), int32.
__host__ __device__ inline int gate_bytes(int E, int Se) {
  return 2 * GATE_IMGS * (E + Se) * (int)sizeof(int);
}

// out[c][i] += sum over r in [r0, r1) of in[r][i] * w[r * ld + c], for the
// 4 columns at c0 and the GATE_IMGS images i, into shared memory.
__device__ __forceinline__ void gate_product(const int* in, const int8_t* __restrict__ w,
                                             int ld, int r0, int r1, int c0, int* out) {
  int a[GATE_IMGS][4] = {};
#pragma unroll 8  // eight weight loads in flight
  for (int r = r0; r < r1; ++r) {
    const uint32_t wv = __ldg(reinterpret_cast<const uint32_t*>(w + (long long)r * ld + c0));
    const int4 v = *reinterpret_cast<const int4*>(in + r * GATE_IMGS);
    const int vi[GATE_IMGS] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int wc = (int)(int8_t)(wv >> (8 * c));
#pragma unroll
      for (int i = 0; i < GATE_IMGS; ++i) a[i][c] += vi[i] * wc;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < GATE_IMGS; ++i) atomicAdd(out + (c0 + c) * GATE_IMGS + i, a[i][c]);
}

__global__ void __launch_bounds__(GATE_THREADS) v3_i8_gate_kernel(const Gate a) {
  static_assert(GATE_IMGS == 4, "a row of images is one int4");
  extern __shared__ int gate_smem[];
  const int E = a.E, Se = a.Se, tid = threadIdx.x, n0 = blockIdx.x * GATE_IMGS;
  const int imgs = min(GATE_IMGS, a.N - n0);
  int* pooled = gate_smem;                 // E x GATE_IMGS
  int* acc2 = pooled + E * GATE_IMGS;      // E x GATE_IMGS
  int* hidden = acc2 + E * GATE_IMGS;      // Se x GATE_IMGS
  int* acc1 = hidden + Se * GATE_IMGS;     // Se x GATE_IMGS
  for (int q = tid; q < E * GATE_IMGS; q += GATE_THREADS) {
    const int e = q / GATE_IMGS, i = q - e * GATE_IMGS;
    int v = 0;
    if (i < imgs) {
      const float f = rintf(__fmul_rn(__int2float_rn(a.pooled[(long long)(n0 + i) * E + e]),
                                      a.hw_inv));
      v = int(fminf(fmaxf(f, -128.0f), 127.0f));
    }
    pooled[q] = v;
    acc2[q] = 0;
  }
  for (int q = tid; q < Se * GATE_IMGS; q += GATE_THREADS) acc1[q] = 0;
  __syncthreads();
  const int cols1 = Se / 4, segs1 = max(1, min(E, GATE_THREADS / cols1));
  const int len1 = (E + segs1 - 1) / segs1;
  for (int q = tid; q < segs1 * cols1; q += GATE_THREADS) {
    const int sg = q / cols1, c0 = 4 * (q - sg * cols1);
    gate_product(pooled, a.w1, Se, sg * len1, min(E, (sg + 1) * len1), c0, acc1);
  }
  __syncthreads();
  for (int q = tid; q < Se * GATE_IMGS; q += GATE_THREADS) {
    const int j = q / GATE_IMGS;
    const float f = rintf(__fmul_rn(__int2float_rn(acc1[q] + a.b1[j]), a.m1[j]));
    hidden[q] = int(fminf(fmaxf(f, 0.0f), 127.0f));
  }
  __syncthreads();
  const int cols2 = E / 4, segs2 = max(1, min(Se, GATE_THREADS / cols2));
  const int len2 = (Se + segs2 - 1) / segs2;
  for (int q = tid; q < segs2 * cols2; q += GATE_THREADS) {
    const int sg = q / cols2, c0 = 4 * (q - sg * cols2);
    gate_product(hidden, a.w2, E, sg * len2, min(Se, (sg + 1) * len2), c0, acc2);
  }
  __syncthreads();
  for (int q = tid; q < E * GATE_IMGS; q += GATE_THREADS) {
    const int e = q / GATE_IMGS, i = q - e * GATE_IMGS;
    if (i >= imgs) continue;
    const float y = __fmul_rn(__int2float_rn(acc2[q] + a.b2[e]), a.a2[e]);
    a.gate[(long long)(n0 + i) * E + e] =
        __fmul_rn(fminf(fmaxf(__fadd_rn(y, 3.0f), 0.0f), 6.0f), a.sixth);
  }
}

// The SMs of the current device (the grids' size), asked once a device.
int sm_count(int* sms) {
  static int count[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (count[dev] == 0 &&
      (e = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)e;
  *sms = count[dev];
  return 0;
}

// What a launch keeps between calls (ops/v3_block_i8.py keeps one per
// argument key): each pass's geometry and its maps of the weights, the
// weights' pointers, the gate's arguments and the requant operands. The maps
// of x, the gates and the pre-gate tensor, which name a call's buffers, are
// made at each launch.
struct Prepared {
  v::Maps maps[3];  // by pass: kFull, kPool, kGated
  v::Geo geo[3];
  v::Tensors t;     // x, gate and zs null
  Gate gate;        // pooled and gate null
  float m6_exp, m6_dw;
  int K;
};

// A Prepared in a caller's buffer of v3_block_i8_prepared_bytes() bytes.
Prepared* prepared_in(const void* buf) {
  const uintptr_t a = alignof(Prepared);
  return reinterpret_cast<Prepared*>((reinterpret_cast<uintptr_t>(buf) + a - 1) & ~(a - 1));
}

int prepare(Prepared* P, const void* ewt, const void* eb, const void* em, const void* dwt,
            const void* db, const void* dm, const void* pwt, const void* pb, const void* pm,
            const void* sw1, const void* sb1, const void* sm1, const void* sw2,
            const void* sb2, const void* sa2, int N, int H, int W, int Cin, int E, int Cout,
            int Se, int K, int stride, int act_exp, int act, int residual, int identity, int th,
            int tw, int split, int cw, int ws, int bs, float m6_exp, float m6_dw, float hw_inv,
            float sixth) {
  const v::Plan plan{th, tw, split, cw, ws, bs};
  for (int mode : {v::kFull, v::kPool, v::kGated})
    P->geo[mode] = v::make_geo(N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                               identity, mode, plan);
  if ((!identity && (ewt == nullptr || eb == nullptr || em == nullptr)) || Se % 4 != 0 ||
      (Se > 0 && (sw1 == nullptr || sb1 == nullptr || sm1 == nullptr || sw2 == nullptr ||
                  sb2 == nullptr || sa2 == nullptr)) ||
      (K != 3 && K != 5) || (long long)N * P->geo[v::kFull].tiles_img * split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  P->t = v::Tensors{nullptr, ewt, eb, em, dwt, db, dm, pwt, pb, pm, nullptr, nullptr};
  P->gate = Gate{nullptr, (const int8_t*)sw1, (const int*)sb1, (const float*)sm1,
                 (const int8_t*)sw2, (const int*)sb2, (const float*)sa2, nullptr, N, E, Se,
                 hw_inv, sixth};
  P->m6_exp = m6_exp;
  P->m6_dw = m6_dw;
  P->K = K;
  for (int mode : {v::kFull, v::kPool, v::kGated}) {
    if ((mode == v::kFull) != (Se == 0)) continue;  // SE blocks: pass 1 and pass 2
    if (!v::geo_ok(P->geo[mode])) return (int)cudaErrorInvalidValue;
    const cudaError_t e = v::make_weight_maps(P->maps[mode], P->t, P->geo[mode]);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// One pass: the call's maps beside the kept ones, the opt-in to its shared
// memory (once an instantiation), a persistent grid of one block an SM (384
// threads of 168 registers fill an SM's 64 K) for each unit.
template <int K, int MODE>
int launch_pass(const Prepared& P, const v::Tensors& t, const v::Ptrs& p, cudaStream_t st) {
  const v::Geo& g = P.geo[MODE];
  const auto kernel = v3_i8_kernel<K, MODE>;
  static bool opted_in = false;
  cudaError_t e = cudaSuccess;
  if (!opted_in) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             v::SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  int sms = 0;
  if (const int code = sm_count(&sms)) return code;
  v::Maps maps = P.maps[MODE];
  if ((e = v::make_call_maps(maps, t, g)) != cudaSuccess) return (int)e;
  const long long units = v::units_of(g), cap = sms;
  kernel<<<(unsigned)(units < cap ? units : cap), v::THREADS, g.smem_bytes, st>>>(
      maps, p, g, (const int*)P.t.pb, P.m6_exp, P.m6_dw);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const Prepared& P, const v::Tensors& t, const v::Ptrs& p, const Gate& gate,
             cudaStream_t st) {
  if (gate.Se == 0) return launch_pass<K, v::kFull>(P, t, p, st);
  const v::Geo& pool = P.geo[v::kPool];
  cudaError_t e = cudaMemsetAsync(p.pooled, 0, sizeof(int) * (size_t)pool.N * pool.E, st);
  if (e != cudaSuccess) return (int)e;
  int code = launch_pass<K, v::kPool>(P, t, p, st);
  if (code != 0) return code;
  const int bytes = gate_bytes(gate.E, gate.Se);
  static bool gate_opted_in = false;
  if (!gate_opted_in) {
    if ((e = cudaFuncSetAttribute(v3_i8_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  v::SMEM_LIMIT)) != cudaSuccess)
      return (int)e;
    gate_opted_in = true;
  }
  v3_i8_gate_kernel<<<(pool.N + GATE_IMGS - 1) / GATE_IMGS, GATE_THREADS, bytes, st>>>(gate);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_pass<3, v::kGated>(P, t, p, st);
}

// A prepared launch on a call's input, SE scratch and output.
int run(const Prepared& P, const void* x, void* pooled, void* gate, void* zs, void* out,
        cudaStream_t st) {
  if (P.gate.Se > 0 && (pooled == nullptr || gate == nullptr || zs == nullptr))
    return (int)cudaErrorInvalidValue;
  v::Tensors t = P.t;
  t.x = x;
  t.gate = gate;
  t.zs = zs;
  const v::Ptrs p{(const int8_t*)x, (int8_t*)out, (int8_t*)zs, (int*)pooled};
  Gate gt = P.gate;
  gt.pooled = (const int*)pooled;
  gt.gate = (float*)gate;
  return P.K == 3 ? launch_k<3>(P, t, p, gt, st) : launch_k<5>(P, t, p, gt, st);
}

}  // namespace

extern "C" {

// x (N, H, W, Cx) int8, Cx = Cin rounded up to 16; ewt (E, Cx) and pwt
// (Cout, Ep) the K-major weight copies, Ep = E rounded up to 16; dwt (k*k/4
// + 1, E) int32 the depthwise table (ops/v3_block_i8.v3_i8_kernel_weights);
// eb, db, pb int32 and em, dm, pm f32 (the named requant's factor: "a" for
// hswish, else "m") per channel; m6_exp, m6_dw: hswish's m6, or relu's and
// relu6's upper bound (127, or f32(min(six_q, 127))); the SE layers' w, b and m (se1) or a (se2);
// SE scratch: pooled (N x E int32), gate (N x E f32), zs (N x Ho x Wo x Ep
// int8); plan: th, tw, split, cw, ws, bs (ops/v3_block_i8.v3_i8_wgmma_plan).
// One call: v3_block_i8_prepare, then v3_block_i8_run.
int v3_block_i8(const void* x, const void* ewt, const void* eb, const void* em, const void* dwt,
                const void* db, const void* dm, const void* pwt, const void* pb, const void* pm,
                const void* sw1, const void* sb1, const void* sm1, const void* sw2,
                const void* sb2, const void* sa2, void* pooled, void* gate, void* zs, void* out,
                int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                int act_exp, int act, int residual, int identity, int th, int tw, int split,
                int cw, int ws, int bs, float m6_exp, float m6_dw, float hw_inv, float sixth,
                void* stream) {
  Prepared P;
  const int code = prepare(&P, ewt, eb, em, dwt, db, dm, pwt, pb, pm, sw1, sb1, sm1, sw2, sb2,
                           sa2, N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                           identity, th, tw, split, cw, ws, bs, m6_exp, m6_dw, hw_inv, sixth);
  return code != 0 ? code : run(P, x, pooled, gate, zs, out, (cudaStream_t)stream);
}

// Bytes of a caller's buffer for a prepared launch.
int v3_block_i8_prepared_bytes() { return (int)(sizeof(Prepared) + alignof(Prepared)); }

// v3_block_i8's checks, geometry and weight maps into buf (the arguments of
// v3_block_i8 but x, the SE scratch, out and the stream), once for every
// launch with these weights and this input shape; 0 or a cudaError_t.
int v3_block_i8_prepare(void* buf, const void* ewt, const void* eb, const void* em,
                        const void* dwt, const void* db, const void* dm, const void* pwt,
                        const void* pb, const void* pm, const void* sw1, const void* sb1,
                        const void* sm1, const void* sw2, const void* sb2, const void* sa2,
                        int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                        int act_exp, int act, int residual, int identity, int th, int tw,
                        int split, int cw, int ws, int bs, float m6_exp, float m6_dw,
                        float hw_inv, float sixth) {
  return prepare(prepared_in(buf), ewt, eb, em, dwt, db, dm, pwt, pb, pm, sw1, sb1, sm1, sw2,
                 sb2, sa2, N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                 identity, th, tw, split, cw, ws, bs, m6_exp, m6_dw, hw_inv, sixth);
}

// A launch prepared by v3_block_i8_prepare in buf, on x, the SE scratch
// (null without SE) and out.
int v3_block_i8_run(const void* buf, const void* x, void* pooled, void* gate, void* zs,
                    void* out, void* stream) {
  return run(*prepared_in(buf), x, pooled, gate, zs, out, (cudaStream_t)stream);
}

// Dynamic shared memory of a plan's pass (mode 0 full, 1 pool, 2 gated;
// ops/v3_block_i8.v3_i8_wgmma_smem_bytes mirrors it).
int v3_i8_wgmma_smem_bytes(int th, int tw, int Cin, int E, int Cout, int K, int stride, int cw,
                           int ws, int bs, int identity, int mode) {
  return v::make_geo(1, 16, 16, Cin, E, Cout, mode == v::kFull ? 0 : 1, K, stride,
                     identity ? mnk::kLinear : mnk::kRelu, mnk::kRelu, 0, identity, mode,
                     v::Plan{th, tw, Cout / cw, cw, ws, bs})
      .smem_bytes;
}

}  // extern "C"
