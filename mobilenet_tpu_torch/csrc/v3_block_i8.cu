// Fused int8 MobileNet-V3 bottleneck, one call, int8 in and int8 out, exact
// (equal, bit for bit, to quant/v3.py's oracle sequence):
//   expand 1x1 s8 x s8 -> s32 + int32 bias -> named requant (relu or
//     hswish), or the identity with no activation (block 0: no expansion)
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
//           clamp(rint((v * t) * m6), -128, 127), m6 = f32(inv_s) * f32(1/6).
// Every f32 step is __fmul_rn / __fadd_rn, so no multiply-add contraction
// can round once where numpy rounds twice; the rounding adds 1.5 x 2^23
// (half to even); the library is built without --use_fast_math. The host
// computes m, m6, the gate's f32(1/6) and the pool's f32(1/(Ho*Wo)) in numpy
// float32 and passes them in; the kernel never recomputes a constant.
//
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

// One pass: its maps, the opt-in to its shared memory (once an
// instantiation), a persistent grid of one block an SM (384 threads of 168
// registers fill an SM's 64 K) for each unit.
template <int K, int MODE>
int launch_pass(const v::Tensors& t, const v::Ptrs& p, const v::Geo& g, float m6_exp,
                float m6_dw, cudaStream_t st) {
  if (!v::geo_ok(g)) return (int)cudaErrorInvalidValue;
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
  v::Maps maps;
  if ((e = v::make_maps(maps, t, g)) != cudaSuccess) return (int)e;
  const long long units = v::units_of(g), cap = sms;
  kernel<<<(unsigned)(units < cap ? units : cap), v::THREADS, g.smem_bytes, st>>>(
      maps, p, g, (const int*)t.pb, m6_exp, m6_dw);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const v::Tensors& t, const v::Ptrs& p, const Gate& gate, const v::Geo& full,
             const v::Geo& pool, const v::Geo& gated, float m6_exp, float m6_dw,
             cudaStream_t st) {
  if (full.Se == 0) return launch_pass<K, v::kFull>(t, p, full, m6_exp, m6_dw, st);
  cudaError_t e = cudaMemsetAsync(p.pooled, 0, sizeof(int) * (size_t)pool.N * pool.E, st);
  if (e != cudaSuccess) return (int)e;
  int code = launch_pass<K, v::kPool>(t, p, pool, m6_exp, m6_dw, st);
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
  return launch_pass<3, v::kGated>(t, p, gated, m6_exp, m6_dw, st);
}

}  // namespace

extern "C" {

// x (N, H, W, Cx) int8, Cx = Cin rounded up to 16; ewt (E, Cx) and pwt
// (Cout, Ep) the K-major weight copies, Ep = E rounded up to 16; dwt (k*k/4
// + 1, E) int32 the depthwise table (ops/v3_block_i8.v3_i8_kernel_weights);
// eb, db, pb int32 and em, dm, pm f32 (the named requant's factor: "a" for
// hswish, else "m") per channel; the SE layers' w, b and m (se1) or a (se2);
// SE scratch: pooled (N x E int32), gate (N x E f32), zs (N x Ho x Wo x Ep
// int8); plan: th, tw, split, cw, ws, bs (ops/v3_block_i8.v3_i8_wgmma_plan).
int v3_block_i8(const void* x, const void* ewt, const void* eb, const void* em, const void* dwt,
                const void* db, const void* dm, const void* pwt, const void* pb, const void* pm,
                const void* sw1, const void* sb1, const void* sm1, const void* sw2,
                const void* sb2, const void* sa2, void* pooled, void* gate, void* zs, void* out,
                int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                int act_exp, int act, int residual, int identity, int th, int tw, int split,
                int cw, int ws, int bs, float m6_exp, float m6_dw, float hw_inv, float sixth,
                void* stream) {
  const v::Plan plan{th, tw, split, cw, ws, bs};
  const auto geo = [&](int mode) {
    return v::make_geo(N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual, identity,
                       mode, plan);
  };
  const v::Geo full = geo(v::kFull), pool = geo(v::kPool), gated = geo(v::kGated);
  if ((!identity && (ewt == nullptr || eb == nullptr || em == nullptr)) || Se % 4 != 0 ||
      (Se > 0 && (sw1 == nullptr || sb1 == nullptr || sm1 == nullptr || sw2 == nullptr ||
                  sb2 == nullptr || sa2 == nullptr || pooled == nullptr || gate == nullptr ||
                  zs == nullptr)) ||
      (K != 3 && K != 5) || (long long)N * full.tiles_img * split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const v::Tensors t{x, ewt, eb, em, dwt, db, dm, pwt, pb, pm, gate, zs};
  const v::Ptrs p{(const int8_t*)x, (int8_t*)out, (int8_t*)zs, (int*)pooled};
  const Gate gt{(const int*)pooled, (const int8_t*)sw1, (const int*)sb1, (const float*)sm1,
                (const int8_t*)sw2, (const int*)sb2, (const float*)sa2, (float*)gate, N, E, Se,
                hw_inv, sixth};
  cudaStream_t st = (cudaStream_t)stream;
  return K == 3 ? launch_k<3>(t, p, gt, full, pool, gated, m6_exp, m6_dw, st)
                : launch_k<5>(t, p, gt, full, pool, gated, m6_exp, m6_dw, st);
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
