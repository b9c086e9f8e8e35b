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
// can round once where numpy rounds twice; rintf rounds half to even; the
// library is built without --use_fast_math. The host computes m, m6, the
// gate's f32(1/6) and the pool's f32(1/(Ho*Wo)) in numpy float32 and passes
// them in; the kernel never recomputes a constant.
//
// Replaces three TPU kernels of MobileNet-V3-Large's int8 path:
//   mobilenet_tpu/quant/pallas_ir_v3_i8.py v3_block_pallas_i8 (:290), its V3
//     forms (hswish, k 5, the quantized SE, blocks 2-14);
//   quant/pallas_block_packed_i8.py packed_block_i8_named (:436), block 0:
//     the identity expansion at stride 1 (the residual, which the JAX
//     package adds outside the kernel, is this kernel's epilogue);
//   quant/pallas_block_packed_i8.py packed_block_i8_named_s2 (:632), block
//     1, together with the XLA expansion packed_expand_i8_named before it:
//     here the expansion at stride 2 is the kernel's own.
// Lane packing, bf16 integer carriage, the kron block-diagonal weights and
// the 128-column projection padding were the TPU's (8,128) layout; here
// activations stay int8 NHWC and a tile expands each window pixel once.
// The identity expansion also runs at stride 2 and with SE (V3-Small's
// block 0, the TPU's packed_block_i8_named_s2_se).
//
// Design: inverted_residual_i8.cu's tile loop with a k x k window. A block
// owns one output tile of TH x TW pixels of one image and every output
// channel; it loads the tile's input window ((TH-1)s+k by (TW-1)s+k pixels,
// every input channel) into shared memory once, then walks the expanded
// channels in chunks of KE = 64: stage the chunk's expand and projection
// weight slices transposed (K contiguous for mma); expand the window on the
// tensor cores (mma.sync m16n8k32 s8), + bias, named requant into an int8
// tile (window pixels outside the image expand to 0: SAME pads the expanded
// activation); the chunk's depthwise of the output pixels in int32, named
// requant [x the SE gate]; the chunk's share of the projection into int32
// accumulators that live across chunks (at most FPW m16n8 tiles per warp,
// which bounds TM x Cout). The epilogue adds the bias, requantizes linearly
// and adds the residual from the input window in shared memory.
//
// The SE gate needs the whole image's depthwise output in mid-block, which
// one tile cannot see, so an SE block runs two launches of the loop, as
// v3_block.cu does: pass 1 (POOL) expands, runs the depthwise and requant,
// and adds each channel's int32 sum over the tile's valid outputs into
// `pooled` (N x E int32, zeroed first) with atomics: integer sums are exact
// in any order, so the result does not depend on the schedule. Pass 2
// computes its image's gate from `pooled` into shared memory (every tile of
// the image computes the same gate), then runs the loop with the gate.
//
// What bounds it on an H100: bytes. At batch 256 the 15 blocks of
// MobileNet-V3-Large 1.0-224 move their int8 activations once (~0.4 GB,
// ~0.12 ms at 3.35 TB/s) and do ~0.1 T int8 operations (~0.05 ms at 1,979
// TOP/s); the expanded tensor (up to 6x the block input) never reaches
// device memory. Like inverted_residual_i8.cu this first version is a
// synchronous loop (four barriers a chunk, no load pipelining; SE blocks
// pay the expansion and depthwise twice) whose time is its latency.
#include "int8_tile.cuh"
#include "mma_i8.cuh"
#include "numerics.cuh"

namespace {

using mnk::clamp_i8;
using mnk::ld8;
using mnk::load_a;
using mnk::load_b;
using mnk::mma_s8;
using mnk::pack4;
using mnk::store_transposed;

constexpr int THREADS = 256;       // 8 warps
constexpr int KE = 64;             // expanded channels per chunk: two k32 steps
constexpr int FPW = 10;            // projection m16n8 tiles per warp
constexpr int MAX_FRAGS = 40;      // (TMp / 16) * (CoutP / 16) <= 8 * FPW / 2
constexpr int LDZ = KE + 4;        // expanded window tile row stride (bytes)
constexpr int LDK = KE + 16;       // depthwise tile / projection slice row stride
constexpr int SMEM_MAX = 232448;   // 227 KB, the per-block opt-in limit

struct V3I8Shape {
  int N, H, W, Cin, E, Cout, Se, K, stride, pad, Ho, Wo;
  int act_exp, act, residual, identity;
  int TH, TW, TM, TMp;  // output tile and its rows rounded up to 16
  int PH, PW, P, Pp;    // input window and its pixels rounded up to 16
  int CinP, CoutP;      // Cin rounded up to 32 (the k32 step), Cout up to 16
  int tiles_h, tiles_w;
  int ldx, lde, ldo;    // row strides (bytes): input window, expand slice, output tile
  int off_z, off_e, off_d, off_b, off_w, off_g, off_h, smem;  // byte offsets
};

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

// The smem plan; mirrored by mobilenet_tpu_torch/ops/v3_block_i8.py
// v3_i8_smem_bytes, which decides at the call whether a tile fits. The
// identity expansion stages no expand slice. The chunk's depthwise taps
// (K*K x KE int8) are staged too: held in registers, 25 of them at k 5
// spilled. With SE, the gate (E f32, over the pooled E int32 it is computed
// from) and the hidden row (Se int32).
__host__ inline bool make_shape(V3I8Shape* s, int N, int H, int W, int Cin, int E, int Cout,
                                int Se, int K, int stride, int act_exp, int act, int residual,
                                int identity, int TH, int TW) {
  s->N = N; s->H = H; s->W = W; s->Cin = Cin; s->E = E; s->Cout = Cout; s->Se = Se;
  s->K = K; s->stride = stride; s->act_exp = act_exp; s->act = act;
  s->residual = residual; s->identity = identity;
  s->pad = stride == 1 ? (K - 1) / 2 : (K - 2) / 2;
  s->Ho = (H + stride - 1) / stride;
  s->Wo = (W + stride - 1) / stride;
  s->TH = TH; s->TW = TW; s->TM = TH * TW; s->TMp = rup(s->TM, 16);
  s->PH = (TH - 1) * stride + K;
  s->PW = (TW - 1) * stride + K;
  s->P = s->PH * s->PW;
  s->Pp = rup(s->P, 16);
  s->CinP = rup(Cin, 32);
  s->CoutP = rup(Cout, 16);
  s->tiles_h = (s->Ho + TH - 1) / TH;
  s->tiles_w = (s->Wo + TW - 1) / TW;
  s->ldx = s->CinP + 16;
  s->lde = s->CinP + 16;
  s->ldo = s->CoutP + 16;
  const int xs = rup(s->Pp * s->ldx, 128);
  const int zs = rup(s->Pp * LDZ, 128);
  const int es = identity ? 0 : rup(KE * s->lde, 128);
  const int ds = rup(s->TMp * LDK, 128);
  const int bs = rup(s->CoutP * LDK, 128);
  const int ws = rup(K * K * KE, 128);
  const int os = rup(s->TMp * s->ldo, 128);
  s->off_z = xs;
  s->off_e = xs + zs;
  s->off_d = s->off_e + es;
  s->off_b = s->off_d + ds;
  s->off_w = s->off_b + bs;
  const int work = zs + es + ds + bs + ws;
  s->off_g = xs + (work > os ? work : os);
  s->off_h = s->off_g + (Se > 0 ? rup(E * 4, 128) : 0);
  s->smem = s->off_h + (Se > 0 ? rup(Se * 4, 128) : 0);
  const bool named = (act == mnk::kRelu || act == mnk::kHswish);
  const bool exp_ok = identity ? (act_exp == mnk::kLinear && E == Cin)
                               : (act_exp == mnk::kRelu || act_exp == mnk::kHswish);
  return N > 0 && H > 0 && W > 0 && Cin > 0 && E > 0 && Cout > 0 && Se >= 0 &&
         Cin % 8 == 0 && E % 8 == 0 && Cout % 8 == 0 && (K == 3 || K == 5) && named &&
         exp_ok && (stride == 1 || (stride == 2 && H % 2 == 0 && W % 2 == 0)) && TH > 0 &&
         TW > 0 && (s->TMp / 16) * (s->CoutP / 16) <= MAX_FRAGS &&
         (!residual || (stride == 1 && Cin == Cout)) && s->smem <= SMEM_MAX;
}

// quant/v3.py _requant_named_np in the folded order; `mult` is m (relu,
// linear) or a (hswish).
__device__ __forceinline__ int requant_named(int acc, float mult, float m6, int act) {
  float q;
  if (act == mnk::kHswish) {
    const float v = __fmul_rn(__int2float_rn(acc), mult);
    const float t = fminf(fmaxf(__fadd_rn(v, 3.0f), 0.0f), 6.0f);
    q = rintf(__fmul_rn(__fmul_rn(v, t), m6));
  } else {
    q = rintf(__fmul_rn(__int2float_rn(acc), mult));
  }
  return int(fminf(fmaxf(q, act == mnk::kRelu ? 0.0f : -128.0f), 127.0f));
}

// POOL: pass 1 of an SE block (channel sums into `pooled`); else the block's
// output, gated by the image's SE gate when s.Se > 0.
template <int K, bool POOL>
__global__ void __launch_bounds__(THREADS, 2)
    v3_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ ew,
                 const int* __restrict__ eb, const float* __restrict__ em,
                 const int8_t* __restrict__ dw, const int* __restrict__ db,
                 const float* __restrict__ dm, const int8_t* __restrict__ pw,
                 const int* __restrict__ pb, const float* __restrict__ pm,
                 const int8_t* __restrict__ sw1, const int* __restrict__ sb1,
                 const float* __restrict__ sm1, const int8_t* __restrict__ sw2,
                 const int* __restrict__ sb2, const float* __restrict__ sa2,
                 int* __restrict__ pooled, int8_t* __restrict__ out, V3I8Shape s,
                 float m6_exp, float m6_dw, float hw_inv, float sixth) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);
  int8_t* Zs = reinterpret_cast<int8_t*>(smem + s.off_z);
  int8_t* Es = reinterpret_cast<int8_t*>(smem + s.off_e);
  int8_t* Ds = reinterpret_cast<int8_t*>(smem + s.off_d);
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + s.off_b);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + s.off_w);
  int8_t* Os = reinterpret_cast<int8_t*>(smem + s.off_z);  // after the last chunk
  int* Pl = reinterpret_cast<int*>(smem + s.off_g);        // the pooled row, then
  float* G = reinterpret_cast<float*>(smem + s.off_g);     // the gate over it
  int* Hd = reinterpret_cast<int*>(smem + s.off_h);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int tiles_img = s.tiles_h * s.tiles_w;
  const int n = blockIdx.x / tiles_img;
  const int t = blockIdx.x % tiles_img;
  const int oy0 = (t / s.tiles_w) * s.TH, ox0 = (t % s.tiles_w) * s.TW;
  const int iy0 = oy0 * s.stride - s.pad, ix0 = ox0 * s.stride - s.pad;
  const long long img = (long long)n * s.H * s.W;
  const uint2 zero2 = make_uint2(0u, 0u);

  // the input window, every input channel; zero outside the image and past Cin
  const int xv = s.CinP / 8;
  for (int idx = tid; idx < s.Pp * xv; idx += THREADS) {
    const int p = idx / xv, c = (idx % xv) * 8;
    const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
    uint2 v = zero2;
    if (p < s.P && c < s.Cin && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
      v = ld8(x + (img + (long long)iy * s.W + ix) * s.Cin + c);
    *reinterpret_cast<uint2*>(Xs + p * s.ldx + c) = v;
  }

  if constexpr (!POOL) {
    if (s.Se > 0) {  // the image's gate, from pass 1's channel sums
      const int* sums = pooled + (long long)n * s.E;
      for (int e = tid; e < s.E; e += THREADS) {
        const float q = rintf(__fmul_rn(__int2float_rn(sums[e]), hw_inv));
        Pl[e] = int(fminf(fmaxf(q, -128.0f), 127.0f));
      }
      __syncthreads();
      for (int j = tid; j < s.Se; j += THREADS) {
        int a = sb1[j];
        for (int e = 0; e < s.E; ++e) a += Pl[e] * int(sw1[(long long)e * s.Se + j]);
        Hd[j] = requant_named(a, sm1[j], 0.0f, mnk::kRelu);
      }
      __syncthreads();
      for (int e = tid; e < s.E; e += THREADS) {  // G overwrites Pl: no reads of Pl remain
        int a = sb2[e];
        for (int j = 0; j < s.Se; ++j) a += Hd[j] * int(sw2[(long long)j * s.E + e]);
        const float v = __fmul_rn(__int2float_rn(a), sa2[e]);
        G[e] = __fmul_rn(fminf(fmaxf(__fadd_rn(v, 3.0f), 0.0f), 6.0f), sixth);
      }
      // the chunk loop's first barrier orders these writes before their reads
    }
  }

  const int mt = s.TMp / 16;
  const int total = mt * (s.CoutP / 8);  // projection m16n8 tiles
  int acc[FPW][4];
#pragma unroll
  for (int j = 0; j < FPW; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

  for (int e0 = 0; e0 < s.E; e0 += KE) {
    __syncthreads();  // the window is loaded; the previous chunk is consumed
    // 1. Es[k][c] = ew[c][e0 + k], Bs[co][k] = pw[e0 + k][co] and Ws[tap][k]
    //    = dw[tap][e0 + k], zero past Cin, E and Cout (every count is a
    //    multiple of 8)
    for (int idx = tid; idx < K * K * (KE / 4); idx += THREADS) {
      const int tap = idx / (KE / 4), k = (idx % (KE / 4)) * 4;
      *reinterpret_cast<uint32_t*>(Ws + tap * KE + k) =
          e0 + k < s.E ? *reinterpret_cast<const uint32_t*>(dw + (long long)tap * s.E + e0 + k)
                       : 0u;
    }
    if (!s.identity) {
      for (int idx = tid; idx < (s.CinP / 4) * (KE / 8); idx += THREADS) {
        const int k = (idx % (KE / 8)) * 8, c = (idx / (KE / 8)) * 4;
        const bool live = c < s.Cin && e0 + k < s.E;
        uint2 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = live ? ld8(ew + (long long)(c + i) * s.E + e0 + k) : zero2;
        store_transposed(Es + k * s.lde + c, s.lde, r);
      }
    }
    if constexpr (!POOL) {
      for (int idx = tid; idx < (KE / 4) * (s.CoutP / 8); idx += THREADS) {
        const int co = (idx % (s.CoutP / 8)) * 8, k = (idx / (s.CoutP / 8)) * 4;
        const bool live = co < s.Cout && e0 + k < s.E;
        uint2 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = live ? ld8(pw + (long long)(e0 + k + i) * s.Cout + co) : zero2;
        store_transposed(Bs + co * LDK + k, LDK, r);
      }
    }
    __syncthreads();
    // 2. the expanded window Zs (Pp x KE): the input itself for the identity
    //    (Xs is already zero outside the image), else requant(Xs @ Es^T +
    //    bias), 0 outside the image (SAME pads the expanded activation) and
    //    past E
    if (s.identity) {
      for (int idx = tid; idx < s.Pp * (KE / 4); idx += THREADS) {
        const int p = idx / (KE / 4), k = (idx % (KE / 4)) * 4;
        uint32_t v = 0;
        if (p < s.P && e0 + k < s.E) v = mnk::lds32(Xs + p * s.ldx + e0 + k);
        *reinterpret_cast<uint32_t*>(Zs + p * LDZ + k) = v;
      }
    } else {
      for (int f = warp; f < (s.Pp / 16) * (KE / 8); f += THREADS / 32) {
        const int mi = f / (KE / 8), ni = f % (KE / 8);
        int c4[4] = {0, 0, 0, 0};
        const int8_t* arow = Xs + (mi * 16 + g) * s.ldx + tig * 4;
        const int8_t* bcol = Es + (ni * 8 + g) * s.lde + tig * 4;
        for (int kk = 0; kk < s.CinP; kk += 32) {
          uint32_t a[4], b[2];
          load_a(a, arow + kk, s.ldx);
          load_b(b, bcol + kk);
          mma_s8(c4, a, b);
        }
        const int k = ni * 8 + tig * 2, e = e0 + k;
        const bool live_e = e < s.E;
        const int b0 = live_e ? eb[e] : 0, b1 = live_e ? eb[e + 1] : 0;
        const float m0 = live_e ? em[e] : 0.0f, m1 = live_e ? em[e + 1] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mi * 16 + g + 8 * h;
          const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
          char2 v = make_char2(0, 0);
          if (live_e && p < s.P && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
            v = make_char2(char(requant_named(c4[2 * h] + b0, m0, m6_exp, s.act_exp)),
                           char(requant_named(c4[2 * h + 1] + b1, m1, m6_exp, s.act_exp)));
          *reinterpret_cast<char2*>(Zs + p * LDZ + k) = v;
        }
      }
    }
    __syncthreads();
    // 3. depthwise k x k of the tile's output pixels, 4 channels a thread, in
    //    int32 (dy then dx), + bias, named requant; POOL sums it, else [x the
    //    gate] -> Ds (TMp x KE)
    {
      const int q = (tid % (KE / 4)) * 4;
      const int e = e0 + q;
      const bool live_e = e < s.E;
      const int8_t* wp = Ws + q;
      int4 bias = make_int4(0, 0, 0, 0);
      float4 mult = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gate = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if (live_e) {
        bias = *reinterpret_cast<const int4*>(db + e);
        mult = *reinterpret_cast<const float4*>(dm + e);
        if (!POOL && s.Se > 0) gate = make_float4(G[e], G[e + 1], G[e + 2], G[e + 3]);
      }
      int sum[4] = {0, 0, 0, 0};
      for (int r = tid / (KE / 4); r < s.TMp; r += THREADS / (KE / 4)) {
        const int oy = r / s.TW, ox = r % s.TW;
        uint32_t packed = 0;
        if (live_e && r < s.TM && oy0 + oy < s.Ho && ox0 + ox < s.Wo) {
          const int8_t* zp = Zs + (oy * s.stride * s.PW + ox * s.stride) * LDZ + q;
          int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
          for (int dy = 0; dy < K; ++dy)
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const char4 z = *reinterpret_cast<const char4*>(zp + (dy * s.PW + dx) * LDZ);
              const char4 w = *reinterpret_cast<const char4*>(wp + (dy * K + dx) * KE);
              a0 += int(z.x) * int(w.x);
              a1 += int(z.y) * int(w.y);
              a2 += int(z.z) * int(w.z);
              a3 += int(z.w) * int(w.w);
            }
          int v[4] = {requant_named(a0 + bias.x, mult.x, m6_dw, s.act),
                      requant_named(a1 + bias.y, mult.y, m6_dw, s.act),
                      requant_named(a2 + bias.z, mult.z, m6_dw, s.act),
                      requant_named(a3 + bias.w, mult.w, m6_dw, s.act)};
          if constexpr (POOL) {
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[i] += v[i];
          } else {
            if (s.Se > 0) {
              const float gt[4] = {gate.x, gate.y, gate.z, gate.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float gq = rintf(__fmul_rn(__int2float_rn(v[i]), gt[i]));
                v[i] = int(fminf(fmaxf(gq, -128.0f), 127.0f));
              }
            }
            packed = pack4(v[0], v[1], v[2], v[3]);
          }
        }
        if constexpr (!POOL) *reinterpret_cast<uint32_t*>(Ds + r * LDK + q) = packed;
      }
      if constexpr (POOL) {
        // lanes l and l + 16 hold the same channels (row groups 2w, 2w + 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 16);
        if (lane < 16 && live_e) {
          int* dst = pooled + (long long)n * s.E + e;
#pragma unroll
          for (int i = 0; i < 4; ++i) atomicAdd(dst + i, sum[i]);
        }
      }
    }
    if constexpr (POOL) continue;  // the next chunk's first barrier protects Zs
    __syncthreads();
    // 4. projection of the chunk: acc += Ds (TMp x KE) @ Bs^T (KE x CoutP)
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      const int f = warp + 8 * j;
      if (f < total) {
        const int mi = f % mt, ni = f / mt;
#pragma unroll
        for (int kk = 0; kk < KE; kk += 32) {
          uint32_t a[4], b[2];
          load_a(a, Ds + (mi * 16 + g) * LDK + tig * 4 + kk, LDK);
          load_b(b, Bs + (ni * 8 + g) * LDK + tig * 4 + kk);
          mma_s8(acc[j], a, b);
        }
      }
    }
  }
  if constexpr (!POOL) {
    __syncthreads();  // every product done before Os overwrites the chunk buffers
    // + bias, linear requant, the saturating residual -> Os (TMp x CoutP)
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      const int f = warp + 8 * j;
      if (f < total) {
        const int mi = f % mt, ni = f / mt;
        const int co = ni * 8 + tig * 2;
        if (co < s.Cout) {
          const int b0 = pb[co], b1 = pb[co + 1];
          const float m0 = pm[co], m1 = pm[co + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mi * 16 + g + 8 * h;
            int v0 = requant_named(acc[j][2 * h] + b0, m0, 0.0f, mnk::kLinear);
            int v1 = requant_named(acc[j][2 * h + 1] + b1, m1, 0.0f, mnk::kLinear);
            if (s.residual && r < s.TM) {  // x at this pixel: window pixel (oy + pad, ox + pad)
              const int8_t* xr =
                  Xs + ((r / s.TW + s.pad) * s.PW + r % s.TW + s.pad) * s.ldx + co;
              v0 = clamp_i8(v0 + int(xr[0]));
              v1 = clamp_i8(v1 + int(xr[1]));
            }
            *reinterpret_cast<char2*>(Os + r * s.ldo + co) = make_char2(char(v0), char(v1));
          }
        }
      }
    }
    __syncthreads();
    // the tile's valid pixels, 8 channels a thread
    const int ov = s.Cout / 8;
    for (int idx = tid; idx < s.TM * ov; idx += THREADS) {
      const int r = idx / ov, c = (idx % ov) * 8;
      const int oy = oy0 + r / s.TW, ox = ox0 + r % s.TW;
      if (oy < s.Ho && ox < s.Wo)
        *reinterpret_cast<uint2*>(out + (((long long)n * s.Ho + oy) * s.Wo + ox) * s.Cout + c) =
            *reinterpret_cast<const uint2*>(Os + r * s.ldo + c);
    }
  }
}

struct Args {
  const int8_t *x, *ew; const int* eb; const float* em;
  const int8_t* dw; const int* db; const float* dm;
  const int8_t* pw; const int* pb; const float* pm;
  const int8_t* sw1; const int* sb1; const float* sm1;
  const int8_t* sw2; const int* sb2; const float* sa2;
  int* pooled; int8_t* out;
  float m6_exp, m6_dw, hw_inv, sixth;
};

template <int K, bool POOL>
int launch_pass(const Args& a, const V3I8Shape& s, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // per instantiation: the opt-in granted so far
  if (s.smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(v3_i8_kernel<K, POOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  const long long blocks = (long long)s.N * s.tiles_h * s.tiles_w;
  v3_i8_kernel<K, POOL><<<(unsigned)blocks, THREADS, s.smem, stream>>>(
      a.x, a.ew, a.eb, a.em, a.dw, a.db, a.dm, a.pw, a.pb, a.pm, a.sw1, a.sb1, a.sm1, a.sw2,
      a.sb2, a.sa2, a.pooled, a.out, s, a.m6_exp, a.m6_dw, a.hw_inv, a.sixth);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const Args& a, const V3I8Shape& s, cudaStream_t stream) {
  if (s.Se > 0) {
    cudaError_t e = cudaMemsetAsync(a.pooled, 0, sizeof(int) * (size_t)s.N * s.E, stream);
    if (e != cudaSuccess) return (int)e;
    const int code = launch_pass<K, true>(a, s, stream);
    if (code != 0) return code;
  }
  return launch_pass<K, false>(a, s, stream);
}

}  // namespace

extern "C" {

int v3_block_i8(const void* x, const void* ew, const void* eb, const void* em, const void* dw,
                const void* db, const void* dm, const void* pw, const void* pb, const void* pm,
                const void* sw1, const void* sb1, const void* sm1, const void* sw2,
                const void* sb2, const void* sa2, void* pooled, void* out, int N, int H, int W,
                int Cin, int E, int Cout, int Se, int K, int stride, int act_exp, int act,
                int residual, int identity, int TH, int TW, float m6_exp, float m6_dw,
                float hw_inv, float sixth, void* stream) {
  V3I8Shape s;
  if (!make_shape(&s, N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual, identity,
                  TH, TW))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * s.tiles_h * s.tiles_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if ((!identity && (ew == nullptr || eb == nullptr || em == nullptr)) ||
      (Se > 0 && (sw1 == nullptr || sb1 == nullptr || sm1 == nullptr || sw2 == nullptr ||
                  sb2 == nullptr || sa2 == nullptr || pooled == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)x, (const int8_t*)ew, (const int*)eb, (const float*)em,
               (const int8_t*)dw, (const int*)db, (const float*)dm, (const int8_t*)pw,
               (const int*)pb, (const float*)pm, (const int8_t*)sw1, (const int*)sb1,
               (const float*)sm1, (const int8_t*)sw2, (const int*)sb2, (const float*)sa2,
               (int*)pooled, (int8_t*)out, m6_exp, m6_dw, hw_inv, sixth};
  return K == 3 ? launch_k<3>(a, s, (cudaStream_t)stream) : launch_k<5>(a, s, (cudaStream_t)stream);
}

int v3_block_i8_smem_bytes(int Cin, int E, int Cout, int Se, int K, int stride, int identity,
                           int TH, int TW) {
  V3I8Shape s;
  make_shape(&s, 1, 2 * 16, 2 * 16, Cin, E, Cout, Se, K, stride,
             identity ? mnk::kLinear : mnk::kRelu, mnk::kRelu, 0, identity, TH, TW);
  return s.smem;
}

}  // extern "C"
