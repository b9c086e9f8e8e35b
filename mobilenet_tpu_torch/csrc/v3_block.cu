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
// Activations (numerics.cuh act_named): relu, relu6, hswish.
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
// Design. The tile loop of inverted_residual.cu: a block owns one output tile
// of TH x TW pixels of one image and every output channel; it loads the
// tile's input window ((TH-1)s+k by (TW-1)s+k pixels, every input channel)
// into shared memory once, then walks the expanded channels in chunks of
// KE = 32 (expand the window for the chunk into an f32 tile, the depthwise of
// the tile's outputs, the chunk's share of the projection into accumulators
// that live across chunks). The expanded tensor never reaches device memory.
// Channels past E in the last chunk are zero in the expansion and the
// depthwise, so they add nothing to the projection and are never pooled.
//
// The squeeze-excite gate is a reduction over the whole image in the middle
// of the block, which one tile cannot see. A block with SE runs two launches
// of the same loop (design (a); one block an image, design (b), needs the
// whole input image and an f32 output accumulator in shared memory: 275 KB at
// V3-Large's block 3, over the 227 KB limit):
//   pass 1 (POOL): expand -> depthwise -> act per tile, and each tile's
//     per-channel f32 sums of its outputs (in pixel order per thread, then the
//     eight row groups in order) into a scratch `partial` (N x tiles x E f32);
//     nothing else is written;
//   pass 2: each block sums its image's partials over the tiles in order, runs
//     the two SE products and the hard sigmoid into a gate in shared memory,
//     then runs the tile loop again with the gate applied before the
//     projection.
// The pooled sum is deterministic (no atomics) and the expanded tensor still
// never reaches device memory; SE blocks pay the expansion and depthwise
// twice, and every tile of an image computes the image's gate.
//
// What bounds it on an H100: V3-Large 1.0-224 at batch 256 does ~100 GFLOP
// of products over its 15 blocks; the blocks at 112-28 squared are bound by
// their bytes (inputs and outputs once at 3.35 TB/s), those at 14 and 7
// squared by their operations (989 TFLOP/s bf16): 0.24 ms the sum of the
// blocks' bounds. Like inverted_residual.cu, this first version is a
// synchronous loop (five barriers a chunk, no load pipelining) whose time is
// its latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "ir_tile.cuh"
#include "numerics.cuh"

namespace {

using mnk::act_named;
using mnk::from_f;
using mnk::kVec;
using mnk::ld16;
using mnk::st16;
using mnk::to_f;
using mnk::Vec16;

constexpr int V3_THREADS = 256;        // 8 warps
constexpr int ROWG = V3_THREADS / 32;  // row groups of the per-channel loops
constexpr int KE = 32;                 // expanded channels per chunk
constexpr int FPW = 5;                 // projection fragments (16x16) per warp
constexpr int MAX_FRAGS = 8 * FPW;     // TMp/16 * CoutP/16 <= 40
constexpr int PACC = MAX_FRAGS * 256 / V3_THREADS;  // f32 accumulators / thread
constexpr int LDZ = KE + 4;            // f32 expanded tile row stride
constexpr int LDE = KE + 8;            // expand weight slice row stride
constexpr int LDA = KE + 8;            // depthwise tile row stride
constexpr int SMEM_MAX = 232448;       // 227 KB, the per-block opt-in limit

struct V3Shape {
  int N, H, W, Cin, E, Cout, Se, K, stride, pad, Ho, Wo;
  int act_exp, act, residual, identity;
  int TH, TW, TM, TMp;  // output tile and its rows rounded up to 16
  int PH, PW, P, Pp;    // input window and its pixels rounded up to 16
  int CinP, CoutP;      // channels rounded up to 16
  int tiles_h, tiles_w;
  int ldx, ldb, ldc;    // row strides of the input window, weight slice, result
  int off_z, off_e, off_a, off_b, off_g, off_h, smem;  // byte offsets
  float inv_hw;         // 1 / (Ho * Wo), rounded once from double
};

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

// The smem plan; mirrored by mobilenet_tpu_torch/ops/v3_block.py
// v3_smem_bytes, which decides at the call whether a tile fits.
__host__ inline bool make_shape(V3Shape* s, int N, int H, int W, int Cin, int E, int Cout,
                                int Se, int K, int stride, int act_exp, int act,
                                int residual, int identity, int TH, int TW, int item) {
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
  s->CinP = rup(Cin, 16);
  s->CoutP = rup(Cout, 16);
  s->tiles_h = (s->Ho + TH - 1) / TH;
  s->tiles_w = (s->Wo + TW - 1) / TW;
  s->ldx = s->CinP + 8;
  s->ldb = s->CoutP + 8;
  s->ldc = s->CoutP + 4;
  const int xs = rup(s->Pp * s->ldx * item, 128);
  const int zf = rup(s->Pp * LDZ * 4, 128);
  const int ew = rup(s->CinP * LDE * item, 128);
  const int as = rup(s->TMp * LDA * item, 128);
  const int bs = rup(KE * s->ldb * item, 128);
  const int cs = rup(s->TMp * s->ldc * 4, 128);
  s->off_z = xs;
  s->off_e = xs + zf;
  s->off_a = s->off_e + ew;
  s->off_b = s->off_a + as;
  const int work = zf + ew + as + bs;
  s->off_g = xs + (work > cs ? work : cs);  // the SE gate (E f32), then its hidden row
  s->off_h = s->off_g + (Se > 0 ? rup(E * 4, 128) : 0);
  s->smem = s->off_h + (Se > 0 ? rup(Se * 4, 128) : 0);
  s->inv_hw = (float)(1.0 / ((double)s->Ho * (double)s->Wo));
  const bool acts_ok = act_exp >= mnk::kLinear && act_exp <= mnk::kHswish &&
                       act >= mnk::kLinear && act <= mnk::kHswish;
  const bool ok = N > 0 && H > 0 && W > 0 && Cin > 0 && E > 0 && Cout > 0 && Se >= 0 &&
                  (K == 3 || K == 5) && acts_ok && (!identity || E == Cin) &&
                  (stride == 1 || (stride == 2 && H % 2 == 0 && W % 2 == 0)) &&
                  TH > 0 && TW > 0 && (s->TMp / 16) * (s->CoutP / 16) <= MAX_FRAGS &&
                  (!residual || (stride == 1 && Cin == Cout)) && s->smem <= SMEM_MAX;
  return ok;
}

// POOL: pass 1 of an SE block (per-tile channel sums into `partial`); else the
// block's output, gated by the image's SE gate when s.Se > 0.
template <typename T, int K, bool POOL>
__global__ void __launch_bounds__(V3_THREADS, 2)
    v3_kernel(const T* __restrict__ x, const T* __restrict__ ew, const T* __restrict__ eb,
              const T* __restrict__ dw, const T* __restrict__ db, const T* __restrict__ pw,
              const T* __restrict__ pb, const T* __restrict__ w1, const T* __restrict__ b1,
              const T* __restrict__ w2, const T* __restrict__ b2, float* __restrict__ partial,
              T* __restrict__ out, V3Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  float* Zf = reinterpret_cast<float*>(smem + s.off_z);
  T* Es = reinterpret_cast<T*>(smem + s.off_e);
  T* As = reinterpret_cast<T*>(smem + s.off_a);
  float* Red = reinterpret_cast<float*>(smem + s.off_a);  // POOL: ROWG x KE sums
  T* Bs = reinterpret_cast<T*>(smem + s.off_b);
  float* Cs = reinterpret_cast<float*>(smem + s.off_z);  // after the last chunk
  float* G = reinterpret_cast<float*>(smem + s.off_g);
  float* Hd = reinterpret_cast<float*>(smem + s.off_h);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_img = s.tiles_h * s.tiles_w;
  const int n = blockIdx.x / tiles_img;
  const int t = blockIdx.x % tiles_img;
  const int oy0 = (t / s.tiles_w) * s.TH, ox0 = (t % s.tiles_w) * s.TW;
  const int iy0 = oy0 * s.stride - s.pad, ix0 = ox0 * s.stride - s.pad;
  const long long img = (long long)n * s.H * s.W;
  constexpr int VEC = kVec<T>;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);  // VEC zeros of T

  // the input window, every input channel; zero outside the image
  const int xv = s.CinP / VEC;
  for (int idx = tid; idx < s.Pp * xv; idx += V3_THREADS) {
    const int p = idx / xv, c = (idx % xv) * VEC;
    const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
    uint4 v = zero4;
    if (p < s.P && c < s.Cin && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
      v = ld16(x + (img + (long long)iy * s.W + ix) * s.Cin + c);
    st16(Xs + p * s.ldx + c, v);
  }

  if constexpr (!POOL) {
    if (s.Se > 0) {  // the image's gate, from pass 1's per-tile sums
      const float* part = partial + (long long)n * tiles_img * s.E;
      for (int e = tid; e < s.E; e += V3_THREADS) {
        float a = 0.0f;
        for (int tt = 0; tt < tiles_img; ++tt) a += part[(long long)tt * s.E + e];
        G[e] = to_f(from_f<T>(a * s.inv_hw));
      }
      __syncthreads();
      for (int j = tid; j < s.Se; j += V3_THREADS) {
        float a = 0.0f;
        for (int e = 0; e < s.E; ++e) a = fmaf(G[e], to_f(w1[(long long)e * s.Se + j]), a);
        Hd[j] = to_f(from_f<T>(fmaxf(a + to_f(b1[j]), 0.0f)));
      }
      __syncthreads();
      for (int e = tid; e < s.E; e += V3_THREADS) {
        float a = 0.0f;
        for (int j = 0; j < s.Se; ++j) a = fmaf(Hd[j], to_f(w2[(long long)j * s.E + e]), a);
        a = a + to_f(b2[e]);
        G[e] = fminf(fmaxf(a + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
      }
      // the chunk loop's first barrier orders these writes before their reads
    }
  }

  const int mt = s.TMp / 16;
  const int total = mt * (s.CoutP / 16);
  float acc[PACC];
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[FPW];
  if constexpr (!POOL) {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < PACC; ++j) acc[j] = 0.0f;
    } else {
#pragma unroll
      for (int j = 0; j < FPW; ++j) nvcuda::wmma::fill_fragment(cf[j], 0.0f);
    }
  }

  for (int e0 = 0; e0 < s.E; e0 += KE) {
    __syncthreads();  // the window is loaded; the previous chunk is consumed
    if (!s.identity) {
      for (int idx = tid; idx < s.CinP * (KE / VEC); idx += V3_THREADS) {
        const int c = idx / (KE / VEC), k = (idx % (KE / VEC)) * VEC;
        st16(Es + c * LDE + k, (c < s.Cin && e0 + k < s.E)
                                   ? ld16(ew + (long long)c * s.E + e0 + k) : zero4);
      }
    }
    if constexpr (!POOL) {
      const int bv = s.CoutP / VEC;
      for (int idx = tid; idx < KE * bv; idx += V3_THREADS) {
        const int k = idx / bv, co = (idx % bv) * VEC;
        st16(Bs + k * s.ldb + co, (e0 + k < s.E && co < s.Cout)
                                      ? ld16(pw + (long long)(e0 + k) * s.Cout + co) : zero4);
      }
    }
    __syncthreads();
    if (!s.identity) {
      mnk::expand_product<T, V3_THREADS, KE, LDZ, LDE>(Xs, Es, Zf, s);
      __syncthreads();
    }
    // + bias, act, rounded to T (the identity: the input itself); 0 outside
    // the image (SAME pads the expanded activation) and beyond E
    {
      const int k = tid % KE;
      const bool valid_e = e0 + k < s.E;
      const float bias = valid_e && !s.identity ? to_f(eb[e0 + k]) : 0.0f;
      for (int p = tid / KE; p < s.Pp; p += V3_THREADS / KE) {
        const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
        float v = 0.0f;
        if (valid_e && p < s.P && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          v = s.identity ? to_f(Xs[p * s.ldx + e0 + k])
                         : to_f(from_f<T>(act_named(Zf[p * LDZ + k] + bias, s.act_exp)));
        Zf[p * LDZ + k] = v;
      }
    }
    __syncthreads();
    // depthwise k x k of the tile's output pixels, + bias, act: POOL sums it,
    // else (x the gate) rounded to T -> As
    {
      const int k = tid % KE;
      const int e = e0 + k;
      float wt[K * K];
      float bias = 0.0f, gate = 1.0f, sum = 0.0f;
#pragma unroll
      for (int q = 0; q < K * K; ++q) wt[q] = e < s.E ? to_f(dw[q * s.E + e]) : 0.0f;
      if (e < s.E) {
        bias = to_f(db[e]);
        if (!POOL && s.Se > 0) gate = G[e];
      }
      for (int r = tid / KE; r < s.TMp; r += ROWG) {
        const int oy = r / s.TW, ox = r % s.TW;
        float v = 0.0f;
        if (e < s.E && r < s.TM && oy0 + oy < s.Ho && ox0 + ox < s.Wo) {
          const float* zp = Zf + (oy * s.stride * s.PW + ox * s.stride) * LDZ + k;
          float a = 0.0f;
#pragma unroll
          for (int dy = 0; dy < K; ++dy)
#pragma unroll
            for (int dx = 0; dx < K; ++dx) a = a + zp[(dy * s.PW + dx) * LDZ] * wt[dy * K + dx];
          v = act_named(a + bias, s.act);
          if (POOL)
            sum += v;
          else if (s.Se > 0)
            v = v * gate;
        }
        if (!POOL) As[r * LDA + k] = from_f<T>(v);
      }
      if (POOL) Red[warp * KE + k] = sum;
    }
    __syncthreads();
    if constexpr (POOL) {
      if (tid < KE && e0 + tid < s.E) {
        float a = 0.0f;
#pragma unroll
        for (int g = 0; g < ROWG; ++g) a += Red[g * KE + tid];
        partial[((long long)n * tiles_img + t) * s.E + e0 + tid] = a;
      }
      continue;  // the next chunk's first barrier protects Red
    }
    // projection of the chunk: acc += As (TMp x KE) @ Bs (KE x CoutP)
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < PACC; ++j) {
        const int q = tid + V3_THREADS * j;
        if (q < s.TMp * s.CoutP) {
          const float* a = As + (q / s.CoutP) * LDA;
          const float* b = Bs + q % s.CoutP;
          float v = acc[j];
#pragma unroll 8
          for (int kk = 0; kk < KE; ++kk) v = fmaf(a[kk], b[kk * s.ldb], v);
          acc[j] = v;
        }
      }
    } else {
      using namespace nvcuda;
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        const int f = warp + 8 * j;
        if (f < total) {
          const int mi = f % mt, ni = f / mt;
#pragma unroll
          for (int kk = 0; kk < KE; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(af, As + mi * 16 * LDA + kk, LDA);
            wmma::load_matrix_sync(bf, Bs + kk * s.ldb + ni * 16, s.ldb);
            wmma::mma_sync(cf[j], af, bf, cf[j]);
          }
        }
      }
    }
  }
  if constexpr (!POOL) {
    __syncthreads();  // every product done before Cs overwrites the chunk buffers
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < PACC; ++j) {
        const int q = tid + V3_THREADS * j;
        if (q < s.TMp * s.CoutP) Cs[(q / s.CoutP) * s.ldc + q % s.CoutP] = acc[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        const int f = warp + 8 * j;
        if (f < total)
          nvcuda::wmma::store_matrix_sync(Cs + (f % mt) * 16 * s.ldc + (f / mt) * 16, cf[j],
                                          s.ldc, nvcuda::wmma::mem_row_major);
      }
    }
    __syncthreads();
    // + bias in f32, rounded; then the residual in T; VEC channels a thread
    const int ov = s.Cout / VEC;
    for (int idx = tid; idx < s.TM * ov; idx += V3_THREADS) {
      const int r = idx / ov, co = (idx % ov) * VEC;
      const int oy = oy0 + r / s.TW, ox = ox0 + r % s.TW;
      if (oy < s.Ho && ox < s.Wo) {
        const long long pix = ((long long)n * s.Ho + oy) * s.Wo + ox;
        Vec16<T> bias, res, o;
        bias.u = ld16(pb + co);
        res.u = s.residual ? ld16(x + pix * s.Cin + co) : zero4;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o.t[j] = from_f<T>(Cs[r * s.ldc + co + j] + to_f(bias.t[j]));
          if (s.residual) o.t[j] = from_f<T>(to_f(o.t[j]) + to_f(res.t[j]));
        }
        st16(out + pix * s.Cout + co, o.u);
      }
    }
  }
}

template <typename T, int K, bool POOL>
int launch_pass(const void* x, const void* ew, const void* eb, const void* dw, const void* db,
                const void* pw, const void* pb, const void* w1, const void* b1,
                const void* w2, const void* b2, float* partial, void* out, const V3Shape& s,
                void* stream) {
  static int smem_set = 48 * 1024;  // per instantiation: the opt-in granted so far
  if (s.smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(v3_kernel<T, K, POOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  const long long blocks = (long long)s.N * s.tiles_h * s.tiles_w;
  v3_kernel<T, K, POOL><<<(unsigned)blocks, V3_THREADS, s.smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)ew, (const T*)eb, (const T*)dw, (const T*)db, (const T*)pw,
      (const T*)pb, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, partial, (T*)out,
      s);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_k(const void* x, const void* ew, const void* eb, const void* dw, const void* db,
             const void* pw, const void* pb, const void* w1, const void* b1, const void* w2,
             const void* b2, float* partial, void* out, const V3Shape& s, void* stream) {
  if (s.Se > 0) {
    const int code = launch_pass<T, K, true>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2,
                                             partial, out, s, stream);
    if (code != 0) return code;
  }
  return launch_pass<T, K, false>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2, partial, out, s,
                                  stream);
}

template <typename T>
int launch(const void* x, const void* ew, const void* eb, const void* dw, const void* db,
           const void* pw, const void* pb, const void* w1, const void* b1, const void* w2,
           const void* b2, void* partial, void* out, int N, int H, int W, int Cin, int E,
           int Cout, int Se, int K, int stride, int act_exp, int act, int residual,
           int identity, int TH, int TW, void* stream) {
  V3Shape s;
  if (!make_shape(&s, N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual, identity,
                  TH, TW, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * s.tiles_h * s.tiles_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if ((!identity && (ew == nullptr || eb == nullptr)) ||
      (Se > 0 && (w1 == nullptr || b1 == nullptr || w2 == nullptr || b2 == nullptr ||
                  partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  return K == 3 ? launch_k<T, 3>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2, part, out, s, stream)
                : launch_k<T, 5>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2, part, out, s, stream);
}

}  // namespace

extern "C" {

int v3_block_bf16(const void* x, const void* ew, const void* eb, const void* dw,
                  const void* db, const void* pw, const void* pb, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* partial, void* out,
                  int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                  int act_exp, int act, int residual, int identity, int TH, int TW,
                  void* stream) {
  return launch<__nv_bfloat16>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2, partial, out, N, H,
                               W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
                               identity, TH, TW, stream);
}

int v3_block_f32(const void* x, const void* ew, const void* eb, const void* dw,
                 const void* db, const void* pw, const void* pb, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* partial, void* out,
                 int N, int H, int W, int Cin, int E, int Cout, int Se, int K, int stride,
                 int act_exp, int act, int residual, int identity, int TH, int TW,
                 void* stream) {
  return launch<float>(x, ew, eb, dw, db, pw, pb, w1, b1, w2, b2, partial, out, N, H, W, Cin,
                       E, Cout, Se, K, stride, act_exp, act, residual, identity, TH, TW,
                       stream);
}

int v3_block_smem_bytes(int Cin, int E, int Cout, int Se, int K, int stride, int TH, int TW,
                        int item) {
  V3Shape s;
  make_shape(&s, 1, 2 * 16, 2 * 16, Cin, E, Cout, Se, K, stride, mnk::kRelu, mnk::kRelu, 0, 0,
             TH, TW, item);
  return s.smem;
}

}  // extern "C"
