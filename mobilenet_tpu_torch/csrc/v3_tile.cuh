// One output tile of the float32 MobileNet-V3 bottleneck, shared by the
// per-block kernel (v3_block.cu) and the chain kernel (v3_chain.cu), so that
// a chain stage computes bit for bit what one per-block launch does. The
// numerics, the tile design and the two-pass squeeze-excite are described in
// v3_block.cu's header. bf16 runs v3_wgmma.cuh.
//
// A tile is TH x TW output pixels of image n (tile t of the image's
// tiles_h x tiles_w, row-major) and every output channel. The caller hands
// in n and t (v3_block.cu derives them from blockIdx.x, the chain from its
// persistent tile loop) and the block's dynamic shared memory.
//
// kCoherent: the input and the SE partial sums were written by other blocks
// of the same launch before a grid barrier (a chain stage), so they load
// through L2 (ld.global.cg), never through the non-coherent L1/texture path
// that `const __restrict__` permits. The loaded values, and so the results,
// are the same either way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "numerics.cuh"

namespace mnk {

// Loads and stores of 16 bytes (kVec<T> elements of T): every channel count
// is a multiple of 8 and every tensor 16-byte aligned (the wrappers check
// both), so a row of channels moves as whole vectors, and a thread's loads of
// one loop are few and independent instead of a chain of dependent L2 trips.
template <typename T> constexpr int kVec = 16 / int(sizeof(T));

template <typename T> union Vec16 {
  uint4 u;
  T t[kVec<T>];
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// Zf (Pp x KE, f32, row stride LDZ) = Xs (Pp x CinP, row stride s.ldx) @
// Es (CinP x KE, row stride LDE), by THREADS threads; Pp and CinP are
// multiples of 16. FMA on the CUDA cores (exact float32), a thread owning
// one column and the rows p, p + THREADS / KE.
template <int THREADS, int KE, int LDZ, int LDE, typename Shape>
__device__ __forceinline__ void expand_product(const float* Xs, const float* Es, float* Zf,
                                               const Shape& s) {
  const int tid = threadIdx.x;
  const int k = tid % KE;
  for (int p = tid / KE; p < s.Pp; p += 2 * (THREADS / KE)) {
    const float* x0 = Xs + p * s.ldx;
    const float* x1 = x0 + (THREADS / KE) * s.ldx;  // row p + 8 (Pp % 16 == 0)
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
    for (int c = 0; c < s.CinP; ++c) {
      const float w = Es[c * LDE + k];
      a0 = fmaf(x0[c], w, a0);
      a1 = fmaf(x1[c], w, a1);
    }
    Zf[p * LDZ + k] = a0;
    Zf[(p + THREADS / KE) * LDZ + k] = a1;
  }
}

}  // namespace mnk

namespace mnk::v3 {

constexpr int V3_THREADS = 256;        // 8 warps
constexpr int ROWG = V3_THREADS / 32;  // row groups of the per-channel loops
constexpr int KE = 32;                 // expanded channels per chunk
constexpr int MAX_FRAGS = 40;          // TMp/16 * CoutP/16: the accumulators' bound
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

template <bool kCoherent>
__device__ __forceinline__ uint4 ld_in(const void* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const uint4*>(p));
  else return ld16(p);
}

template <bool kCoherent>
__device__ __forceinline__ float ld_part(const float* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return *p;
}

// POOL: pass 1 of an SE block (the tile's per-channel sums into `partial`);
// else the tile of the block's output, gated by the image's SE gate when
// s.Se > 0. The caller's block runs tiles one after another on the same
// shared memory without a barrier in between: every write of a tile's start
// lands in a region that the previous tile's end no longer reads (the input
// window, the gate) or behind the first chunk barrier.
// Shape: how the tile reads its V3Shape. v3_block.cu hands in its kernel
// parameter by value (V3Shape), so that every field stays a constant-bank
// operand and the kernel compiles as it did before the tile was shared
// (through a reference it ran a few percent slower at batch 256 on the
// card); the chain a reference to its shared-memory copy (const V3Shape&):
// by value, that copy went to registers and spilled.
template <typename T, int K, bool POOL, bool kCoherent, typename Shape>
__device__ __forceinline__ void v3_tile(
    const T* __restrict__ x, const T* __restrict__ ew, const T* __restrict__ eb,
    const T* __restrict__ dw, const T* __restrict__ db, const T* __restrict__ pw,
    const T* __restrict__ pb, const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2, float* __restrict__ partial,
    T* __restrict__ out, Shape s, int n, int t, unsigned char* smem) {
  static_assert(std::is_same<T, float>::value, "bf16 runs v3_wgmma.cuh");
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
      v = ld_in<kCoherent>(x + (img + (long long)iy * s.W + ix) * s.Cin + c);
    st16(Xs + p * s.ldx + c, v);
  }

  if constexpr (!POOL) {
    if (s.Se > 0) {  // the image's gate, from pass 1's per-tile sums
      const float* part = partial + (long long)n * tiles_img * s.E;
      for (int e = tid; e < s.E; e += V3_THREADS) {
        float a = 0.0f;
        for (int tt = 0; tt < tiles_img; ++tt) a += ld_part<kCoherent>(part + (long long)tt * s.E + e);
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

  float acc[PACC];
  if constexpr (!POOL) {
#pragma unroll
    for (int j = 0; j < PACC; ++j) acc[j] = 0.0f;
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
      mnk::expand_product<V3_THREADS, KE, LDZ, LDE>(Xs, Es, Zf, s);
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
    if constexpr (!POOL) {
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
    }
  }
  if constexpr (!POOL) {
    __syncthreads();  // every product done before Cs overwrites the chunk buffers
#pragma unroll
    for (int j = 0; j < PACC; ++j) {
      const int q = tid + V3_THREADS * j;
      if (q < s.TMp * s.CoutP) Cs[(q / s.CoutP) * s.ldc + q % s.CoutP] = acc[j];
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
        res.u = s.residual ? ld_in<kCoherent>(x + pix * s.Cin + co) : zero4;
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

}  // namespace mnk::v3
