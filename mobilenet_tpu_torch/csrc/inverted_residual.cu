// Fused inverted-residual block of MobileNet-V2, one launch:
//   expand 1x1 + bias + ReLU6 -> depthwise 3x3 (stride 1 or 2, TF-SAME)
//   + bias + ReLU6 -> linear projection 1x1 + bias [+ residual].
//
// Replaces the TPU kernels mobilenet_tpu/ops/pallas_ir_block.py
// inverted_residual_pallas (:364), which runs V2 blocks 2-16, and
// ops/pallas_expand_s2.py expand_block_packed_s2 (:238), the lane-packed
// stride-2 expand block of V2 block 1: at stride 2 this kernel expands each
// input pixel of its tile once and computes exactly the output pixels, which
// is what the packed kernel's kron(S_even, W) selection buys on the TPU.
//
// Numerics (pallas_ir_block.py:207-253): the expansion accumulates in f32,
// adds its bias in f32, applies ReLU6 and rounds to the activation dtype;
// the 9 taps sum in f32 in dy-then-dx order, + bias, ReLU6, rounded; the
// projection accumulates in f32, adds its bias in f32 and rounds to the
// output dtype; the residual is then added in the output dtype (a rounded
// add after a rounding). TF-SAME pads the EXPANDED activation with zeros:
// an input pixel outside the image expands to 0, not to relu6(bias).
// (expand_block_packed_s2 keeps the expanded activation in f32; this kernel
// rounds it, so it matches that entry point exactly in float32 and within
// the bf16 rounding class in bfloat16.)
//
// Design. A block owns one output tile of TH x TW pixels of one image and
// every output channel. It loads the tile's input window (the halo: (TH-1)s+3
// by (TW-1)s+3 pixels, every input channel) into shared memory once, then
// walks the expanded channels in chunks of KE = 32:
//   1. the chunk's expand-weight slice and projection-weight slice -> smem;
//   2. expand the whole window for the chunk (bf16: WMMA 16x16x16 on the
//      tensor cores; float32: FMA on the CUDA cores, exact float32) into an
//      f32 smem tile, then + bias, ReLU6, rounding, and the zero padding;
//   3. the depthwise 3x3 of the tile's output pixels for the chunk -> smem;
//   4. accumulate the projection of the chunk into per-warp accumulators
//      that live across all chunks (registers; at most FPW fragments per
//      warp, which bounds TM x Cout).
// The expanded tensor (t x Cin channels, the widest activation of the
// block) never reaches device memory. Per block the device traffic is the
// input window, the weights (from L2) and the output tile.
//
// What bounds it on an H100: at batch 256 the 16 expanded blocks of V2
// 1.0-224 move their inputs and outputs once (~0.2 ms at 3.35 TB/s) and do
// ~100 GFLOP of products (~0.1 ms at 989 TFLOP/s bf16): bound by bytes. The
// kernel recomputes the halo (a window of th x tw outputs expands
// ((th-1)s+3)((tw-1)s+3) pixels: 1.56x the output pixels at s1 8x8, 4.5x at
// s2 8x8 where 4x is the stride's own) and runs a simple synchronous loop
// (five barriers per chunk, no load pipelining; each thread's loads of a
// chunk are a few independent 16-byte vectors, so one chunk waits for about
// one L2 round trip per phase, not one per element; two blocks per SM, 128
// registers): the first version, right before fast. TMA loads, wgmma and a
// persistent schedule are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "ir_tile.cuh"
#include "numerics.cuh"

namespace {

using mnk::act;
using mnk::from_f;
using mnk::kVec;
using mnk::ld16;
using mnk::st16;
using mnk::to_f;
using mnk::Vec16;

constexpr int IR_THREADS = 256;        // 8 warps
constexpr int KE = 32;                 // expanded channels per chunk
constexpr int FPW = 5;                 // projection fragments (16x16) per warp
constexpr int MAX_FRAGS = 8 * FPW;     // TMp/16 * CoutP/16 <= 40
constexpr int PACC = MAX_FRAGS * 256 / IR_THREADS;  // f32 accumulators / thread
constexpr int LDZ = KE + 4;            // f32 expanded tile row stride
constexpr int LDE = KE + 8;            // expand weight slice row stride
constexpr int LDA = KE + 8;            // depthwise tile row stride
constexpr int SMEM_MAX = 232448;       // 227 KB, the per-block opt-in limit

struct IrShape {
  int N, H, W, Cin, E, Cout, stride, Ho, Wo, residual;
  int TH, TW, TM, TMp;  // output tile and its rows rounded up to 16
  int PH, PW, P, Pp;    // input window and its pixels rounded up to 16
  int CinP, CoutP;      // channels rounded up to 16
  int tiles_h, tiles_w;
  int ldx, ldb, ldc;    // row strides of the input window, weight slice, result
  int off_z, off_e, off_a, off_b, smem;  // byte offsets
};

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

// The smem plan; mirrored by mobilenet_tpu_torch/ops/inverted_residual.py
// ir_smem_bytes, which decides at the call whether a tile fits.
__host__ inline bool make_shape(IrShape* s, int N, int H, int W, int Cin, int E, int Cout,
                                int stride, int residual, int TH, int TW, int item) {
  s->N = N; s->H = H; s->W = W; s->Cin = Cin; s->E = E; s->Cout = Cout;
  s->stride = stride; s->residual = residual;
  s->Ho = (H + stride - 1) / stride;
  s->Wo = (W + stride - 1) / stride;
  s->TH = TH; s->TW = TW; s->TM = TH * TW; s->TMp = rup(s->TM, 16);
  s->PH = (TH - 1) * stride + 3;
  s->PW = (TW - 1) * stride + 3;
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
  s->smem = xs + (work > cs ? work : cs);
  const bool ok = N > 0 && H > 0 && W > 0 && Cin > 0 && E > 0 && Cout > 0 &&
                  (stride == 1 || (stride == 2 && H % 2 == 0 && W % 2 == 0)) &&
                  TH > 0 && TW > 0 && (s->TMp / 16) * (s->CoutP / 16) <= MAX_FRAGS &&
                  (!residual || (stride == 1 && Cin == Cout)) && s->smem <= SMEM_MAX;
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(IR_THREADS, 2)
    ir_kernel(const T* __restrict__ x, const T* __restrict__ ew, const T* __restrict__ eb,
              const T* __restrict__ dw, const T* __restrict__ db, const T* __restrict__ pw,
              const T* __restrict__ pb, T* __restrict__ out, IrShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  float* Zf = reinterpret_cast<float*>(smem + s.off_z);
  T* Es = reinterpret_cast<T*>(smem + s.off_e);
  T* As = reinterpret_cast<T*>(smem + s.off_a);
  T* Bs = reinterpret_cast<T*>(smem + s.off_b);
  float* Cs = reinterpret_cast<float*>(smem + s.off_z);  // after the last chunk

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_img = s.tiles_h * s.tiles_w;
  const int n = blockIdx.x / tiles_img;
  const int t = blockIdx.x % tiles_img;
  const int oy0 = (t / s.tiles_w) * s.TH, ox0 = (t % s.tiles_w) * s.TW;
  const int pad = s.stride == 1 ? 1 : 0;  // TF-SAME: s2 on even inputs pads (0, 1)
  const int iy0 = oy0 * s.stride - pad, ix0 = ox0 * s.stride - pad;
  const long long img = (long long)n * s.H * s.W;
  constexpr int VEC = kVec<T>;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);  // VEC zeros of T

  // the input window, every input channel; zero outside the image
  const int xv = s.CinP / VEC;
  for (int idx = tid; idx < s.Pp * xv; idx += IR_THREADS) {
    const int p = idx / xv, c = (idx % xv) * VEC;
    const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
    uint4 v = zero4;
    if (p < s.P && c < s.Cin && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
      v = ld16(x + (img + (long long)iy * s.W + ix) * s.Cin + c);
    st16(Xs + p * s.ldx + c, v);
  }

  const int mt = s.TMp / 16;
  const int total = mt * (s.CoutP / 16);
  float acc[PACC];
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[FPW];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < PACC; ++j) acc[j] = 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < FPW; ++j) nvcuda::wmma::fill_fragment(cf[j], 0.0f);
  }

  for (int e0 = 0; e0 < s.E; e0 += KE) {
    __syncthreads();  // the window is loaded; the previous chunk is consumed
    for (int idx = tid; idx < s.CinP * (KE / VEC); idx += IR_THREADS) {
      const int c = idx / (KE / VEC), k = (idx % (KE / VEC)) * VEC;
      st16(Es + c * LDE + k, (c < s.Cin && e0 + k < s.E)
                                 ? ld16(ew + (long long)c * s.E + e0 + k) : zero4);
    }
    const int bv = s.CoutP / VEC;
    for (int idx = tid; idx < KE * bv; idx += IR_THREADS) {
      const int k = idx / bv, co = (idx % bv) * VEC;
      st16(Bs + k * s.ldb + co, (e0 + k < s.E && co < s.Cout)
                                    ? ld16(pw + (long long)(e0 + k) * s.Cout + co) : zero4);
    }
    __syncthreads();
    mnk::expand_product<T, IR_THREADS, KE, LDZ, LDE>(Xs, Es, Zf, s);
    __syncthreads();
    // + bias, ReLU6, rounded to T; 0 outside the image (SAME pads the
    // expanded activation) and beyond E
    {
      const int k = tid % KE;
      const bool valid_e = e0 + k < s.E;
      const float bias = valid_e ? to_f(eb[e0 + k]) : 0.0f;
      for (int p = tid / KE; p < s.Pp; p += IR_THREADS / KE) {
        const int iy = iy0 + p / s.PW, ix = ix0 + p % s.PW;
        float v = 0.0f;
        if (valid_e && p < s.P && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          v = to_f(from_f<T>(act(Zf[p * LDZ + k] + bias, true)));
        Zf[p * LDZ + k] = v;
      }
    }
    __syncthreads();
    // depthwise 3x3 of the tile's output pixels -> As (rounded to T)
    {
      const int k = tid % KE;
      const int e = e0 + k;
      float wt[9];
      float bias = 0.0f;
#pragma unroll
      for (int q = 0; q < 9; ++q) wt[q] = e < s.E ? to_f(dw[q * s.E + e]) : 0.0f;
      if (e < s.E) bias = to_f(db[e]);
      for (int r = tid / KE; r < s.TMp; r += IR_THREADS / KE) {
        const int oy = r / s.TW, ox = r % s.TW;
        float v = 0.0f;
        if (e < s.E && r < s.TM && oy0 + oy < s.Ho && ox0 + ox < s.Wo) {
          const float* zp = Zf + (oy * s.stride * s.PW + ox * s.stride) * LDZ + k;
          float a = 0.0f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) a = a + zp[(dy * s.PW + dx) * LDZ] * wt[dy * 3 + dx];
          v = act(a + bias, true);
        }
        As[r * LDA + k] = from_f<T>(v);
      }
    }
    __syncthreads();
    // projection of the chunk: acc += As (TMp x KE) @ Bs (KE x CoutP)
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < PACC; ++j) {
        const int q = tid + IR_THREADS * j;
        if (q < s.TMp * s.CoutP) {
          const float* a = As + (q / s.CoutP) * LDA;
          const float* b = Bs + q % s.CoutP;
          float v = acc[j];
#pragma unroll 8
          for (int k = 0; k < KE; ++k) v = fmaf(a[k], b[k * s.ldb], v);
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
  __syncthreads();  // every product done before Cs overwrites the chunk buffers
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < PACC; ++j) {
      const int q = tid + IR_THREADS * j;
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
  for (int idx = tid; idx < s.TM * ov; idx += IR_THREADS) {
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

template <typename T>
int launch(const void* x, const void* ew, const void* eb, const void* dw, const void* db,
           const void* pw, const void* pb, void* out, int N, int H, int W, int Cin, int E,
           int Cout, int stride, int residual, int TH, int TW, void* stream) {
  IrShape s;
  if (!make_shape(&s, N, H, W, Cin, E, Cout, stride, residual, TH, TW, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)N * s.tiles_h * s.tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  static int smem_set = 48 * 1024;  // per instantiation: the opt-in granted so far
  if (s.smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ir_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  ir_kernel<T><<<(unsigned)blocks, IR_THREADS, s.smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)ew, (const T*)eb, (const T*)dw, (const T*)db, (const T*)pw,
      (const T*)pb, (T*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int inverted_residual_bf16(const void* x, const void* ew, const void* eb, const void* dw,
                           const void* db, const void* pw, const void* pb, void* out, int N,
                           int H, int W, int Cin, int E, int Cout, int stride, int residual,
                           int TH, int TW, void* stream) {
  return launch<__nv_bfloat16>(x, ew, eb, dw, db, pw, pb, out, N, H, W, Cin, E, Cout, stride,
                               residual, TH, TW, stream);
}

int inverted_residual_f32(const void* x, const void* ew, const void* eb, const void* dw,
                          const void* db, const void* pw, const void* pb, void* out, int N,
                          int H, int W, int Cin, int E, int Cout, int stride, int residual,
                          int TH, int TW, void* stream) {
  return launch<float>(x, ew, eb, dw, db, pw, pb, out, N, H, W, Cin, E, Cout, stride,
                       residual, TH, TW, stream);
}

int inverted_residual_smem_bytes(int Cin, int Cout, int stride, int TH, int TW, int item) {
  IrShape s;
  make_shape(&s, 1, 2 * 16, 2 * 16, Cin, KE, Cout, stride, 0, TH, TW, item);
  return s.smem;
}

}  // extern "C"
