// Fused int8 inverted-residual block of MobileNet-V2, one launch, int8 in and
// int8 out, exact (equal, bit for bit, to quant/v2.py's oracle sequence
// pw_i8 -> dw3x3_i8 -> pw_i8_linear [-> _res_add]):
//   expand 1x1 s8 x s8 -> s32 + int32 bias -> ReLU6 requant
//   -> depthwise 3x3 (stride 1 or 2, TF-SAME) in exact int32 taps + int32
//      bias -> ReLU6 requant
//   -> projection 1x1 s8 x s8 -> s32 + int32 bias -> LINEAR requant
//      clamp(rint(float32(acc) * m), -128, 127)
//   [-> residual: clamp(int32(projection) + int32(x), -128, 127)].
// The requants are int8_tile.cuh's (__fmul_rn then rintf, no fast math).
//
// Replaces three TPU kernels on MobileNet-V2's int8 path:
//   mobilenet_tpu/quant/pallas_ir_i8.py inverted_residual_pallas_i8 (:237),
//     V2 int8 blocks 2-12 and 14-16;
//   quant/pallas_expand_s2_i8.py expand_block_packed_s2_i8 (:163), the
//     lane-packed stride-2 expand block of V2 block 1 (named "relu" requant
//     with a = m, inv_s = 1.0, equal to the ReLU6 requant while six_q ==
//     127): at stride 2 this kernel expands each window pixel of its tile
//     once and computes only the output pixels, which is what the packed
//     kernel's kron(S_even, W) selection buys on the TPU;
//   quant/pallas_ir_v3_i8.py v3_block_pallas_i8 (:290) in the form V2 uses
//     it, the bridge for block 13 at batch 256 (k 3, relu, no SE), which
//     broke the TPU kernel's VMEM plan; here block 13 has a tile like any
//     other. The V3 forms of that kernel (hswish, k 5, SE) are
//     v3_block_i8.cu.
// No bf16 carriage of the expanded tile, no `pairs` reshape, no kron: those
// were the TPU's (8,128) layout and f32-accumulating matrix unit.
//
// What bounds it on an H100: bytes. At batch 256 the 16 expanded blocks of
// V2 1.0-224 move their int8 activations once, about 0.25 GB (~0.07 ms at
// 3.35 TB/s), and do ~0.2 T int8 operations (~0.1 ms at 1,979 TOP/s).
// Unfused, the expanded tensor (t = 6 times the block's input, the widest
// activation of the block) would cross device memory twice more. The design
// keeps it on chip: a block owns one output tile of TH x TW pixels of one
// image and every output channel, loads the tile's input window (the halo:
// (TH-1)s+3 by (TW-1)s+3 pixels, every input channel) into shared memory
// once, then walks the expanded channels in chunks of KE = 64:
//   1. stages the chunk's expand- and projection-weight slices, transposed
//      so that K is contiguous for mma (4 int8 channels per 32-bit word);
//   2. expands the whole window on the tensor cores (mma.sync m16n8k32
//      s8.s8.s32, the instruction and fragment layout of
//      separable_block_i8.cu), + bias, requant into an int8 tile; window
//      pixels outside the image expand to 0 (SAME pads the expanded
//      activation), not to requant(bias);
//   3. runs the chunk's depthwise of the tile's output pixels in int32 and
//      requantizes it into an int8 tile;
//   4. accumulates the projection in int32 registers across all chunks (at
//      most FPW m16n8 tiles per warp, which bounds TM x Cout).
// The epilogue adds the bias, applies the linear requant and the residual
// (read from the input window in shared memory) into an int8 tile, then
// stores it 8 bytes a thread. Channel tails (Cin 16/24, E 96/144 are not
// multiples of 32) are zero-filled in shared memory: zero weights give exact
// zeros. The first version, right before fast: four barriers per chunk, no
// load pipelining; cp.async/TMA and a persistent schedule are later work.
#include "int8_tile.cuh"
#include "mma_i8.cuh"

namespace {

using mnk::clamp_i8;
using mnk::ld8;
using mnk::load_a;
using mnk::load_b;
using mnk::mma_s8;
using mnk::store_transposed;

constexpr int THREADS = 256;       // 8 warps
constexpr int KE = 64;             // expanded channels per chunk: two k32 steps
constexpr int FPW = 10;            // projection m16n8 tiles per warp
constexpr int MAX_FRAGS = 40;      // (TMp / 16) * (CoutP / 16) <= 8 * FPW / 2
constexpr int LDZ = KE + 4;        // expanded window tile row stride (bytes)
constexpr int LDK = KE + 16;       // depthwise tile / projection slice row stride
constexpr int SMEM_MAX = 232448;   // 227 KB, the per-block opt-in limit

struct IrI8Shape {
  int N, H, W, Cin, E, Cout, stride, Ho, Wo, residual;
  int TH, TW, TM, TMp;  // output tile and its rows rounded up to 16
  int PH, PW, P, Pp;    // input window and its pixels rounded up to 16
  int CinP, CoutP;      // Cin rounded up to 32 (the k32 step), Cout up to 16
  int tiles_h, tiles_w;
  int ldx, lde, ldo;    // row strides (bytes): input window, expand slice, output tile
  int off_z, off_e, off_d, off_b, smem;  // byte offsets
};

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

// The smem plan; mirrored by mobilenet_tpu_torch/ops/inverted_residual_i8.py
// ir_i8_smem_bytes, which decides at the call whether a tile fits. Row
// strides are 16 bytes past a multiple of 32, so the fragment loads of the
// 8 rows of a warp fall in distinct banks.
__host__ inline bool make_shape(IrI8Shape* s, int N, int H, int W, int Cin, int E, int Cout,
                                int stride, int residual, int TH, int TW) {
  s->N = N; s->H = H; s->W = W; s->Cin = Cin; s->E = E; s->Cout = Cout;
  s->stride = stride; s->residual = residual;
  s->Ho = (H + stride - 1) / stride;
  s->Wo = (W + stride - 1) / stride;
  s->TH = TH; s->TW = TW; s->TM = TH * TW; s->TMp = rup(s->TM, 16);
  s->PH = (TH - 1) * stride + 3;
  s->PW = (TW - 1) * stride + 3;
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
  const int es = rup(KE * s->lde, 128);
  const int ds = rup(s->TMp * LDK, 128);
  const int bs = rup(s->CoutP * LDK, 128);
  const int os = rup(s->TMp * s->ldo, 128);
  s->off_z = xs;
  s->off_e = xs + zs;
  s->off_d = s->off_e + es;
  s->off_b = s->off_d + ds;
  const int work = zs + es + ds + bs;
  s->smem = xs + (work > os ? work : os);
  return N > 0 && H > 0 && W > 0 && Cin > 0 && E > 0 && Cout > 0 && Cin % 8 == 0 &&
         E % 8 == 0 && Cout % 8 == 0 &&
         (stride == 1 || (stride == 2 && H % 2 == 0 && W % 2 == 0)) && TH > 0 && TW > 0 &&
         (s->TMp / 16) * (s->CoutP / 16) <= MAX_FRAGS &&
         (!residual || (stride == 1 && Cin == Cout)) && s->smem <= SMEM_MAX;
}

__global__ void __launch_bounds__(THREADS, 2)
    ir_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ ew,
                 const int* __restrict__ eb, const float* __restrict__ em,
                 const int8_t* __restrict__ dw, const int* __restrict__ db,
                 const float* __restrict__ dm, const int8_t* __restrict__ pw,
                 const int* __restrict__ pb, const float* __restrict__ pm,
                 int8_t* __restrict__ out, IrI8Shape s, float six_e, float six_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);
  int8_t* Zs = reinterpret_cast<int8_t*>(smem + s.off_z);
  int8_t* Es = reinterpret_cast<int8_t*>(smem + s.off_e);
  int8_t* Ds = reinterpret_cast<int8_t*>(smem + s.off_d);
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + s.off_b);
  int8_t* Os = reinterpret_cast<int8_t*>(smem + s.off_z);  // after the last chunk

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int tiles_img = s.tiles_h * s.tiles_w;
  const int n = blockIdx.x / tiles_img;
  const int t = blockIdx.x % tiles_img;
  const int oy0 = (t / s.tiles_w) * s.TH, ox0 = (t % s.tiles_w) * s.TW;
  const int pad = s.stride == 1 ? 1 : 0;  // TF-SAME: s2 on even inputs pads (0, 1)
  const int iy0 = oy0 * s.stride - pad, ix0 = ox0 * s.stride - pad;
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

  const int mt = s.TMp / 16;
  const int total = mt * (s.CoutP / 8);  // projection m16n8 tiles
  int acc[FPW][4];
#pragma unroll
  for (int j = 0; j < FPW; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

  for (int e0 = 0; e0 < s.E; e0 += KE) {
    __syncthreads();  // the window is loaded; the previous chunk is consumed
    // 1. Es[k][c] = ew[c][e0 + k] and Bs[co][k] = pw[e0 + k][co], zero past
    //    Cin, E and Cout (every count is a multiple of 8, so a 4- or 8-wide
    //    group is all in range or all out)
    for (int idx = tid; idx < (s.CinP / 4) * (KE / 8); idx += THREADS) {
      const int k = (idx % (KE / 8)) * 8, c = (idx / (KE / 8)) * 4;
      const bool live = c < s.Cin && e0 + k < s.E;
      uint2 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = live ? ld8(ew + (long long)(c + i) * s.E + e0 + k) : zero2;
      store_transposed(Es + k * s.lde + c, s.lde, r);
    }
    for (int idx = tid; idx < (KE / 4) * (s.CoutP / 8); idx += THREADS) {
      const int co = (idx % (s.CoutP / 8)) * 8, k = (idx / (s.CoutP / 8)) * 4;
      const bool live = co < s.Cout && e0 + k < s.E;
      uint2 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = live ? ld8(pw + (long long)(e0 + k + i) * s.Cout + co) : zero2;
      store_transposed(Bs + co * LDK + k, LDK, r);
    }
    __syncthreads();
    // 2. expand the window: Zs (Pp x KE) = requant(Xs @ Es^T + bias); 0
    //    outside the image (SAME pads the expanded activation) and past E
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
          v = make_char2(char(mnk::requant_i8(c4[2 * h] + b0, m0, six_e, true)),
                         char(mnk::requant_i8(c4[2 * h + 1] + b1, m1, six_e, true)));
        *reinterpret_cast<char2*>(Zs + p * LDZ + k) = v;
      }
    }
    __syncthreads();
    // 3. depthwise 3x3 of the tile's output pixels, 4 channels a thread, in
    //    int32 (dy then dx), + bias, requant -> Ds (TMp x KE)
    {
      const int q = (tid % (KE / 4)) * 4;
      const int e = e0 + q;
      const bool live_e = e < s.E;
      mnk::DwQuad w;
      if (live_e) w = mnk::load_dw_quad(dw, db, dm, s.E, e);
      for (int r = tid / (KE / 4); r < s.TMp; r += THREADS / (KE / 4)) {
        const int oy = r / s.TW, ox = r % s.TW;
        uint32_t v = 0;
        if (live_e && r < s.TM && oy0 + oy < s.Ho && ox0 + ox < s.Wo) {
          const int8_t* zp = Zs + (oy * s.stride * s.PW + ox * s.stride) * LDZ + q;
          int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const char4 z = *reinterpret_cast<const char4*>(zp + (dy * s.PW + dx) * LDZ);
              const char4 wt = w.w[dy * 3 + dx];
              a0 += int(z.x) * int(wt.x);
              a1 += int(z.y) * int(wt.y);
              a2 += int(z.z) * int(wt.z);
              a3 += int(z.w) * int(wt.w);
            }
          v = mnk::pack4(mnk::requant_i8(a0 + w.b.x, w.m.x, six_d, true),
                         mnk::requant_i8(a1 + w.b.y, w.m.y, six_d, true),
                         mnk::requant_i8(a2 + w.b.z, w.m.z, six_d, true),
                         mnk::requant_i8(a3 + w.b.w, w.m.w, six_d, true));
        }
        *reinterpret_cast<uint32_t*>(Ds + r * LDK + q) = v;
      }
    }
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
          int v0 = mnk::requant_linear_i8(acc[j][2 * h] + b0, m0);
          int v1 = mnk::requant_linear_i8(acc[j][2 * h + 1] + b1, m1);
          if (s.residual && r < s.TM) {  // x at this pixel: window pixel (oy + 1, ox + 1)
            const int8_t* xr = Xs + ((r / s.TW + 1) * s.PW + r % s.TW + 1) * s.ldx + co;
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

}  // namespace

extern "C" {

int inverted_residual_i8(const void* x, const void* ew, const void* eb, const void* em,
                         const void* dw, const void* db, const void* dm, const void* pw,
                         const void* pb, const void* pm, void* out, int N, int H, int W,
                         int Cin, int E, int Cout, int stride, int residual, int TH, int TW,
                         float six_e, float six_d, void* stream) {
  IrI8Shape s;
  if (!make_shape(&s, N, H, W, Cin, E, Cout, stride, residual, TH, TW))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)N * s.tiles_h * s.tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  static int smem_set = 48 * 1024;  // the opt-in granted so far
  if (s.smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ir_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  ir_i8_kernel<<<(unsigned)blocks, THREADS, s.smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)ew, (const int*)eb, (const float*)em, (const int8_t*)dw,
      (const int*)db, (const float*)dm, (const int8_t*)pw, (const int*)pb, (const float*)pm,
      (int8_t*)out, s, six_e, six_d);
  return (int)cudaGetLastError();
}

int inverted_residual_i8_smem_bytes(int Cin, int Cout, int stride, int TH, int TW) {
  IrI8Shape s;
  make_shape(&s, 1, 2 * 16, 2 * 16, Cin, KE, Cout, stride, 0, TH, TW);
  return s.smem;
}

}  // extern "C"
