// The int8 MobileNet-V3 bottleneck on Hopper (v3_block_i8.cu): the bf16
// tile's unit walk, rings and roles (v3_wgmma.cuh) with the int8 operands of
// the separable tile (separable_i8_wgmma.cuh): s8 wgmma on K-major operands,
// the dp4a depthwise over byte-transposed taps, and the exact requant by
// additions of 1.5 x 2^23. Equal, bit for bit, to quant/v3.py's sequence,
// and with the ReLU6 requant (a per-layer upper bound, `requant`) to the
// MobileNet-V2 int8 block's (quant/v2.py, ops/inverted_residual_i8.py).
//
// Work is split into units: an output tile of th x tw pixels of one image
// times a part of the output channels (the plan's Cout split, for the shapes
// with few tiles at batch 1). A persistent block owns one unit at a time
// (the unit index strided by gridDim.x) and, in the full pass:
//   1. stages the tile's input window ((th-1)s+k x (tw-1)s+k pixels = P) by
//      TMA, one box of 128 channels a chunk of Cin, 128-byte swizzled: the
//      K-major A operand of the expansion (MP = P rounded up to 64 rows);
//      pixels outside the image and channels past Cin load as zeros; a ring
//      of ws whole windows (each with the part's projection bias and
//      multiplier), so the next unit's window loads while this one computes.
//      x's channel stride is a multiple of 16 (TMA's strides): the wrapper
//      pads a Cin of 24 or 40;
//   2. walks the expanded channels in chunks of 128 (one swizzled row of the
//      A panel); a chunk's expand weight (128 rows of the K-major (E, Cin)
//      copy), projection weight (the part's rows of the K-major (Cout, E)
//      copy), depthwise table (dp4a words, below), and the expand and
//      depthwise biases and multipliers arrive together in one stage of a
//      ring of bs, so no consumer load goes to device memory;
//   3. expansion: s8 wgmma m64n64k32 over the window's MP / 64 row blocks
//      (the two consumer warpgroups take alternate blocks), one or two
//      64-column halves a chunk (none past E), K = Cin in 32-wide steps;
//      epilogue in registers: + int32 bias, the named requant, zero where
//      the window pixel lies outside the image (TF-SAME pads the expanded
//      tensor, and the requant of a bias alone is not 0), with no branch
//      between the groups of a half whose columns are all live; a quad of
//      lanes transposes its bytes into 16-byte stores of the expanded tile Z
//      (MP x 128 int8, rows padded to 144 bytes). The identity expansion (V3
//      block 0) reads the window itself as Z;
//   4. depthwise k x k from Z: a thread takes 8 channels of up to eight
//      output pixels, four at a time (one where it holds one), with no
//      branch between the pixels' sums; a tap quad's weights (one dp4a word a
//      channel, made once at upload: taps 4q..4q+3 in its bytes) are held for
//      the four pixels, whose four 8-byte tap loads are transposed 4 x 4 in
//      bytes (__byte_perm) so that dp4a sums four taps of a channel from the
//      int32 bias; the last tap (k*k = 4q + 1) against a word holding its
//      byte in the channel's lane; + the named requant, into the A panel (128
//      pixels x 128, K-major, 128-byte swizzle);
//   5. projection: each warpgroup multiplies its 64 rows of the panel by the
//      stage's weight into s32 accumulators that live across the E chunks,
//      in slices of 128/64, 32, 16 and 8 columns (the binary digits of the
//      part's width: no column is padding), K steps up to the chunk's live
//      channels (the weight is zero past E); the slices of chunk c run while
//      chunk c+1 expands;
//   6. epilogue: + int32 bias, the linear requant (the magic-number
//      conversion where every sum + bias of the launch is within 2^22, else
//      __int2float_rn: the sums reach E x 2^14), the quad's byte transpose,
//      the saturating residual (__vaddss4, at stride 1 from the staged
//      window), 16-byte stores.
// Squeeze-excite: the gate multiplies the requantized depthwise output, an
// int8 tensor, so it is stored exactly. Pass 1 (pool) runs steps 1-4 and
// writes that pre-gate tensor z (N x Ho x Wo x Ep int8, Ep = E rounded up to
// 16) and each channel's int32 sum over the image into `pooled` (atomics:
// integer sums are exact in any order). Then each image's gate is computed
// once (v3_block_i8.cu's gate launch). Pass 2 (gated) runs no expansion and
// no depthwise: a stage brings a chunk of z's tile by TMA (the A panel
// itself: rows of 128 channels, 128-byte swizzled), the part's projection
// weight and the image's gate; each warpgroup gates its own 64 rows in
// place, clamp(rint(f32(z) x gate)), then runs the projection and the
// epilogue (the residual read from x).
// Roles: two consumer warpgroups, then one producer warpgroup whose warp 0
// runs the window ring (pass 2: the one ring) and warp 1 the weight ring,
// each by its lane 0; setmaxnreg gives the consumers 232 registers a thread
// and the producers 40 (v3_wgmma.cuh by_role).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "separable_i8_wgmma.cuh"
#include "v3_wgmma.cuh"

namespace mnk {
namespace v3i8 {

using si8::low_bytes;
using si8::MAGIC_F;
using si8::MAGIC_I;
using si8::quad_transpose;
using si8::transpose4;
using v3w::cdiv;
using v3w::quot;
// v3w::setup_smem initialises the rings' barriers at the base of shared
// memory: MAX_WS window and MAX_BS weight slots, the layout rings_of reads.
static_assert(v3w::MAX_WS == 4 && v3w::MAX_BS == 4 && v3w::CONSUMERS == 256,
              "the rings' barrier layout");
using v3w::Ring;
using v3w::warpgroup;

constexpr int KCH = 128;             // channels a window box, an E chunk, a swizzled row
constexpr int ROW = 128;             // bytes of a swizzled row
constexpr int ZROW = ROW + 16;       // a pixel of Z: padded, so the depthwise's loads spread
constexpr int TM = 128;              // output pixels a unit at most (64 a consumer warpgroup)
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = 384;         // + the producer warpgroup
constexpr int EBOX = KCH * ROW;      // an expand-weight box: 128 rows of 128 K bytes
constexpr int BOX64 = 64 * ROW;      // a 64-row projection box
constexpr int BOX8 = 8 * ROW;        // an 8-row projection box
constexpr int VEC = KCH * 4;         // a chunk of an int32 or f32 vector
constexpr int HEAD = 1024;           // the rings' barriers
constexpr int PART = 1024;           // a part's projection bias (then its multiplier): cw * 4 bytes
constexpr int A_BYTES = TM * ROW;    // the A panel (pass 1: its pool sums)
constexpr int MAX_WS = 4, MAX_BS = 4;
constexpr int GATED_SLOTS = 4;       // pass 2's ring (its stages always fit four times)
constexpr int MAX_CW = 184;          // a part's columns: 128 or 64, then 32 + 16 + 8
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use (227 KB)
constexpr int SMALL_BIAS = 1 << 21;  // depthwise: |taps| < 2^19, so |sum| < 2^22

enum Mode { kFull = 0, kPool = 1, kGated = 2 };

// The plan (ops/v3_block_i8.v3_i8_wgmma_plan).
struct Plan {
  int th, tw;   // output tile rows and columns, th * tw <= TM
  int split;    // output-channel parts a tile (pass 1 does not split)
  int cw;       // columns a part (Cout = split * cw)
  int ws, bs;   // window and weight ring slots of the full and pool passes
};

struct Geo {
  int N, H, W, Cin, Cx, E, Ep, Cout, Se, K, stride, pad, Ho, Wo;
  int act_exp, act, residual, identity, mode;
  int th, tw, split, cw, ws, bs;
  int tiles_w, tiles_img, ph, pw, P, MP, nci, nec, nbig, nsmall, nq;
  int exp_bytes, prj_off, dw_off, vec_off, pb_off, stage_bytes, win_bytes, off_z, off_b;
  int off_w;
  int smem_bytes;
  float inv_tw, inv_pw;  // 1 / tw, 1 / pw: exact quotients of the tile's pixels (quot)
};

__host__ __device__ inline int rup(int a, int b) { return cdiv(a, b) * b; }

// The shared-memory plan of one pass; mirrored by
// ops/v3_block_i8.v3_i8_wgmma_smem_bytes. From the 1 KB-aligned base: the
// barriers (HEAD), then in the full and pool passes the A panel, Z (none for
// the identity), bs weight stages and ws windows; a stage holds the chunk's
// expand boxes, (full) projection boxes, depthwise table (nq rows of 128
// words), and expand and depthwise biases and multipliers; a window slot
// (full) ends in the part's projection bias and multiplier (2 x PART). Pass
// 2: four stages of a z tile (the A panel), the projection boxes, the gate
// and the part's projection bias and multiplier.
__host__ __device__ inline Geo make_geo(int N, int H, int W, int Cin, int E, int Cout, int Se,
                                        int K, int stride, int act_exp, int act, int residual,
                                        int identity, int mode, const Plan& p) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Cin = Cin; g.E = E; g.Cout = Cout; g.Se = Se; g.K = K;
  g.stride = stride; g.act_exp = act_exp; g.act = act; g.residual = residual;
  g.identity = identity; g.mode = mode;
  g.Cx = rup(Cin, 16);
  g.Ep = rup(E, 16);
  g.pad = stride == 1 ? (K - 1) / 2 : (K - 2) / 2;  // TF-SAME: low side (even input at s2)
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.th = p.th; g.tw = p.tw; g.split = p.split; g.cw = p.cw; g.ws = p.ws; g.bs = p.bs;
  g.tiles_w = cdiv(g.Wo, p.tw);
  g.tiles_img = cdiv(g.Ho, p.th) * g.tiles_w;
  g.ph = (p.th - 1) * stride + K;
  g.pw = (p.tw - 1) * stride + K;
  g.P = g.ph * g.pw;
  g.MP = rup(g.P, 64);
  g.nci = cdiv(g.Cx, KCH);
  g.nec = cdiv(E, KCH);
  g.nbig = p.cw >= 128 ? 2 : p.cw >= 64 ? 1 : 0;
  g.nsmall = (p.cw - 64 * g.nbig) / 8;
  g.nq = K * K / 4 + 1;
  const int prj = g.nbig * BOX64 + g.nsmall * BOX8;
  if (mode == kGated) {
    g.exp_bytes = 0;
    g.prj_off = A_BYTES;
    g.dw_off = g.vec_off = A_BYTES + prj;  // the gate
    g.pb_off = g.vec_off + VEC;
    g.stage_bytes = rup(g.pb_off + 2 * PART, 1024);
    g.win_bytes = 0;
    g.off_z = g.off_b = HEAD;
    g.off_w = HEAD + GATED_SLOTS * g.stage_bytes;
    g.smem_bytes = 1024 + g.off_w;
  } else {
    g.exp_bytes = identity ? 0 : g.nci * EBOX;
    g.prj_off = g.exp_bytes;
    g.dw_off = g.prj_off + (mode == kFull ? prj : 0);
    g.vec_off = g.dw_off + g.nq * VEC;
    g.stage_bytes = rup(g.vec_off + 4 * VEC, 1024);
    g.pb_off = g.nci * g.MP * ROW;
    g.win_bytes = g.pb_off + (mode == kFull ? 2 * PART : 0);
    g.off_z = HEAD + A_BYTES;
    g.off_b = g.off_z + (identity ? 0 : g.MP * ZROW);
    g.off_w = g.off_b + p.bs * g.stage_bytes;
    g.smem_bytes = 1024 + g.off_w + p.ws * g.win_bytes;
  }
  g.inv_tw = 1.0f / (float)p.tw;
  g.inv_pw = 1.0f / (float)g.pw;
  return g;
}

// Checks a shape, plan and pass; false if they break a rule of the kernel
// (the Python plan never gives such a plan).
__host__ __device__ inline bool geo_ok(const Geo& g) {
  const bool named = g.act == kRelu || g.act == kRelu6 || g.act == kHswish;
  const bool exp_ok = g.identity ? (g.act_exp == kLinear && g.E == g.Cin && g.Cin <= KCH)
                                 : (g.act_exp == kRelu || g.act_exp == kRelu6 ||
                                    g.act_exp == kHswish);
  const bool pass_ok =
      g.mode == kFull ? g.Se == 0 : (g.mode == kPool || g.mode == kGated) && g.Se > 0;
  return g.N > 0 && g.H > 0 && g.W > 0 && g.Cin > 0 && g.E > 0 && g.Cout > 0 &&
         g.Cin % 8 == 0 && g.E % 8 == 0 && g.Cout % 8 == 0 && (g.K == 3 || g.K == 5) && named &&
         exp_ok && pass_ok && (g.stride == 1 || (g.stride == 2 && g.H % 2 == 0 && g.W % 2 == 0)) &&
         (!g.residual || (g.stride == 1 && g.Cin == g.Cout)) && g.th >= 1 && g.tw >= 1 &&
         g.th * g.tw <= TM && g.ph <= 256 && g.pw <= 256 && g.MP <= 64 * 32 && g.cw >= 8 &&
         g.cw % 8 == 0 && g.cw <= MAX_CW && g.split * g.cw == g.Cout && g.ws >= 1 &&
         g.ws <= MAX_WS && g.bs >= 2 && g.bs <= MAX_BS && g.smem_bytes <= SMEM_LIMIT;
}

// Units of a pass: pass 1 (pool) does not split the channels.
__host__ __device__ inline int units_of(const Geo& g) {
  return g.N * g.tiles_img * (g.mode == kPool ? 1 : g.split);
}

struct Unit {
  int n, oy0, ox0, c0;  // image, tile origin, first column
};

__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  const int split = g.mode == kPool ? 1 : g.split;
  const int t = u / split;
  Unit x;
  x.c0 = (u - t * split) * g.cw;
  x.n = t / g.tiles_img;
  const int ti = t - x.n * g.tiles_img;
  const int tr = ti / g.tiles_w;
  x.oy0 = tr * g.th;
  x.ox0 = (ti - tr * g.tiles_w) * g.tw;
  return x;
}

// The tensors of a pass that are not read through the TMA maps.
struct Ptrs {
  const int8_t* x;     // pass 2: the residual's source (channel stride Cx)
  int8_t* out;
  int8_t* zs;          // pass 1: the pre-gate tensor (N x Ho x Wo x Ep)
  int* pooled;         // pass 1: its channel sums (N x E, zeroed first)
};

// The maps a pass loads through (each made only where the pass reads it).
struct Maps {
  CUtensorMap x, ew, pw64, pw8, dw, eb, em, db, dm, gate, z, pb, pm;
};

struct Rings {
  uint64_t *wfull, *wempty, *bfull, *bempty;
  unsigned char *a, *z, *b, *win;
};

__device__ __forceinline__ Rings rings_of(const Geo& g, unsigned char* base) {
  Rings r;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);  // v3w::setup_smem's layout
  r.wfull = bars;
  r.wempty = bars + MAX_WS;
  r.bfull = bars + 2 * MAX_WS;
  r.bempty = bars + 2 * MAX_WS + MAX_BS;
  r.a = base + HEAD;
  r.z = base + g.off_z;
  r.b = base + g.off_b;
  r.win = base + g.off_w;
  return r;
}

// ---- producers (lane 0 of their warp) -------------------------------------------

// The part's projection bias and multiplier (cw each) at dst and dst + PART.
__device__ __forceinline__ void load_part(const Maps* m, uint64_t* bar, unsigned char* dst,
                                          int c0) {
  hop::tma_load_3d(dst, &m->pb, bar, c0, 0, 0);
  hop::tma_load_3d(dst + PART, &m->pm, bar, c0, 0, 0);
}

// The part's projection boxes of chunk c at dst: 64-row boxes, then 8-row.
__device__ __forceinline__ void load_projection(const Geo& g, const Maps* m, uint64_t* bar,
                                                unsigned char* dst, int c, int c0) {
  for (int b = 0; b < g.nbig; ++b)
    hop::tma_load_3d(dst + b * BOX64, &m->pw64, bar, c * KCH, c0 + 64 * b, 0);
  dst += g.nbig * BOX64;
  for (int b = 0; b < g.nsmall; ++b)
    hop::tma_load_3d(dst + b * BOX8, &m->pw8, bar, c * KCH, c0 + 64 * g.nbig + 8 * b, 0);
}

__device__ inline void produce_window(const Geo& g, const Rings& r, const Maps* m) {
  Ring ring;
  const int units = units_of(g);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    uint32_t parity;
    const uint32_t s = ring.next(g.ws, parity);
    hop::mbar_wait(r.wempty + s, parity ^ 1);
    unsigned char* dst = r.win + s * g.win_bytes;
    const bool full = g.mode == kFull;
    hop::mbar_arrive_expect_tx(r.wfull + s, g.nci * g.P * ROW + (full ? 8 * g.cw : 0));
    for (int ci = 0; ci < g.nci; ++ci)
      hop::tma_load_4d(dst + ci * g.MP * ROW, &m->x, r.wfull + s, ci * KCH,
                       x.ox0 * g.stride - g.pad, x.oy0 * g.stride - g.pad, x.n);
    if (full) load_part(m, r.wfull + s, dst + g.pb_off, x.c0);
  }
}

// A stage a chunk of E (full and pool passes): the expand weight's boxes for
// each chunk of Cin (none for the identity), (full) the projection's boxes of
// the unit's columns, the depthwise table and the chunk's vectors.
__device__ inline void produce_weights(const Geo& g, const Rings& r, const Maps* m) {
  Ring ring;
  const bool full = g.mode == kFull;
  const uint32_t bytes = g.exp_bytes + (full ? g.nbig * BOX64 + g.nsmall * BOX8 : 0) +
                         g.nq * VEC + (g.identity ? 2 : 4) * VEC;
  const int units = units_of(g);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    for (int c = 0; c < g.nec; ++c) {
      uint32_t parity;
      const uint32_t s = ring.next(g.bs, parity);
      hop::mbar_wait(r.bempty + s, parity ^ 1);
      uint64_t* bar = r.bfull + s;
      hop::mbar_arrive_expect_tx(bar, bytes);
      unsigned char* dst = r.b + s * g.stage_bytes;
      if (!g.identity) {
        for (int ci = 0; ci < g.nci; ++ci)
          hop::tma_load_3d(dst + ci * EBOX, &m->ew, bar, ci * KCH, c * KCH, 0);
        hop::tma_load_3d(dst + g.vec_off, &m->eb, bar, c * KCH, 0, 0);
        hop::tma_load_3d(dst + g.vec_off + VEC, &m->em, bar, c * KCH, 0, 0);
      }
      if (full) load_projection(g, m, bar, dst + g.prj_off, c, x.c0);
      hop::tma_load_3d(dst + g.dw_off, &m->dw, bar, c * KCH, 0, 0);
      hop::tma_load_3d(dst + g.vec_off + 2 * VEC, &m->db, bar, c * KCH, 0, 0);
      hop::tma_load_3d(dst + g.vec_off + 3 * VEC, &m->dm, bar, c * KCH, 0, 0);
    }
  }
}

// Pass 2's stages: a chunk of z's tile (rows of 128 channels: the A panel),
// the part's projection boxes, the image's gate and the part's projection
// bias and multiplier.
__device__ inline void produce_gated(const Geo& g, const Rings& r, const Maps* m) {
  Ring ring;
  const uint32_t bytes = g.th * g.tw * ROW + g.nbig * BOX64 + g.nsmall * BOX8 + VEC + 8 * g.cw;
  const int units = units_of(g);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    for (int c = 0; c < g.nec; ++c) {
      uint32_t parity;
      const uint32_t s = ring.next(GATED_SLOTS, parity);
      hop::mbar_wait(r.bempty + s, parity ^ 1);
      uint64_t* bar = r.bfull + s;
      hop::mbar_arrive_expect_tx(bar, bytes);
      unsigned char* dst = r.b + s * g.stage_bytes;
      hop::tma_load_4d(dst, &m->z, bar, c * KCH, x.ox0, x.oy0, x.n);
      load_projection(g, m, bar, dst + g.prj_off, c, x.c0);
      hop::tma_load_3d(dst + g.vec_off, &m->gate, bar, c * KCH, x.n, 0);
      load_part(m, bar, dst + g.pb_off, x.c0);
    }
  }
}

// ---- the requants -------------------------------------------------------------------

// float32 of an int32 sum: the magic-number conversion (kMagic: |v| < 2^22),
// else __int2float_rn.
template <bool kMagic>
__device__ __forceinline__ float to_f32(int v) {
  if constexpr (kMagic)
    return __fsub_rn(__int_as_float(v + MAGIC_I), MAGIC_F);
  else
    return __int2float_rn(v);
}

// The named requant of a sum v (bias included): quant/v3.py's folded
// order, relu / linear clamp(rint(f32(v) * mult)), hswish with a = mult:
// x = f32(v) * a, clamp(rint((x * clip(x + 3, 0, 6)) * m6)); and V2's
// ReLU6 (quant/ops.requantize): clamp(rint(clamp(f32(v) * m, 0, six_q))).
// A == kRelu takes relu and relu6 alike, with m6 the upper bound: 127 for
// relu, f32(min(six_q, 127)) for relu6, so one warp-uniform operand and no
// branch tell them apart; the others clamp to [-128, 127]. Clamped before
// the rounding: rint is monotone and leaves integers fixed, so a clamp to
// 0, 127 or six_q there gives the same int8 as numpy's clamp, rint, clamp.
// The int8 value is the low byte.
template <int A, bool kMagic>
__device__ __forceinline__ uint32_t requant(int v, float mult, float m6) {
  const float f = to_f32<kMagic>(v);
  float y;
  if constexpr (A == kHswish) {
    const float a = __fmul_rn(f, mult);
    const float t = fminf(fmaxf(__fadd_rn(a, 3.0f), 0.0f), 6.0f);
    y = __fmul_rn(__fmul_rn(a, t), m6);
  } else {
    y = __fmul_rn(f, mult);
  }
  if constexpr (A == kRelu)
    y = fminf(fmaxf(y, 0.0f), m6);
  else
    y = fminf(fmaxf(y, -128.0f), 127.0f);
  return __float_as_uint(__fadd_rn(y, MAGIC_F));
}

// The quad of lanes' two rows (A: lane / 4, B: + 8) of 32 columns, as pieces
// of two bytes a lane and group (pa, pb: groups i..i+3) -> this lane's 16
// contiguous bytes: row A (even lane) or B (odd), columns 16 * (lane % 4 / 2)
// of the 32.
__device__ __forceinline__ uint4 quad_bytes16(const uint32_t* pa, const uint32_t* pb) {
  const uint32_t w[4] = {__byte_perm(pa[0], pa[1], 0x5410), __byte_perm(pb[0], pb[1], 0x5410),
                         __byte_perm(pa[2], pa[3], 0x5410), __byte_perm(pb[2], pb[3], 0x5410)};
  uint32_t o[4];
  quad_transpose(w, o);
  return make_uint4(__byte_perm(o[0], o[1], 0x5410), __byte_perm(o[2], o[3], 0x5410),
                    __byte_perm(o[0], o[1], 0x7632), __byte_perm(o[2], o[3], 0x7632));
}

// ---- consumers: the expansion ---------------------------------------------------------

// Bit 2i + h: row h of the thread's i-th row block (mb = wg + 2i) of the
// window lies inside the image. Computed once a unit.
__device__ __forceinline__ uint32_t in_image(const Geo& g, const Unit& x) {
  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int iy0 = x.oy0 * g.stride - g.pad, ix0 = x.ox0 * g.stride - g.pad;
  uint32_t mask = 0;
  for (int mb = wg, i = 0; mb < g.MP / 64; mb += 2, ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mb * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int py = quot(p, g.inv_pw), px = p - py * g.pw;
      if ((unsigned)(iy0 + py) < (unsigned)g.H && (unsigned)(ix0 + px) < (unsigned)g.W)
        mask |= 1u << (2 * i + h);
    }
  return mask;
}

// A 64 x 64 expansion block's epilogue: + bias, the requant, zero outside
// the image and past the chunk's live channels, into rows zA / zB of Z. A
// half with all of its columns live (kFull) runs without a branch, so that
// the requants of its groups interleave; a tail half skips its dead groups.
template <int A, bool kMagic, bool kFull>
__device__ __forceinline__ void expand_store(const int (&acc)[32], const int* bias,
                                             const float* mult, float m6, int col0, int live,
                                             bool inA, bool inB, unsigned char* z, int rA) {
  const int q = threadIdx.x & 3;
  uint32_t pa[8], pb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pa[i] = pb[i] = 0;
    if (kFull || col0 + 8 * i < live) {
      const int col = col0 + 8 * i + 2 * q;
      const int2 b = *reinterpret_cast<const int2*>(bias + col);
      const float2 mu = *reinterpret_cast<const float2*>(mult + col);
      const uint32_t va = __byte_perm(requant<A, kMagic>(acc[4 * i] + b.x, mu.x, m6),
                                      requant<A, kMagic>(acc[4 * i + 1] + b.y, mu.y, m6), 0x0040);
      const uint32_t vb = __byte_perm(requant<A, kMagic>(acc[4 * i + 2] + b.x, mu.x, m6),
                                      requant<A, kMagic>(acc[4 * i + 3] + b.y, mu.y, m6), 0x0040);
      pa[i] = inA ? va : 0u;
      pb[i] = inB ? vb : 0u;
    }
  }
  unsigned char* row = z + (rA + 8 * (q & 1)) * ZROW + col0 + 16 * (q >> 1);
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += 4)
    *reinterpret_cast<uint4*>(row + 8 * k0) = quad_bytes16(pa + k0, pb + k0);
}

// One expansion block of this warpgroup: row block mb of the window
// (A, the chunks of Cin) by 64-column half h of the stage's expand boxes
// (B), issued and committed into acc.
__device__ __forceinline__ void expand_issue(const Geo& g, uint32_t win, uint32_t sb, int mb,
                                             int h, int (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  hop::wgmma_fence();
  for (int ci = 0; ci < g.nci; ++ci) {
    const int ks = cdiv(min(KCH, g.Cx - KCH * ci), 32);
    const uint32_t a0 = win + ci * g.MP * ROW + mb * 64 * ROW;
    const uint32_t b0 = sb + ci * EBOX + h * BOX64;
    for (int k = 0; k < ks; ++k)
      hop::WgmmaS8<64>::mma(acc, hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128),
                            hop::gmma_desc(b0 + 32 * k, 16, 1024, hop::kSwizzle128));
  }
  hop::wgmma_commit();
}

// The expansion of the chunk in `stage` into Z: this warpgroup's row blocks
// of the window, a 64-column half at a time (halves past the chunk's live
// channels skipped), each awaited (with the previous chunk's projection) and
// followed by its epilogue. The magic conversion is taken for a half whose
// biases are within 2^22 - Cx * 2^14 in every lane of the warp.
template <int A>
__device__ __forceinline__ void expand_chunk(const Geo& g, uint32_t inmask, uint32_t win,
                                             const unsigned char* stage, unsigned char* z,
                                             int live, float m6) {
  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int* bias = reinterpret_cast<const int*>(stage + g.vec_off);
  const float* mult = reinterpret_cast<const float*>(stage + g.vec_off + VEC);
  const uint32_t sb = hop::saddr(stage);
  const int halves = cdiv(live, 64);
  const int room = (1 << 22) - g.Cx * (1 << 14);
  bool small[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * h + 8 * i + 2 * q;
      ok &= abs(bias[col]) < room && abs(bias[col + 1]) < room;
    }
    small[h] = __all_sync(0xffffffffu, ok);
  }
  for (int mb = wg, bit = 0; mb < g.MP / 64; mb += 2, bit += 2) {
    const int rA = mb * 64 + warp * 16 + (lane >> 2);
    const bool inA = (inmask >> bit) & 1u, inB = (inmask >> (bit + 1)) & 1u;
    for (int h = 0; h < halves; ++h) {
      int acc[32];
      expand_issue(g, win, sb, mb, h, acc);
      hop::wgmma_wait<0>();
      const bool full = live >= 64 * (h + 1);
      if (small[h] && full)
        expand_store<A, true, true>(acc, bias, mult, m6, 64 * h, live, inA, inB, z, rA);
      else if (small[h])
        expand_store<A, true, false>(acc, bias, mult, m6, 64 * h, live, inA, inB, z, rA);
      else
        expand_store<A, false, false>(acc, bias, mult, m6, 64 * h, live, inA, inB, z, rA);
    }
  }
}

// ---- consumers: the depthwise ---------------------------------------------------------

// A thread's share of a chunk's depthwise: group j (8 channels) of the
// chunk's G live groups, for tile pixels t / G + k * S (k < 8, S = 256 / G
// pixel slots). Decoded once a unit (and again for a narrower last chunk).
struct Items {
  int j;
  bool one;    // at most one pixel a thread: pix[1..7] are -1
  int pix[8];  // tile pixel m | its window pixel of tap (0, 0) << 8, or -1
};

__device__ __forceinline__ Items decode(const Geo& g, const Unit& x, int G) {
  const int t = threadIdx.x, S = CONSUMERS / G;
  Items it;
  const int slot = t / G;
  it.j = t - slot * G;
  it.one = S >= g.th * g.tw;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int m = slot + k * S;
    it.pix[k] = -1;
    if (t < S * G && m < g.th * g.tw) {
      const int ih = quot(m, g.inv_tw), iw = m - ih * g.tw;
      if (x.oy0 + ih < g.Ho && x.ox0 + iw < g.Wo)
        it.pix[k] = m | (ih * g.stride * g.pw + iw * g.stride) << 8;
    }
  }
  return it;
}

// 8 channels (group j) of window pixel p: Z's padded row, or (kSwz) the
// swizzled window itself (the identity).
template <bool kSwz>
__device__ __forceinline__ uint2 tap8(const unsigned char* src, int p, int j) {
  if constexpr (kSwz)
    return *reinterpret_cast<const uint2*>(src + p * ROW + ((((j >> 1) ^ (p & 7)) << 4) |
                                                            ((j & 1) << 3)));
  else
    return *reinterpret_cast<const uint2*>(src + p * ZROW + 8 * j);
}

// The k*k taps of NP pixels into acc (the bias already there): a tap
// quad's eight weight words held for the pixels, each pixel's four
// 8-byte tap loads transposed in bytes, dp4a; then the last tap against its
// lane-placed words. A pixel that is none (pix[p] < 0) reads window pixel 0
// and is not stored: no branch stands between the pixels' sums.
template <int K, bool kSwz, int NP>
__device__ __forceinline__ void dw_taps(const Geo& g, const int (&pix)[NP], int j,
                                        const unsigned char* src, const unsigned char* tab,
                                        int (&acc)[NP][8]) {
  constexpr int NFQ = K * K / 4;
#pragma unroll
  for (int qd = 0; qd <= NFQ; ++qd) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(tab + qd * VEC + 32 * j);
    const uint4 w1 = *reinterpret_cast<const uint4*>(tab + qd * VEC + 32 * j + 16);
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int zo = max(pix[p], 0) >> 8;
      if (qd < NFQ) {
        uint2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * qd + i;
          v[i] = tap8<kSwz>(src, zo + (t / K) * g.pw + t % K, j);
        }
        uint32_t lo[4], hi[4];
        transpose4({v[0].x, v[1].x, v[2].x, v[3].x}, lo);
        transpose4({v[0].y, v[1].y, v[2].y, v[3].y}, hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[p][e] = __dp4a(int(lo[e]), int(w[e]), acc[p][e]);
          acc[p][4 + e] = __dp4a(int(hi[e]), int(w[4 + e]), acc[p][4 + e]);
        }
      } else {
        const uint2 v = tap8<kSwz>(src, zo + (K - 1) * g.pw + K - 1, j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[p][e] = __dp4a(int(v.x), int(w[e]), acc[p][e]);
          acc[p][4 + e] = __dp4a(int(v.y), int(w[4 + e]), acc[p][4 + e]);
        }
      }
    }
  }
}

// The named requant A of NP pixels' 8 sums -> 8 int8 bytes each.
template <int A, bool kMagic, int NP>
__device__ __forceinline__ void requant8(const int (&a)[NP][8], const float (&mu)[8], float m6,
                                         uint2 (&o)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = requant<A, kMagic>(a[p][e], mu[e], m6);
    o[p] = make_uint2(low_bytes(v[0], v[1], v[2], v[3]), low_bytes(v[4], v[5], v[6], v[7]));
  }
}

// A round of the depthwise of chunk c: NP pixels of this thread's group j,
// + bias, the named requant; full: into the A panel (row m, swizzled);
// pool: into z at the output pixel, and added to `sum`.
template <int K, bool kSwz, int MODE, int NP>
__device__ __forceinline__ void dw_round(const Geo& g, const int (&pix)[NP], int j,
                                         const Unit& x, const unsigned char* src,
                                         unsigned char* apanel, const unsigned char* tab,
                                         const int (&bias)[8], const float (&mult)[8],
                                         bool small, int c, float m6, int8_t* __restrict__ zs,
                                         int (&sum)[8]) {
  int acc[NP][8];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = bias[e];
  dw_taps<K, kSwz, NP>(g, pix, j, src, tab, acc);
  uint2 out[NP];
  if (g.act == kHswish) {
    if (small)
      requant8<kHswish, true, NP>(acc, mult, m6, out);
    else
      requant8<kHswish, false, NP>(acc, mult, m6, out);
  } else {
    if (small)
      requant8<kRelu, true, NP>(acc, mult, m6, out);
    else
      requant8<kRelu, false, NP>(acc, mult, m6, out);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (pix[p] < 0) continue;
    const int m = pix[p] & 0xff;
    const uint2 o = out[p];
    if constexpr (MODE == kFull) {
      *reinterpret_cast<uint2*>(apanel + m * ROW + ((((j >> 1) ^ (m & 7)) << 4) |
                                                    ((j & 1) << 3))) = o;
    } else {
      const int ih = quot(m, g.inv_tw), iw = m - ih * g.tw;
      const long long px = ((long long)x.n * g.Ho + x.oy0 + ih) * g.Wo + x.ox0 + iw;
      *reinterpret_cast<uint2*>(zs + px * g.Ep + c * KCH + 8 * j) = o;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[e] += (int)(int8_t)(o.x >> (8 * e));
        sum[4 + e] += (int)(int8_t)(o.y >> (8 * e));
      }
    }
  }
}

// The depthwise of chunk c from src (Z, or the window for the identity) for
// this thread's pixels: one round of one pixel where a thread has at most
// one, else rounds of four.
template <int K, bool kSwz, int MODE>
__device__ __forceinline__ void dw_chunk(const Geo& g, const Items& it, const Unit& x,
                                         const unsigned char* src, unsigned char* apanel,
                                         const unsigned char* stage, int c, float m6,
                                         int8_t* __restrict__ zs, int (&sum)[8]) {
  const int j = it.j;
  const int4* bp = reinterpret_cast<const int4*>(stage + g.vec_off + 2 * VEC + 32 * j);
  const float4* mp = reinterpret_cast<const float4*>(stage + g.vec_off + 3 * VEC + 32 * j);
  const int4 b0 = bp[0], b1 = bp[1];
  const float4 m0 = mp[0], m1 = mp[1];
  const int bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const float mult[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  bool small = true;
#pragma unroll
  for (int e = 0; e < 8; ++e) small &= abs(bias[e]) <= SMALL_BIAS;
  const unsigned char* tab = stage + g.dw_off;
  if (it.one) {
    if (it.pix[0] < 0) return;
    const int pix[1] = {it.pix[0]};
    dw_round<K, kSwz, MODE, 1>(g, pix, j, x, src, apanel, tab, bias, mult, small, c, m6, zs,
                               sum);
    return;
  }
#pragma unroll
  for (int r0 = 0; r0 < 8; r0 += 4) {
    const int pix[4] = {it.pix[r0], it.pix[r0 + 1], it.pix[r0 + 2], it.pix[r0 + 3]};
    if (pix[0] < 0 && pix[1] < 0 && pix[2] < 0 && pix[3] < 0) continue;
    dw_round<K, kSwz, MODE, 4>(g, pix, j, x, src, apanel, tab, bias, mult, small, c, m6, zs,
                               sum);
  }
}

// ---- consumers: the projection and the epilogue ------------------------------------------

// The projection accumulators: a 128- or 64-column slice, then 32, 16, 8.
struct Acc {
  int big[64], s32[16], s16[8], s8[4];
};

__device__ __forceinline__ int (&first32(int (&a)[64]))[32] {
  return *reinterpret_cast<int(*)[32]>(&a[0]);
}

// This warpgroup's share of a chunk's projection (its 64 rows of the A panel
// at a0, the part's weight rows at b), issued and committed, not awaited.
__device__ __forceinline__ void project(const Geo& g, uint32_t a0, uint32_t b, int ks, Acc& acc) {
  const uint32_t b8 = b + g.nbig * BOX64;
  hop::wgmma_fence();
  for (int k = 0; k < ks; ++k) {
    const uint64_t da = hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128);
    const uint64_t db = hop::gmma_desc(b + 32 * k, 16, 1024, hop::kSwizzle128);
    if (g.nbig == 2)
      hop::WgmmaS8<128>::mma(acc.big, da, db);
    else if (g.nbig == 1)
      hop::WgmmaS8<64>::mma(first32(acc.big), da, db);
    uint32_t so = b8 + 32 * k;
    if (g.nsmall & 4) {
      hop::WgmmaS8<32>::mma(acc.s32, da, hop::gmma_desc(so, 16, 1024, hop::kSwizzle128));
      so += 4 * BOX8;
    }
    if (g.nsmall & 2) {
      hop::WgmmaS8<16>::mma(acc.s16, da, hop::gmma_desc(so, 16, 1024, hop::kSwizzle128));
      so += 2 * BOX8;
    }
    if (g.nsmall & 1)
      hop::WgmmaS8<8>::mma(acc.s8, da, hop::gmma_desc(so, 16, 1024, hop::kSwizzle128));
  }
  hop::wgmma_commit();
}

// An epilogue row: its output pixel (-1: none) and, for the residual, its
// window pixel.
struct OutRow {
  long long pix;
  int wp;
};

__device__ __forceinline__ OutRow out_row(const Geo& g, const Unit& x, int m) {
  OutRow o{-1, 0};
  if (m >= g.th * g.tw) return o;
  const int ih = quot(m, g.inv_tw), iw = m - ih * g.tw;
  const int oy = x.oy0 + ih, ox = x.ox0 + iw;
  if (oy >= g.Ho || ox >= g.Wo) return o;
  o.pix = ((long long)x.n * g.Ho + oy) * g.Wo + ox;
  o.wp = (ih + g.pad) * g.pw + iw + g.pad;
  return o;
}

// The residual's BYTES (4, 8 or 16) at channel col (a multiple of BYTES) of
// row o: from the staged window (win, the full pass) or from x (pass 2).
template <int BYTES>
__device__ __forceinline__ auto residual_at(const Geo& g, const Ptrs& p,
                                            const unsigned char* win, const OutRow& o, int col) {
  using T = typename std::conditional<
      BYTES == 16, uint4, typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
  if (win != nullptr)
    return *reinterpret_cast<const T*>(win + (col >> 7) * g.MP * ROW + o.wp * ROW +
                                       ((((col & 127) >> 4) ^ (o.wp & 7)) << 4) + (col & 15));
  return __ldg(reinterpret_cast<const T*>(p.x + o.pix * g.Cx + col));
}

// The linear requant of this lane's pieces (2 bytes of rows A and B a group
// of 8 columns) of an N-column slice at column c of the part (its bias at
// part, its multiplier at part + PART).
template <int N, bool kMagic>
__device__ __forceinline__ void out_pieces(const int (&acc)[N / 2], const unsigned char* part,
                                           int c, uint32_t (&pa)[N / 8], uint32_t (&pb)[N / 8]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = 4 * (c + 8 * i + 2 * q);
    const int2 b = *reinterpret_cast<const int2*>(part + col);
    const float2 mu = *reinterpret_cast<const float2*>(part + PART + col);
    pa[i] = __byte_perm(requant<kLinear, kMagic>(acc[4 * i] + b.x, mu.x, 0.0f),
                        requant<kLinear, kMagic>(acc[4 * i + 1] + b.y, mu.y, 0.0f), 0x0040);
    pb[i] = __byte_perm(requant<kLinear, kMagic>(acc[4 * i + 2] + b.x, mu.x, 0.0f),
                        requant<kLinear, kMagic>(acc[4 * i + 3] + b.y, mu.y, 0.0f), 0x0040);
  }
}

// + bias, the linear requant, + the saturating residual, stored: the N
// columns at col0 of rows A and B. The accumulator of a warpgroup thread
// (warp w, lane l) holds, for each 8-column group i, columns 8i + 2(l%4) and
// +1 of rows 16w + l/4 (registers 4i, 4i+1) and 16w + l/4 + 8 (4i+2, 4i+3).
// From 32 columns on the quad transposes its bytes so that a lane stores 16
// contiguous bytes of one row (as two 8-byte halves unless `wide`: Cout and
// the part's first column multiples of 16); below, lane pairs swap pieces
// and store 4 bytes.
template <int N>
__device__ __forceinline__ void store_slice(const Geo& g, const Ptrs& p, const int (&acc)[N / 2],
                                            int col0, int c0, const OutRow& A, const OutRow& B,
                                            const unsigned char* win, const unsigned char* part,
                                            bool magic, bool wide) {
  const int q = threadIdx.x & 3;
  uint32_t pa[N / 8], pb[N / 8];
  if (magic)
    out_pieces<N, true>(acc, part, col0 - c0, pa, pb);
  else
    out_pieces<N, false>(acc, part, col0 - c0, pa, pb);
  const OutRow& row = (q & 1) ? B : A;
  if constexpr (N >= 32) {
#pragma unroll
    for (int k0 = 0; k0 < N / 8; k0 += 4) {
      uint4 v = quad_bytes16(pa + k0, pb + k0);
      if (row.pix < 0) continue;
      const int col = col0 + 8 * k0 + 16 * (q >> 1);
      int8_t* dst = p.out + row.pix * g.Cout + col;
      if (wide) {
        if (g.residual) {
          const uint4 r = residual_at<16>(g, p, win, row, col);
          v = make_uint4(__vaddss4(v.x, r.x), __vaddss4(v.y, r.y), __vaddss4(v.z, r.z),
                         __vaddss4(v.w, r.w));
        }
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        if (g.residual) {
          const uint2 r0 = residual_at<8>(g, p, win, row, col);
          const uint2 r1 = residual_at<8>(g, p, win, row, col + 8);
          v = make_uint4(__vaddss4(v.x, r0.x), __vaddss4(v.y, r0.y), __vaddss4(v.z, r1.x),
                         __vaddss4(v.w, r1.y));
        }
        *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
        *reinterpret_cast<uint2*>(dst + 8) = make_uint2(v.z, v.w);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      // an even lane takes row A's pieces of itself and lane q + 1, an odd
      // lane row B's of lane q - 1 and itself
      const uint32_t r = __shfl_xor_sync(0xffffffffu, (q & 1) ? pa[k] : pb[k], 1);
      uint32_t v = (q & 1) ? __byte_perm(r, pb[k], 0x5410) : __byte_perm(pa[k], r, 0x5410);
      if (row.pix < 0) continue;
      const int col = col0 + 8 * k + 2 * (q & 2);
      if (g.residual) v = __vaddss4(v, residual_at<4>(g, p, win, row, col));
      *reinterpret_cast<uint32_t*>(p.out + row.pix * g.Cout + col) = v;
    }
  }
}

// Every slice of the unit's part; `part` holds its projection bias and
// multiplier; `magic`: every sum + bias of the launch is within 2^22
// (pw_magic).
__device__ __forceinline__ void epilogue(const Geo& g, const Ptrs& p, const Unit& x, Acc& acc,
                                         int r0, const unsigned char* win,
                                         const unsigned char* part, bool magic) {
  const OutRow A = out_row(g, x, r0), B = out_row(g, x, r0 + 8);
  const bool wide = g.Cout % 16 == 0 && x.c0 % 16 == 0;
  int col = x.c0;
  if (g.nbig == 2) {
    store_slice<128>(g, p, acc.big, col, x.c0, A, B, win, part, magic, wide);
    col += 128;
  } else if (g.nbig == 1) {
    store_slice<64>(g, p, first32(acc.big), col, x.c0, A, B, win, part, magic, wide);
    col += 64;
  }
  if (g.nsmall & 4) {
    store_slice<32>(g, p, acc.s32, col, x.c0, A, B, win, part, magic, wide);
    col += 32;
  }
  if (g.nsmall & 2) {
    store_slice<16>(g, p, acc.s16, col, x.c0, A, B, win, part, magic, wide);
    col += 16;
  }
  if (g.nsmall & 1) store_slice<8>(g, p, acc.s8, col, x.c0, A, B, win, part, magic, wide);
}

// Whether the magic conversion is exact for every projection sum + bias of
// the launch (|sum| <= E * 2^14): all |pb| < 2^22 - E * 2^14. Every thread of
// the block takes a share of Cout; the answer is the block's.
__device__ __forceinline__ bool pw_magic(const Geo& g, const int* __restrict__ pb) {
  const long long room = (1ll << 22) - (long long)g.E * (1 << 14);
  bool ok = true;
  for (int c = threadIdx.x; c < g.Cout; c += blockDim.x) ok &= llabs((long long)pb[c]) < room;
  return __syncthreads_and(ok) != 0;
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc.big[i] = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc.s32[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc.s16[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc.s8[i] = 0;
}

// ---- consumers: the passes ---------------------------------------------------------------

// Every unit of the full pass (MODE kFull) or of pass 1 (kPool) on this block.
template <int K, int MODE>
__device__ inline void consume(const Geo& g, const Rings& r, const Ptrs& p, float m6_exp,
                               float m6_dw, bool magic) {
  const int t = threadIdx.x, wg = warpgroup(), lane = t & 31;
  const int r0 = wg * 64 + ((t & 127) >> 5) * 16 + (lane >> 2);  // the epilogue's row A
  const bool rows = wg * 64 < g.th * g.tw;  // this warpgroup's projection rows hold pixels
  const int units = units_of(g);
  Ring wring, bring;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    uint32_t parity;
    const uint32_t ws = wring.next(g.ws, parity);
    hop::mbar_wait(r.wfull + ws, parity);
    const unsigned char* win = r.win + ws * g.win_bytes;
    Acc acc;
    if constexpr (MODE == kFull) zero(acc);
    int G = 0, held = -1;
    Items it;
    const uint32_t inmask = g.identity ? 0u : in_image(g, x);
    for (int c = 0; c < g.nec; ++c) {
      const int live = min(KCH, g.E - KCH * c);
      if (live / 8 != G) {
        G = live / 8;
        it = decode(g, x, G);
      }
      uint32_t bp;
      const int bs = bring.next(g.bs, bp);
      hop::mbar_wait(r.bfull + bs, bp);
      const unsigned char* stage = r.b + bs * g.stage_bytes;
      if (!g.identity) {
        if (g.act_exp == kHswish)
          expand_chunk<kHswish>(g, inmask, hop::saddr(win), stage, r.z, live, m6_exp);
        else
          expand_chunk<kRelu>(g, inmask, hop::saddr(win), stage, r.z, live, m6_exp);
      }
      if constexpr (MODE == kFull) {
        hop::wgmma_wait<0>();  // the previous chunk's projection: the A panel is free
        if (held >= 0) hop::mbar_arrive(r.bempty + held);
        held = bs;
      }
      hop::named_bar_sync(1, CONSUMERS);  // Z is complete
      int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (g.identity)
        dw_chunk<K, true, MODE>(g, it, x, win, r.a, stage, c, m6_dw, p.zs, sum);
      else
        dw_chunk<K, false, MODE>(g, it, x, r.z, r.a, stage, c, m6_dw, p.zs, sum);
      int* red = reinterpret_cast<int*>(r.a);
      const int S = CONSUMERS / G;
      if constexpr (MODE == kPool) {
        hop::mbar_arrive(r.bempty + bs);  // this thread's reads of the stage are done
        if (t < S * G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) red[t * 8 + e] = sum[e];
        }
      } else {
        hop::fence_proxy_async_smem();  // the panel's stores, for wgmma
      }
      hop::named_bar_sync(1, CONSUMERS);  // the panel (pass 1: the sums) is complete
      if constexpr (MODE == kPool) {
        if (t < G * 8) {  // channel t of the chunk: its threads' sums
          const int j = t >> 3, e = t & 7;
          int s = 0;
          for (int tt = j; tt < S * G; tt += G) s += red[tt * 8 + e];
          atomicAdd(p.pooled + (long long)x.n * g.E + c * KCH + t, s);
        }
      } else if (rows) {
        project(g, hop::saddr(r.a) + wg * 64 * ROW, hop::saddr(stage) + g.prj_off,
                cdiv(live, 32), acc);
      }
    }
    if constexpr (MODE == kFull) {
      hop::wgmma_wait<0>();
      hop::mbar_arrive(r.bempty + held);
      if (rows) epilogue(g, p, x, acc, r0, win, win + g.pb_off, magic);
    }
    hop::mbar_arrive(r.wempty + ws);
  }
}

// clamp(rint(f32(z) * gate)) of 16 int8 channels.
__device__ __forceinline__ uint4 gate16(const uint4& z, const float (&gt)[16]) {
  const uint32_t w[4] = {z.x, z.y, z.z, z.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int zi = (int)(int8_t)(w[i] >> (8 * b));
      const float y = __fmul_rn(__fsub_rn(__int_as_float(zi + MAGIC_I), MAGIC_F), gt[4 * i + b]);
      v[b] = __float_as_uint(__fadd_rn(fminf(fmaxf(y, -128.0f), 127.0f), MAGIC_F));
    }
    o[i] = low_bytes(v[0], v[1], v[2], v[3]);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Every unit of pass 2 on this block: each warpgroup gates its own 64 rows
// of a stage's z tile in place (16 channels a thread, four rows of 16 apart),
// then multiplies them by the stage's weight; a stage is released once the
// product that read it is done (the unit's last once the epilogue has read
// the part's bias and multiplier there).
__device__ inline void consume_gated(const Geo& g, const Rings& r, const Ptrs& p, bool magic) {
  const int t = threadIdx.x, wg = warpgroup(), lane = t & 31, tl = t & 127;
  const int r0 = wg * 64 + (tl >> 5) * 16 + (lane >> 2);
  const int pixels = g.th * g.tw;
  const bool rows = wg * 64 < pixels;
  const int j16 = tl & 7;  // this thread's 16 channels of a chunk
  const int units = units_of(g);
  Ring bring;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    Acc acc;
    zero(acc);
    int held = -1;
    for (int c = 0; c < g.nec; ++c) {
      const int live = min(KCH, g.E - KCH * c);
      uint32_t bp;
      const int s = bring.next(GATED_SLOTS, bp);
      hop::mbar_wait(r.bfull + s, bp);
      unsigned char* stage = r.b + s * g.stage_bytes;
      if (rows && 16 * j16 < live) {
        const float4* gp = reinterpret_cast<const float4*>(stage + g.vec_off + 64 * j16);
        float gt[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = gp[i];
          gt[4 * i] = v.x; gt[4 * i + 1] = v.y; gt[4 * i + 2] = v.z; gt[4 * i + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // rows past the tile's pixels too: no branch
          const int m = wg * 64 + (tl >> 3) + 16 * i;
          uint4* a = reinterpret_cast<uint4*>(stage + m * ROW + ((j16 ^ (m & 7)) << 4));
          *a = gate16(*a, gt);
        }
      }
      hop::fence_proxy_async_smem();  // the gated rows, for wgmma
      hop::named_bar_sync(2 + wg, 128);
      if (rows)
        project(g, hop::saddr(stage) + wg * 64 * ROW, hop::saddr(stage) + g.prj_off,
                cdiv(live, 32), acc);
      hop::wgmma_wait<1>();  // the previous chunk's product
      if (held >= 0) hop::mbar_arrive(r.bempty + held);
      held = s;
    }
    hop::wgmma_wait<0>();
    if (rows)
      epilogue(g, p, x, acc, r0, nullptr, r.b + held * g.stage_bytes + g.pb_off, magic);
    hop::mbar_arrive(r.bempty + held);  // after the epilogue's reads of the part's vectors
  }
}

// One pass of every unit of a block by each role: the consumer warpgroups,
// or the producer warpgroup's window producer (its thread 0; pass 2's ring)
// and weight producer (thread 32), under v3w::by_role's setmaxnreg.
template <int K, int MODE>
__device__ __forceinline__ void run(const Geo& g, const Rings& r, const Maps* m, const Ptrs& p,
                                    float m6_exp, float m6_dw, bool magic) {
  v3w::by_role([&](auto consumer) {
    if constexpr (decltype(consumer)::value) {
      if constexpr (MODE == kGated)
        consume_gated(g, r, p, magic);
      else
        consume<K, MODE>(g, r, p, m6_exp, m6_dw, magic);
    } else {
      const int t = threadIdx.x - CONSUMERS;
      if constexpr (MODE == kGated) {
        if (t == 0) produce_gated(g, r, m);
      } else {
        if (t == 0)
          produce_window(g, r, m);
        else if (t == 32)
          produce_weights(g, r, m);
      }
    }
  });
}

// ---- host ---------------------------------------------------------------------------

// The tensors a launch reads through TMA.
struct Tensors {
  const void *x, *ewt, *eb, *em, *dwt, *db, *dm, *pwt, *pb, *pm, *gate, *zs;
};

// The maps of one pass: x (N, H, W, Cx) windows, the K-major expand weight
// (E, Cx), the K-major projection weight (Cout, Ep) in 64- and 8-row boxes,
// the depthwise table (nq, E) int32, the chunk vectors (E), the gates (N, E)
// f32 and the pre-gate tensor (N, Ho, Wo, Ep). The weights' maps are made
// once for a prepared launch (make_weight_maps); those of x, the gates and
// the pre-gate tensor, which name a call's buffers, at each launch
// (make_call_maps).
inline cudaError_t make_weight_maps(Maps& m, const Tensors& t, const Geo& g) {
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t e = cudaSuccess;
  const auto vec = [&](CUtensorMap* map, CUtensorMapDataType type, const void* v, int n,
                       int rows) {  // rows of n 4-byte items; boxes of 128 (a part) x rows or x 1
    const cuuint64_t d[3] = {(cuuint64_t)n, (cuuint64_t)rows, 1};
    const cuuint64_t s[2] = {(cuuint64_t)n * 4, (cuuint64_t)n * rows * 4};
    const bool part = map == &m.pb || map == &m.pm;
    const cuuint32_t b[3] = {(cuuint32_t)(part ? g.cw : KCH),
                             (cuuint32_t)(map == &m.dw ? rows : 1), 1};
    return hop::make_map_3d(map, type, v, d, s, b, CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  const auto rows = [&](CUtensorMap* map, const void* w, int k, int n, int box) {
    const cuuint64_t d[3] = {(cuuint64_t)k, (cuuint64_t)n, 1};
    const cuuint64_t s[2] = {(cuuint64_t)k, (cuuint64_t)k * n};
    const cuuint32_t b[3] = {(cuuint32_t)KCH, (cuuint32_t)box, 1};
    return hop::make_map_3d(map, u8, w, d, s, b, sw);
  };
  if (g.mode != kGated) {
    if (!g.identity) {
      if ((e = rows(&m.ew, t.ewt, g.Cx, g.E, KCH)) != cudaSuccess) return e;
      if ((e = vec(&m.eb, CU_TENSOR_MAP_DATA_TYPE_INT32, t.eb, g.E, 1)) != cudaSuccess) return e;
      if ((e = vec(&m.em, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, t.em, g.E, 1)) != cudaSuccess) return e;
    }
    if ((e = vec(&m.dw, CU_TENSOR_MAP_DATA_TYPE_INT32, t.dwt, g.E, g.nq)) != cudaSuccess) return e;
    if ((e = vec(&m.db, CU_TENSOR_MAP_DATA_TYPE_INT32, t.db, g.E, 1)) != cudaSuccess) return e;
    if ((e = vec(&m.dm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, t.dm, g.E, 1)) != cudaSuccess) return e;
  }
  if (g.mode != kPool) {
    if (g.nbig > 0 && (e = rows(&m.pw64, t.pwt, g.Ep, g.Cout, 64)) != cudaSuccess) return e;
    if (g.nsmall > 0 && (e = rows(&m.pw8, t.pwt, g.Ep, g.Cout, 8)) != cudaSuccess) return e;
    if ((e = vec(&m.pb, CU_TENSOR_MAP_DATA_TYPE_INT32, t.pb, g.Cout, 1)) != cudaSuccess) return e;
    if ((e = vec(&m.pm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, t.pm, g.Cout, 1)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

inline cudaError_t make_call_maps(Maps& m, const Tensors& t, const Geo& g) {
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (g.mode != kGated) {
    const cuuint64_t xd[4] = {(cuuint64_t)g.Cx, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.N};
    const cuuint64_t xs[3] = {(cuuint64_t)g.Cx, (cuuint64_t)g.W * g.Cx,
                              (cuuint64_t)g.H * g.W * g.Cx};
    const cuuint32_t xb[4] = {(cuuint32_t)KCH, (cuuint32_t)g.pw, (cuuint32_t)g.ph, 1};
    return hop::make_map_4d(&m.x, u8, t.x, xd, xs, xb, sw);
  }
  const cuuint64_t gd[3] = {(cuuint64_t)g.E, (cuuint64_t)g.N, 1};
  const cuuint64_t gs[2] = {(cuuint64_t)g.E * 4, (cuuint64_t)g.E * g.N * 4};
  const cuuint32_t gb[3] = {(cuuint32_t)KCH, 1, 1};
  cudaError_t e = hop::make_map_3d(&m.gate, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, t.gate, gd, gs, gb,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const cuuint64_t zd[4] = {(cuuint64_t)g.Ep, (cuuint64_t)g.Wo, (cuuint64_t)g.Ho,
                            (cuuint64_t)g.N};
  const cuuint64_t zs[3] = {(cuuint64_t)g.Ep, (cuuint64_t)g.Wo * g.Ep,
                            (cuuint64_t)g.Ho * g.Wo * g.Ep};
  const cuuint32_t zb[4] = {(cuuint32_t)KCH, (cuuint32_t)g.tw, (cuuint32_t)g.th, 1};
  return hop::make_map_4d(&m.z, u8, t.zs, zd, zs, zb, sw);
}

}  // namespace v3i8
}  // namespace mnk
