// The int8 fused depthwise-separable block on Hopper (separable_block_i8.cu):
// the bf16 tile's plan and roles (separable_wgmma.cuh) with int8 operands,
// exact integer sums and the exact requant of quant/ops.py.
//
// Work is split into units, as in the bf16 tile: an output tile of TH x TW
// pixels (rows of the N * Ho output rows, columns of Wo) times a part of the
// output channels. A persistent block owns one unit at a time and:
//   1. stages the input window of its tile ((TH-1)s+3 rows x (TW-1)s+3
//      columns x up to 128 channels, one TMA box a chunk of 128 channels;
//      out-of-range columns and rows load as zeros) through a ring of WS
//      slots. The box starts at input row (R0 % Ho) * s - pad_lo of the
//      first pixel's image (TF-SAME pad_lo: 1 at stride 1 and on an odd input
//      at stride 2), so odd inputs work; tap rows of another image read a
//      zero row;
//   2. computes the int8 depthwise 3x3 of its TM = 64 * NWG pixels over all
//      of Cin once into the A panel: TM x Cin int8, K-major, 128-byte
//      swizzled (a row of an atom holds 128 channels); each consumer
//      warpgroup its own 64 rows, the rows its wgmma reads, so the
//      warpgroups run apart (one's depthwise beside another's product and
//      epilogue). A thread takes 16 channels of a pixel: the nine 16-byte
//      tap loads go through int8_tile.cuh's depthwise stage (dw_quad, dw16),
//      which the standalone int8 depthwise kernel runs too: dp4a over
//      byte-transposed taps from the int32 bias, exactly, and the requant
//      with the magic-number conversions. The weights come from a table in shared
//      memory, transposed once a block (TAB_GROUP): held in registers for a
//      thread's four pixels with one or two consumer warpgroups, read a
//      quad of channels at a time with four (their registers). The requant
//      is quant/ops.py's: v = float32(acc) * m, clamped to [0, six_q]
//      (ReLU6) and to [-128, 127], rounded half to even. The conversions
//      run on the full-rate adders: float32(acc) is float(0x4B400000 + acc)
//      - 1.5 * 2^23, exact while |acc| < 2^22, taken for a 16-channel group
//      whose biases are within 2^21 (nine taps add at most 9 * 128 * 128;
//      the table's bias carries the 0x4B400000); a group with a larger bias
//      converts with __int2float_rn. The clamped value is rounded by adding
//      1.5 * 2^23 (round to nearest even), and its low byte is the int8
//      result: clamping to an integer bound before rounding equals clamping
//      after;
//   3. walks its output channels in slices of 128, 64, 32, 16 or 8 columns
//      (64 at most with four consumer warpgroups; wgmma m64nNk32 s8 x s8 ->
//      s32): the pointwise weight is read K-major, (Cout, Cin), as s8 wgmma
//      reads both operands (no transpose for integer types); it streams
//      through a ring of BS slots of 128 K bytes x N rows (TMA boxes of 64 or
//      8 rows, 128-byte swizzled). Columns of K past Cin load as zeros from
//      the weight, so the A panel's columns past Cin are never written (any
//      int8 there times zero adds nothing);
//   4. epilogue: + int32 bias and the requant, its conversion by the magic
//      number where every pointwise sum is within 2^22 (|acc| <= Cin * 2^14:
//      Cin <= 128 with small biases), else by __int2float_rn (the sum reaches
//      2^24 at Cin 1024); ReLU6 or the linear [-128, 127] clamp; the quad of
//      lanes transposes its bytes so that each lane stores 16 contiguous
//      bytes of one output row.
// Roles as in the bf16 tile: NWG (1, 2 or 4) consumer warpgroups, a window
// producer warp and a weight producer warp (lane 0 of each); setmaxnreg gives
// the consumers the producers' registers (232 and 40 with two, 112 and 24 with
// four).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_tile.cuh"
#include "separable_wgmma.cuh"

namespace mnk {
namespace si8 {

using sw::cdiv;
using sw::Plan;
using sw::slice_width;
using sw::Unit;

constexpr int KCH = 128;                 // channels a window chunk, an A atom, a weight stage's K
constexpr int ROW_BYTES = 128;           // one A row of an atom
constexpr int BSTAGE_BYTES = 128 * 128;  // a weight stage: up to 128 rows of 128 K bytes
constexpr int BOX64_BYTES = 64 * 128;    // a 64-row weight box
constexpr int BOX8_BYTES = 8 * 128;      // an 8-row weight box
constexpr int ZERO_BYTES = 3 * KCH;      // three zero pixels of a window row
constexpr int SMEM_LIMIT = sw::SMEM_LIMIT;
// The shared depthwise stage (int8_tile.cuh), also read as si8:: by the V3 tile.
using mnk::low_bytes;
using mnk::MAGIC_F;
using mnk::MAGIC_I;
using mnk::transpose4;
// The depthwise table in shared memory, a group of 16 channels: taps 0-3 and
// 4-7 transposed, tap 8 in its lane, bias + 0x4B400000, multiplier (16 words
// each), and four words, one a 4-channel word, that are 1 where all four
// biases are within SMALL_BIAS; 336 bytes, so that the 8 groups of a chunk
// fall on distinct banks.
constexpr int TAB_GROUP = 336;

struct Geo {
  int N, H, W, Cin, Cout, stride, pad_h, pad_w, Ho, Wo, rows;
  int nwg, th, tw, split, cw, ws, bs;
  int max_n;  // widest output slice: 128, or 64 with four consumer warpgroups (registers)
  int kw;  // window box channels: min(128, Cin); Cin a multiple of 16
  int tiles_c, units, wh, ww, nchunks, kpc, nranges;
  int win_bytes, win_stride, a_bytes, atom_bytes, b_off, w_off, tab_off, bar_off, zero_off;
  int smem_bytes;
};

__host__ __device__ inline Geo make_geo(int N, int H, int W, int Cin, int Cout, int stride,
                                        const Plan& p) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.stride = stride;
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.pad_h = same_pad_lo(H, stride, g.Ho);
  g.pad_w = same_pad_lo(W, stride, g.Wo);
  g.rows = N * g.Ho;
  g.nwg = p.nwg; g.th = p.th; g.tw = p.tw; g.split = p.split; g.cw = p.cw;
  g.ws = p.ws; g.bs = p.bs;
  g.max_n = p.nwg == 4 ? 64 : 128;
  g.kw = Cin < KCH ? Cin : KCH;
  g.tiles_c = cdiv(g.Wo, p.tw);
  g.units = cdiv(g.rows, p.th) * g.tiles_c * p.split;
  g.wh = (p.th - 1) * stride + 3;
  g.ww = (p.tw - 1) * stride + 3;
  g.nchunks = cdiv(Cin, KCH);
  g.kpc = p.kp / KCH;
  g.nranges = cdiv(g.nchunks, g.kpc);
  g.win_bytes = g.wh * g.ww * g.kw;
  g.win_stride = cdiv(g.win_bytes, 1024) * 1024;
  g.atom_bytes = 64 * p.nwg * ROW_BYTES;
  g.a_bytes = g.atom_bytes * g.kpc;
  g.b_off = g.a_bytes;
  g.w_off = g.b_off + p.bs * BSTAGE_BYTES;
  g.tab_off = g.w_off + p.ws * g.win_stride;
  g.bar_off = g.tab_off + Cin / 16 * TAB_GROUP;
  g.zero_off = g.bar_off + 128;
  // + 1024 to align the base, + 128 for the barriers and a flag, + 3 zero pixels
  g.smem_bytes = 1024 + g.zero_off + ZERO_BYTES;
  return g;
}

// The output slices of a unit's columns: slice_width's greedy widths, at
// most max_n.
__device__ __forceinline__ int slice_n(const Geo& g, int left) {
  return min(g.max_n, slice_width(left));
}

__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  const int t = u / g.split, part = u - t * g.split;
  const int tr = t / g.tiles_c;
  Unit x;
  x.R0 = tr * g.th;
  x.wo0 = (t - tr * g.tiles_c) * g.tw;
  x.c_begin = part * g.cw;
  x.c_end = min(g.Cout, x.c_begin + g.cw);
  return x;
}

// Input row, in the N * H rows of x, where the window of the tile starting at
// output row R0 begins (may be -1: TMA fills it with zeros).
__device__ __forceinline__ int window_row(const Geo& g, int R0) {
  const int n = R0 / g.Ho;
  return n * g.H + (R0 - n * g.Ho) * g.stride - g.pad_h;
}

struct Rings {
  uint64_t *wfull, *wempty, *bfull, *bempty;
  unsigned char *a, *b, *win, *tab, *zero;
  uint32_t* pw_small;  // 1 while no pointwise bias rules out the magic conversion
};

__device__ __forceinline__ Rings rings_of(const Geo& g, unsigned char* base) {
  Rings r;
  r.a = base;
  r.b = base + g.b_off;
  r.win = base + g.w_off;
  r.tab = base + g.tab_off;
  r.pw_small = reinterpret_cast<uint32_t*>(base + g.bar_off + 120);
  r.zero = base + g.zero_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + g.bar_off);
  r.wfull = bars;
  r.wempty = bars + g.ws;
  r.bfull = bars + 2 * g.ws;
  r.bempty = bars + 2 * g.ws + g.bs;
  return r;
}

// The tensors of a launch and the upper bounds of its requants (min(six_q,
// 127) with ReLU6, else 127; the lower bound is the instantiation's: 0, or
// -128 in the linear mode).
struct Launch {
  const int8_t* dw_w;
  const int *dw_b, *pw_b;
  const float *dw_m, *pw_m;
  int8_t* out;
  float dw_hi, pw_hi;
};

// The depthwise table (TAB_GROUP), a consumer thread a word of 4 channels,
// and the flag of the pointwise sums' conversion: |acc| <= Cin * 2^14 (int8
// products of at most 128 x 128), so every |acc + bias| < 2^22 and the magic
// conversion is exact when every |bias| < 2^22 - Cin * 2^14.
__device__ __forceinline__ void fill_table(const Geo& g, const Launch& l, const Rings& r) {
  const int nthreads = 128 * g.nwg;
  for (int w = threadIdx.x; w < g.Cin / 4; w += nthreads) {
    const int ch = 4 * w;
    uint32_t t03[4], t47[4], t8[4];
    dw_tap_words(l.dw_w, g.Cin, ch, t03, t47, t8);
    unsigned char* grp = r.tab + ch / 16 * TAB_GROUP + ch % 16 * 4;
    *reinterpret_cast<uint4*>(grp) = make_uint4(t03[0], t03[1], t03[2], t03[3]);
    *reinterpret_cast<uint4*>(grp + 64) = make_uint4(t47[0], t47[1], t47[2], t47[3]);
    *reinterpret_cast<uint4*>(grp + 128) = make_uint4(t8[0], t8[1], t8[2], t8[3]);
    const int4 bias = *reinterpret_cast<const int4*>(l.dw_b + ch);
    const bool small = small_biases(bias);
    *reinterpret_cast<uint4*>(grp + 192) =
        make_uint4(uint32_t(bias.x) + uint32_t(MAGIC_I), uint32_t(bias.y) + uint32_t(MAGIC_I),
                   uint32_t(bias.z) + uint32_t(MAGIC_I), uint32_t(bias.w) + uint32_t(MAGIC_I));
    *reinterpret_cast<float4*>(grp + 256) = *reinterpret_cast<const float4*>(l.dw_m + ch);
    *reinterpret_cast<uint32_t*>(r.tab + ch / 16 * TAB_GROUP + 320 + ch % 16) = small;
  }
  const int room = (1 << 22) - g.Cin * (1 << 14);
  for (int c = threadIdx.x; c < g.Cout; c += nthreads)
    if (l.pw_b[c] <= -room || l.pw_b[c] >= room) *r.pw_small = 0;
  hop::named_bar_sync(1 + 4, nthreads);  // after the panels' barriers 1..4
}

// The dynamic shared memory base rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 1024), the rings' barriers initialised, the zero row
// written and the pointwise flag set.
__device__ __forceinline__ unsigned char* setup_smem(const Geo& g, unsigned char* raw) {
  const uint32_t a = hop::saddr(raw);
  unsigned char* base = raw + ((1024 - (a & 1023)) & 1023);
  if (threadIdx.x == 0) {
    Rings r = rings_of(g, base);
    const uint32_t consumers = 128 * g.nwg;
    for (int s = 0; s < g.ws; ++s) {
      hop::mbar_init(r.wfull + s, 1);
      hop::mbar_init(r.wempty + s, consumers);
    }
    for (int s = 0; s < g.bs; ++s) {
      hop::mbar_init(r.bfull + s, 1);
      hop::mbar_init(r.bempty + s, consumers);
    }
    hop::fence_mbar_init();
    *r.pw_small = 1;
  }
  if (threadIdx.x < ZERO_BYTES / 16)
    reinterpret_cast<uint4*>(base + g.zero_off)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  return base;
}

// ---- producers (lane 0 of their warp) -------------------------------------------

// Window chunks in the order the consumers take them: every chunk of a unit
// once, or once for each slice when the panel holds a range of Cin.
__device__ inline void produce_window(const Geo& g, const Rings& r, const CUtensorMap* xmap) {
  uint32_t wi = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    int passes = 1;
    if (g.nranges > 1) {
      passes = 0;
      for (int col = x.c_begin; col < x.c_end; col += slice_n(g, x.c_end - col)) ++passes;
    }
    const int row0 = window_row(g, x.R0), col0 = x.wo0 * g.stride - g.pad_w;
    for (int p = 0; p < passes; ++p)
      for (int c = 0; c < g.nchunks; ++c, ++wi) {
        const uint32_t s = wi % g.ws, n = wi / g.ws;
        hop::mbar_wait(r.wempty + s, (n & 1) ^ 1);
        hop::mbar_arrive_expect_tx(r.wfull + s, g.win_bytes);
        hop::tma_load_3d(r.win + s * g.win_stride, xmap, r.wfull + s, c * KCH, col0, row0);
      }
  }
}

// Weight stages: for each slice, its 128-channel chunks of K in ascending
// order, as N rows of 128 K bytes (boxes of 64 rows, or of 8 below 64).
__device__ inline void produce_weights(const Geo& g, const Rings& r, const CUtensorMap* w64,
                                       const CUtensorMap* w8) {
  uint32_t bi = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    for (int col = x.c_begin; col < x.c_end;) {
      const int n = slice_n(g, x.c_end - col);
      for (int c = 0; c < g.nchunks; ++c, ++bi) {
        const uint32_t s = bi % g.bs, k = bi / g.bs;
        hop::mbar_wait(r.bempty + s, (k & 1) ^ 1);
        hop::mbar_arrive_expect_tx(r.bfull + s, n * KCH);
        unsigned char* dst = r.b + s * BSTAGE_BYTES;
        if (n >= 64) {
          for (int b = 0; b < n / 64; ++b)
            hop::tma_load_3d(dst + b * BOX64_BYTES, w64, r.bfull + s, c * KCH, col + 64 * b, 0);
        } else {
          for (int b = 0; b < n / 8; ++b)
            hop::tma_load_3d(dst + b * BOX8_BYTES, w8, r.bfull + s, c * KCH, col + 8 * b, 0);
        }
      }
      col += n;
    }
  }
}

// ---- the requant ----------------------------------------------------------------------

// float32 of a pointwise sum + bias: the magic-number conversion where every
// such sum is within 2^22 (kMagic, `fill_tables`), else __int2float_rn.
template <bool kMagic>
__device__ __forceinline__ float pw_float(int acc) {
  if constexpr (kMagic)
    return __fsub_rn(__int_as_float(acc + MAGIC_I), MAGIC_F);
  else
    return __int2float_rn(acc);
}

// ---- consumers ----------------------------------------------------------------------

// A 16-channel group of the table into registers (DwGroup: quad i holds
// channels 4i..4i+3).
__device__ __forceinline__ void load_group(const unsigned char* grp, DwGroup& d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 t03 = reinterpret_cast<const uint4*>(grp)[i];
    const uint4 t47 = reinterpret_cast<const uint4*>(grp + 64)[i];
    const uint4 t8 = reinterpret_cast<const uint4*>(grp + 128)[i];
    const int4 b = reinterpret_cast<const int4*>(grp + 192)[i];
    const float4 m = reinterpret_cast<const float4*>(grp + 256)[i];
    DwQuad& q = d.q[i];
    q.t03[0] = t03.x; q.t03[1] = t03.y; q.t03[2] = t03.z; q.t03[3] = t03.w;
    q.t47[0] = t47.x; q.t47[1] = t47.y; q.t47[2] = t47.z; q.t47[3] = t47.w;
    q.t8[0] = t8.x; q.t8[1] = t8.y; q.t8[2] = t8.z; q.t8[3] = t8.w;
    q.b[0] = b.x; q.b[1] = b.y; q.b[2] = b.z; q.b[3] = b.w;
    q.m[0] = m.x; q.m[1] = m.y; q.m[2] = m.z; q.m[3] = m.w;
  }
}

// Whether every bias of a 16-channel group of the table allows the magic
// conversion.
__device__ __forceinline__ bool group_small(const unsigned char* grp) {
  const uint4 f = *reinterpret_cast<const uint4*>(grp + 320);
  return f.x & f.y & f.z & f.w;
}

// A thread's share of a chunk's depthwise: a chunk has G = min(8, (Cin -
// 128c) / 16) live groups of 16 channels; each warpgroup computes its own 64
// tile rows (the rows its wgmma reads), thread t of its 128 taking group j = t
// % G of rows t / G + k * S (k < 4) with S = 128 / G. The rows' places in the
// tile are the same for every unit: decoded once a kernel.
struct Slots {
  int j;
  int m[4];  // tile row | its row in the tile << 8 | its column << 16, or -1: no item
};

__device__ __forceinline__ Slots slots_of(const Geo& g, int live) {
  const int t = threadIdx.x & 127, slots = 128 / live;
  Slots sl;
  sl.j = t % live;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ml = t / live + k * slots, m = (threadIdx.x >> 7) * 64 + ml;
    const int ih = m / g.tw;
    sl.m[k] = (t < slots * live && ml < 64 && m < g.th * g.tw)
                  ? m | ih << 8 | (m - ih * g.tw) << 16 : -1;
  }
  return sl;
}

// A unit's window offsets of a thread's items.
struct Items {
  int off[4];   // window byte offset of tap (0, 0) (a pixel outside the output: 0)
  int rows[4];  // bit dy: tap row dy inside the pixel's image (none outside the output)
};

__device__ __forceinline__ Items items_of(const Geo& g, const Unit& x, const Slots& sl) {
  const int n0 = x.R0 / g.Ho, r0 = x.R0 - n0 * g.Ho;
  const int row0 = n0 * g.H + r0 * g.stride - g.pad_h;  // window_row(g, x.R0)
  Items it;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    it.off[k] = 0;
    it.rows[k] = 0;
    const int ih = (sl.m[k] >> 8) & 0xff, iw = sl.m[k] >> 16;
    const int R = x.R0 + ih, wo = x.wo0 + iw;
    if (sl.m[k] < 0 || R >= g.rows || wo >= g.Wo) continue;
    int n = n0, r = r0 + ih;  // image and row of output row R
    while (r >= g.Ho) {
      r -= g.Ho;
      ++n;
    }
    const int hb = r * g.stride - g.pad_h;  // image row of tap row 0
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      if ((unsigned)(hb + dy) < (unsigned)g.H) it.rows[k] |= 1 << dy;
    it.off[k] = ((n * g.H + hb - row0) * g.ww + iw * g.stride) * g.kw;
  }
  return it;
}

// One pixel's 16 channels with the group's weights in registers (one or two
// consumer warpgroups): nine 16-byte tap loads (a tap row outside the image
// reads the zero row `zj`), dp4a over taps 0-3, 4-7 and 8 from the bias, the
// requant, one 16-byte store into A row m (swizzled).
template <bool kMagic>
__device__ __forceinline__ void dw_pixel_regs(const Geo& g, int off, int rows, int m, int j,
                                         const unsigned char* wj, const unsigned char* zj,
                                         const DwGroup& d, float hi, unsigned char* atom) {
  uint4 v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const unsigned char* rp = (rows >> dy) & 1 ? wj + off + dy * g.ww * g.kw : zj;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] = *reinterpret_cast<const uint4*>(rp + dx * g.kw);
  }
  *reinterpret_cast<uint4*>(atom + m * ROW_BYTES + ((j ^ (m & 7)) << 4)) =
      dw16<kMagic>(v, d, hi);
}

// The same with the weights read from the table a 4-channel quad at a time,
// so that few registers stay live (four consumer warpgroups).
template <bool kMagic>
__device__ __forceinline__ void dw_pixel_lean(const Geo& g, int off, int rows, int m, int j,
                                         const unsigned char* wj, const unsigned char* zj,
                                         const unsigned char* grp, float hi,
                                         unsigned char* atom) {
  uint4 v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const unsigned char* rp = (rows >> dy) & 1 ? wj + off + dy * g.ww * g.kw : zj;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] = *reinterpret_cast<const uint4*>(rp + dx * g.kw);
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 t03 = reinterpret_cast<const uint4*>(grp)[i];
    const uint4 t47 = reinterpret_cast<const uint4*>(grp + 64)[i];
    const uint4 t8 = reinterpret_cast<const uint4*>(grp + 128)[i];
    const int4 b = reinterpret_cast<const int4*>(grp + 192)[i];
    const float4 mu = reinterpret_cast<const float4*>(grp + 256)[i];
    const DwQuad q{{t03.x, t03.y, t03.z, t03.w}, {t47.x, t47.y, t47.z, t47.w},
                   {t8.x, t8.y, t8.z, t8.w}, {b.x, b.y, b.z, b.w}, {mu.x, mu.y, mu.z, mu.w}};
    o[i] = dw_quad<kMagic>(v, i, q, hi);
  }
  *reinterpret_cast<uint4*>(atom + m * ROW_BYTES + ((j ^ (m & 7)) << 4)) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

template <bool kLean, bool kMagic>
__device__ __forceinline__ void dw_items(const Geo& g, const Slots& sl, const Items& it,
                                         const unsigned char* wj, const unsigned char* zj,
                                         const unsigned char* grp, float hi,
                                         unsigned char* atom) {
  if constexpr (kLean) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (sl.m[k] >= 0)
        dw_pixel_lean<kMagic>(g, it.off[k], it.rows[k], sl.m[k] & 0xff, sl.j, wj, zj, grp, hi,
                              atom);
  } else {
    DwGroup d;
    load_group(grp, d);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (sl.m[k] >= 0)
        dw_pixel_regs<kMagic>(g, it.off[k], it.rows[k], sl.m[k] & 0xff, sl.j, wj, zj, d, hi,
                              atom);
  }
}

// Depthwise of chunk c (channels 128c.., `live` groups of 16) of the unit's
// TM pixels into one A atom.
template <bool kLean>
__device__ __forceinline__ void depthwise_chunk(const Geo& g, const Rings& r, float hi,
                                                const unsigned char* win, unsigned char* atom,
                                                int c, const Slots& sl, const Items& it) {
  if (sl.m[0] < 0) return;
  const unsigned char* grp = r.tab + (c * 8 + sl.j) * TAB_GROUP;
  const unsigned char* wj = win + 16 * sl.j;
  const unsigned char* zj = r.zero + 16 * sl.j;
  if (group_small(grp))
    dw_items<kLean, true>(g, sl, it, wj, zj, grp, hi, atom);
  else
    dw_items<kLean, false>(g, sl, it, wj, zj, grp, hi, atom);
}

__device__ __forceinline__ int live_groups(const Geo& g, int c) {
  return min(8, (g.Cin - c * KCH) / 16);
}

// A thread's slots for the chunks before the last (full) and the last.
struct ChunkSlots {
  Slots full, last;
};

// Fills this warpgroup's rows of the A panel with the depthwise of chunks
// c0..c1-1 (one atom each): after the warpgroup is done reading them, and
// published to its wgmma when it returns. The two warpgroups share the
// window ring but not their rows, so one's depthwise runs beside the other's
// product and epilogue.
template <bool kLean>
__device__ __forceinline__ void fill_panel(const Geo& g, const Rings& r, const Unit& x, int c0,
                                           int c1, float hi, const ChunkSlots& cs,
                                           uint32_t& wi) {
  const int bar = 1 + (threadIdx.x >> 7);
  bool last = c0 == g.nchunks - 1;
  Items it = items_of(g, x, last ? cs.last : cs.full);
  hop::named_bar_sync(bar, 128);
  for (int c = c0; c < c1; ++c, ++wi) {
    if (!last && c == g.nchunks - 1) {  // the last chunk may be narrower
      last = true;
      it = items_of(g, x, cs.last);
    }
    const uint32_t s = wi % g.ws;
    hop::mbar_wait(r.wfull + s, (wi / g.ws) & 1);
    depthwise_chunk<kLean>(g, r, hi, r.win + s * g.win_stride, r.a + (c - c0) * g.atom_bytes, c,
                    last ? cs.last : cs.full, it);
    hop::mbar_arrive(r.wempty + s);
  }
  hop::fence_proxy_async_smem();  // the panel's stores, for wgmma
  hop::named_bar_sync(bar, 128);
}

// A tile row's place in the tile (ih < 0: outside the tile), and its output
// pixel in a unit (-1: outside the output).
struct TileRow {
  int ih, iw;
};

__device__ __forceinline__ TileRow tile_row(const Geo& g, int m) {
  if (m >= g.th * g.tw) return {-1, 0};
  const int ih = m / g.tw;
  return {ih, m - ih * g.tw};
}

__device__ __forceinline__ long long out_pixel(const Geo& g, const Unit& x, TileRow t) {
  const int R = x.R0 + t.ih, wo = x.wo0 + t.iw;
  if (t.ih < 0 || R >= g.rows || wo >= g.Wo) return -1;
  return (long long)R * g.Wo + wo;
}

// Words w[k] of combination k of each lane of a quad -> o[j], lane j's word of
// combination q (this lane's index in the quad): a 4 x 4 word transpose in two
// rounds of shuffles (the bf16 tile's epilogue exchange).
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const int q = threadIdx.x & 3;
  const bool b1 = q & 2, b0 = q & 1;
  // Round 1, with lane q ^ 2: keep the two combinations whose bit 1 is q's,
  // send the other two. Round 2, with lane q ^ 1: the same on bit 0.
  const uint32_t k0 = b1 ? w[2] : w[0], k1 = b1 ? w[3] : w[1];
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? w[0] : w[2], 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? w[1] : w[3], 2);
  const uint32_t m0 = b0 ? k1 : k0, m1 = b0 ? r1 : r0;  // combination q of lanes q, q ^ 2
  const uint32_t u0 = __shfl_xor_sync(0xffffffffu, b0 ? k0 : k1, 1);  // of lane q ^ 1
  const uint32_t u1 = __shfl_xor_sync(0xffffffffu, b0 ? r0 : r1, 1);  // of lane q ^ 3
  const uint32_t e0 = b0 ? u0 : m0, e1 = b0 ? m0 : u0;  // lanes (q & 2), (q & 2) + 1
  const uint32_t e2 = b0 ? u1 : m1, e3 = b0 ? m1 : u1;  // lanes (q & 2) ^ 2, + 1
  o[0] = b1 ? e2 : e0;
  o[1] = b1 ? e3 : e1;
  o[2] = b1 ? e0 : e2;
  o[3] = b1 ? e1 : e3;
}

// + bias, requant, int8 stores to output pixels pA (row A) and pB (row B; -1:
// outside the output). The accumulator of a warpgroup thread (warp w, lane l)
// holds, for each 8-column group i, columns 8i + 2(l%4) and +1 of rows 16w +
// l/4 (registers 4i, 4i+1) and 16w + l/4 + 8 (4i+2, 4i+3): a lane's two
// bytes of a group and row are a piece. From 32 columns on, the quad
// transposes words of two pieces (groups 2a and 2a+1 of one row), so that
// each lane stores 16 contiguous bytes of one row (two 8-byte stores when
// Cout is not a multiple of 16); below, lane pairs swap pieces and store 4
// bytes.
template <int N, bool kMagic, bool kLean>
__device__ __forceinline__ void epilogue(const Geo& g, const int (&acc)[N / 2],
                                         const int* __restrict__ pw_b,
                                         const float* __restrict__ pw_m, float lo, float hi,
                                         long long pA, long long pB, int8_t* __restrict__ out,
                                         int col0) {
  const int q = threadIdx.x & 3;
  const long long p = (q & 1) ? pB : pA;
  // groups requantized together: all of them, or 4 at a time (the lean form's
  // registers)
  constexpr int G = kLean && N >= 32 ? 4 : N / 8;
#pragma unroll
  for (int i0 = 0; i0 < N / 8; i0 += G) {
    uint32_t pa[G], pb[G];  // pieces of rows A and B (low 16 bits)
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = i0 + k, col = col0 + 8 * i + 2 * q;
      const int2 b = *reinterpret_cast<const int2*>(pw_b + col);
      const float2 m = *reinterpret_cast<const float2*>(pw_m + col);
      pa[k] = __byte_perm(requant_bits(pw_float<kMagic>(acc[4 * i] + b.x), m.x, lo, hi),
                          requant_bits(pw_float<kMagic>(acc[4 * i + 1] + b.y), m.y, lo, hi),
                          0x0040);
      pb[k] = __byte_perm(requant_bits(pw_float<kMagic>(acc[4 * i + 2] + b.x), m.x, lo, hi),
                          requant_bits(pw_float<kMagic>(acc[4 * i + 3] + b.y), m.y, lo, hi),
                          0x0040);
    }
    if constexpr (N >= 32) {
#pragma unroll
      for (int k0 = 0; k0 < G; k0 += 4) {
        // combination k: group pair (i0 + k0) / 2 + k / 2, row A or B by k % 2
        const uint32_t w[4] = {__byte_perm(pa[k0], pa[k0 + 1], 0x5410),
                               __byte_perm(pb[k0], pb[k0 + 1], 0x5410),
                               __byte_perm(pa[k0 + 2], pa[k0 + 3], 0x5410),
                               __byte_perm(pb[k0 + 2], pb[k0 + 3], 0x5410)};
        uint32_t o[4];
        quad_transpose(w, o);
        if (p < 0) continue;
        // lane j's word: its pieces at columns 2j of groups 2a and 2a + 1
        int8_t* dst = out + p * g.Cout + col0 + 8 * (i0 + k0) + 16 * (q >> 1);
        const uint32_t v0 = __byte_perm(o[0], o[1], 0x5410), v1 = __byte_perm(o[2], o[3], 0x5410);
        const uint32_t v2 = __byte_perm(o[0], o[1], 0x7632), v3 = __byte_perm(o[2], o[3], 0x7632);
        if (g.Cout % 16 == 0) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(v0, v1, v2, v3);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(v0, v1);
          *reinterpret_cast<uint2*>(dst + 8) = make_uint2(v2, v3);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        // an even lane takes row A's pieces of itself and lane q + 1, an odd
        // lane row B's of lane q - 1 and itself
        const uint32_t r = __shfl_xor_sync(0xffffffffu, (q & 1) ? pa[k] : pb[k], 1);
        const uint32_t v = (q & 1) ? __byte_perm(r, pb[k], 0x5410) : __byte_perm(pa[k], r, 0x5410);
        if (p >= 0)
          *reinterpret_cast<uint32_t*>(out + p * g.Cout + col0 + 8 * (i0 + k) + 2 * (q & 2)) = v;
      }
    }
  }
}

// One output slice of N columns at col0 of unit x: the product over K (the
// depthwise of each range first when the panel holds a range of Cin) and the
// epilogue. Every chunk takes its four 32-wide K steps; no branch stands
// between the wgmma of a warpgroup.
template <int N, bool kLinear, bool kLean>
__device__ __forceinline__ void slice(const Geo& g, const Rings& r, const Launch& l,
                                      const Unit& x, int col0, long long pA, long long pB,
                                      bool pw_magic, const ChunkSlots& cs, uint32_t& wi,
                                      uint32_t& bi) {
  const int wg = threadIdx.x >> 7;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int rg = 0; rg < g.nranges; ++rg) {
    const int c0 = rg * g.kpc, c1 = min(g.nchunks, c0 + g.kpc);
    if (g.nranges > 1) fill_panel<kLean>(g, r, x, c0, c1, l.dw_hi, cs, wi);
    // One chunk's wgmma group stays in flight while the next chunk's stage
    // is awaited; a stage is released once the group that read it is done.
    uint32_t held = 0;
    for (int c = c0; c < c1; ++c, ++bi) {
      const uint32_t s = bi % g.bs;
      hop::mbar_wait(r.bfull + s, (bi / g.bs) & 1);
      const uint32_t a0 = hop::saddr(r.a + (c - c0) * g.atom_bytes + wg * 64 * ROW_BYTES);
      const uint32_t b0 = hop::saddr(r.b + s * BSTAGE_BYTES);
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hop::WgmmaS8<N>::mma(acc, hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128),
                             hop::gmma_desc(b0 + 32 * k, 16, 1024, hop::kSwizzle128));
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > c0) hop::mbar_arrive(r.bempty + held);
      held = s;
    }
    hop::wgmma_wait<0>();
    hop::mbar_arrive(r.bempty + held);
  }
  const float lo = kLinear ? -128.0f : 0.0f;
  if (pw_magic)
    epilogue<N, true, kLean>(g, acc, l.pw_b, l.pw_m, lo, l.pw_hi, pA, pB, l.out, col0);
  else
    epilogue<N, false, kLean>(g, acc, l.pw_b, l.pw_m, lo, l.pw_hi, pA, pB, l.out, col0);
}

// Every unit of this block: the panel once (all of Cin where it fits), then
// the slices of the unit's columns. Four consumer warpgroups take the lean
// depthwise and slices of at most 64 columns (112 registers a thread).
template <int NWG, bool kLinear>
__device__ void consume(const Geo& g, const Rings& r, const Launch& l, bool pw_magic) {
  constexpr bool kLean = NWG == 4;
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = (t >> 7) * 64 + ((t & 127) >> 5) * 16;  // the warp's first tile row
  const TileRow rowA = tile_row(g, r0 + (lane >> 2)), rowB = tile_row(g, r0 + (lane >> 2) + 8);
  const ChunkSlots cs{slots_of(g, live_groups(g, 0)), slots_of(g, live_groups(g, g.nchunks - 1))};
  uint32_t wi = 0, bi = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    const long long pA = out_pixel(g, x, rowA), pB = out_pixel(g, x, rowB);
    if (g.nranges == 1) fill_panel<kLean>(g, r, x, 0, g.nchunks, l.dw_hi, cs, wi);
    for (int col = x.c_begin; col < x.c_end;) {
      const int n = slice_n(g, x.c_end - col);
      if constexpr (!kLean) {
        if (n == 128) {
          slice<128, kLinear, kLean>(g, r, l, x, col, pA, pB, pw_magic, cs, wi, bi);
          col += n;
          continue;
        }
      }
      if (n == 64)
        slice<64, kLinear, kLean>(g, r, l, x, col, pA, pB, pw_magic, cs, wi, bi);
      else if (n == 32)
        slice<32, kLinear, kLean>(g, r, l, x, col, pA, pB, pw_magic, cs, wi, bi);
      else if (n == 16)
        slice<16, kLinear, kLean>(g, r, l, x, col, pA, pB, pw_magic, cs, wi, bi);
      else
        slice<8, kLinear, kLean>(g, r, l, x, col, pA, pB, pw_magic, cs, wi, bi);
      col += n;
    }
  }
}

// The maps a launch passes by value (__grid_constant__): the input windows
// and the K-major weight in both box forms.
struct Maps {
  CUtensorMap x, w64, w8;
};

// Threads of a block: NWG consumer warpgroups, then the producers: a whole
// warpgroup (so that setmaxnreg moves its registers to the consumers) or,
// with one consumer warpgroup, the two producer warps alone.
constexpr int threads_of(int nwg) { return nwg == 1 ? 192 : 128 * (nwg + 1); }

template <int NWG, bool kLinear>
__device__ __forceinline__ void run(const Geo& g, unsigned char* smem_raw, const Maps& maps,
                                    const Launch& l) {
  const Rings r = rings_of(g, setup_smem(g, smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  // registers a thread: 232 and 40 with two consumer warpgroups, 112 and 24
  // with four (what the launch of 384 or 640 threads holds)
  if (wg < NWG) {
    if constexpr (NWG == 2) hop::setmaxnreg_inc<232>();
    if constexpr (NWG == 4) hop::setmaxnreg_inc<112>();
    fill_table(g, l, r);  // while the producers start the rings
    consume<NWG, kLinear>(g, r, l, *r.pw_small != 0);
  } else {
    if constexpr (NWG == 2) hop::setmaxnreg_dec<40>();
    if constexpr (NWG == 4) hop::setmaxnreg_dec<24>();
    const int t = threadIdx.x - 128 * NWG;
    if (t == 0)
      produce_window(g, r, &maps.x);
    else if (t == 32)
      produce_weights(g, r, &maps.w64, &maps.w8);
  }
}

// ---- host ---------------------------------------------------------------------------

// The window map over x (N, H, W, Cin) int8: dims (Cin, W, N * H), box (kw,
// ww, wh).
inline cudaError_t make_x_map(CUtensorMap* map, const void* x, const Geo& g) {
  const cuuint64_t dims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.N * g.H};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W * g.Cin};
  const cuuint32_t box[3] = {(cuuint32_t)g.kw, (cuuint32_t)g.ww, (cuuint32_t)g.wh};
  return hop::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The weight maps over the K-major (Cout, Cin) weight: dims (Cin, Cout, 1),
// boxes of 128 K bytes x 64 rows and x 8 rows, 128-byte swizzled.
inline cudaError_t make_w_maps(Maps& m, const void* wt, const Geo& g) {
  const cuuint64_t dims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.Cout, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Cin, (cuuint64_t)g.Cin * g.Cout};
  const cuuint32_t box8[3] = {(cuuint32_t)KCH, 8, 1};
  cudaError_t e = hop::make_map_3d(&m.w8, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, dims, strides,
                                   box8, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess || g.Cout < 64) return e;
  const cuuint32_t box64[3] = {(cuuint32_t)KCH, 64, 1};
  return hop::make_map_3d(&m.w64, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, dims, strides, box64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// Checks a plan against the shape; cudaErrorInvalidValue if it breaks a rule
// of the kernel (the Python plan never gives such a plan).
inline cudaError_t check_geo(const Geo& g) {
  const bool ok = (g.nwg == 1 || g.nwg == 2 || g.nwg == 4) && g.th >= 1 && g.tw >= 1 &&
                  g.th * g.tw <= 64 * g.nwg && g.kpc >= 1 && g.split >= 1 && g.cw >= 8 && g.cw % 8 == 0 && g.ws >= 1 && g.bs >= 2 &&
                  g.wh <= 256 && g.ww <= 256 && g.Cin % 16 == 0 && g.Cout % 8 == 0 &&
                  g.smem_bytes <= SMEM_LIMIT && (long long)g.split * g.cw >= g.Cout;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace si8
}  // namespace mnk
