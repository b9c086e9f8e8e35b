// The bf16 fused depthwise-separable block on Hopper: one stage of the
// persistent kernel, shared by the per-block kernel (separable_block.cu) and
// the chain kernel (chain.cu), so that a chain stage computes bit for bit
// what one per-block launch does on the same plan.
//
// Work is split into units: an output tile of TH x TW pixels (rows of the
// N * Ho output rows, columns of Wo) times a part of the output channels
// (the plan's Cout split, for shapes with too few pixel tiles to fill the
// card). A block owns one unit at a time (the grid is persistent, the unit
// index strided by gridDim.x) and:
//   1. stages the input window of its tile ((TH-1)s+3 rows x (TW-1)s+3
//      columns x 64 channels, one TMA box a chunk of 64 channels; out-of-range
//      columns and the first/last rows load as zeros) through a ring of WS
//      slots;
//   2. computes the depthwise 3x3 of its TM = 64 * NWG pixels over all of
//      Cin once (f32 taps in dy-then-dx order, + dw bias in f32, activation,
//      round to bf16) into the A panel in shared memory: TM x Cin bf16,
//      K-major, 128-byte swizzled, the layout wgmma reads; each thread's
//      pixels are decoded once a unit, and taken two at a time. Tap rows of
//      another image read a zero row (TF-SAME: stride 1 pads one pixel each
//      side, stride 2 on an even input only at the high end). A chunk's
//      channels past Cin are zeros, and its threads spread over its live
//      channels only. A Cin too large for the panel
//      is taken in ranges of KP channels, recomputed for each output slice
//      (the product's accumulators are then live across the depthwise; the
//      common path fills the panel before any slice, with none live);
//   3. walks its output channels in slices of 128, 64, 32, 16 or 8 columns
//      (wgmma m64nNk16; no column of a slice is padding): the weight streams
//      through a ring of BS slots of 64 K rows (TMA boxes of 64 columns,
//      128-byte swizzled, or of 8 columns unswizzled for slices below 64),
//      each warpgroup multiplies its 64 rows, f32 accumulators in registers,
//      K in ascending 16-wide steps from zero, four a chunk (rows of K beyond
//      Cin load as zeros), one chunk's group in flight while the next
//      chunk's weights are awaited;
//   4. epilogue (kEpi, numerics.cuh): + pw bias in f32, activation (none at
//      kBias), rounded to bf16 in registers, a 4 x 4 word transpose inside
//      each quad of lanes, 16-byte stores of 8 channels; at kRaw the float32
//      accumulators as they are (no bias, no activation), a pair exchange
//      between lanes q and q ^ 1, 16-byte stores of 4 channels.
// Roles: NWG consumer warpgroups (depthwise, wgmma, epilogue), then one
// producer warp for the window ring and one for the weight ring, each run by
// its lane 0; full and empty mbarriers order the rings, a named barrier
// publishes the A panel to both warpgroups. With two consumer warpgroups the
// producers' warpgroup gives registers to them (setmaxnreg: 232 a consumer
// thread, 40 a producer), so the accumulators of a 128-column slice stay in
// registers beside the epilogue's and the depthwise's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace sw {

using bf16 = __nv_bfloat16;

constexpr int KCH = 64;                      // channels a window chunk, an A atom, a weight stage's K
constexpr int ROW_BYTES = KCH * 2;           // one pixel of a chunk; one A row of an atom
constexpr int BSTAGE_BYTES = KCH * 128 * 2;  // a weight stage: 64 K rows x up to 128 columns
constexpr int BOX128_BYTES = KCH * 64 * 2;   // a 64-column weight box
constexpr int BOX8_BYTES = KCH * 8 * 2;      // an 8-column weight box
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory a block may use (227 KB)

// The tile plan (ops/separable_block.separable_plan).
struct Plan {
  int nwg;    // consumer warpgroups; TM = 64 * nwg pixels
  int th, tw; // tile rows and columns, th * tw <= TM
  int kp;     // A panel channels (multiple of 64)
  int split;  // output-channel parts a pixel tile
  int cw;     // channels a part (multiple of 8)
  int ws, bs; // window and weight ring slots
};

struct Geo {
  int N, H, W, Cin, Cout, stride, pad, Ho, Wo, rows, relu6;
  int nwg, th, tw, split, cw, ws, bs;
  int tiles_c, units, wh, ww, nchunks, kpc, nranges;
  int win_bytes, win_stride, a_bytes, atom_bytes, b_off, w_off, bar_off, zero_off, smem_bytes;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline Geo make_geo(int N, int H, int W, int Cin, int Cout, int stride,
                                        int relu6, const Plan& p) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.stride = stride;
  g.pad = stride == 1 ? 1 : 0;
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.rows = N * g.Ho;
  g.relu6 = relu6 != 0;
  g.nwg = p.nwg; g.th = p.th; g.tw = p.tw; g.split = p.split; g.cw = p.cw;
  g.ws = p.ws; g.bs = p.bs;
  g.tiles_c = cdiv(g.Wo, p.tw);
  g.units = cdiv(g.rows, p.th) * g.tiles_c * p.split;
  g.wh = (p.th - 1) * stride + 3;
  g.ww = (p.tw - 1) * stride + 3;
  g.nchunks = cdiv(Cin, KCH);
  g.kpc = p.kp / KCH;
  g.nranges = cdiv(g.nchunks, g.kpc);
  g.win_bytes = g.wh * g.ww * ROW_BYTES;
  g.win_stride = cdiv(g.win_bytes, 1024) * 1024;
  g.atom_bytes = 64 * p.nwg * ROW_BYTES;
  g.a_bytes = g.atom_bytes * g.kpc;
  g.b_off = g.a_bytes;
  g.w_off = g.b_off + p.bs * BSTAGE_BYTES;
  g.bar_off = g.w_off + p.ws * g.win_stride;
  g.zero_off = g.bar_off + 128;
  // + 1024 to align the base, + 128 for the barriers, + 3 zero pixels
  g.smem_bytes = 1024 + g.zero_off + 3 * ROW_BYTES;
  return g;
}

// The greedy slice widths of a column range: 128 while it lasts, then the
// binary digits of the rest (a multiple of 8).
__device__ __forceinline__ int slice_width(int left) {
  return left >= 128 ? 128 : left >= 64 ? 64 : left >= 32 ? 32 : left >= 16 ? 16 : 8;
}

struct Unit {
  int R0, wo0, c_begin, c_end;
};

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

struct Rings {
  uint64_t *wfull, *wempty, *bfull, *bempty;
  unsigned char *a, *b, *win, *zero;
};

__device__ __forceinline__ Rings rings_of(const Geo& g, unsigned char* base) {
  Rings r;
  r.a = base;
  r.b = base + g.b_off;
  r.win = base + g.w_off;
  r.zero = base + g.zero_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + g.bar_off);
  r.wfull = bars;
  r.wempty = bars + g.ws;
  r.bfull = bars + 2 * g.ws;
  r.bempty = bars + 2 * g.ws + g.bs;
  return r;
}

// The dynamic shared memory base rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 1024), the rings' barriers initialised and the zero
// row written.
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
  }
  if (threadIdx.x < 3 * ROW_BYTES / 16)
    reinterpret_cast<uint4*>(base + g.zero_off)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  return base;
}

// ---- producers (lane 0 of their warp) -------------------------------------------

// Window chunks in the order the consumers take them: every chunk of a unit
// once, or once for each slice when the panel holds a range of Cin.
__device__ inline void produce_window(const Geo& g, const Rings& r, const CUtensorMap* xmap,
                               uint32_t& wi) {
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    int passes = 1;
    if (g.nranges > 1) {
      passes = 0;
      for (int col = x.c_begin; col < x.c_end; col += slice_width(x.c_end - col)) ++passes;
    }
    for (int p = 0; p < passes; ++p)
      for (int c = 0; c < g.nchunks; ++c, ++wi) {
        const uint32_t s = wi % g.ws, n = wi / g.ws;
        hop::mbar_wait(r.wempty + s, (n & 1) ^ 1);
        hop::mbar_arrive_expect_tx(r.wfull + s, g.win_bytes);
        hop::tma_load_3d(r.win + s * g.win_stride, xmap, r.wfull + s, c * KCH,
                         x.wo0 * g.stride - g.pad, x.R0 * g.stride - g.pad);
      }
  }
}

// Weight stages: for each slice, its 64-row chunks of K in ascending order.
// `wstage` selects the block of a stacked (K blocks, Cin, Cout) weight.
__device__ inline void produce_weights(const Geo& g, const Rings& r, const CUtensorMap* w128,
                                const CUtensorMap* w8, int wstage, uint32_t& bi) {
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    for (int col = x.c_begin; col < x.c_end;) {
      const int n = slice_width(x.c_end - col);
      for (int c = 0; c < g.nchunks; ++c, ++bi) {
        const uint32_t s = bi % g.bs, k = bi / g.bs;
        hop::mbar_wait(r.bempty + s, (k & 1) ^ 1);
        hop::mbar_arrive_expect_tx(r.bfull + s, n * KCH * 2);
        unsigned char* dst = r.b + s * BSTAGE_BYTES;
        if (n >= 64) {
          for (int b = 0; b < n / 64; ++b)
            hop::tma_load_3d(dst + b * BOX128_BYTES, w128, r.bfull + s, col + 64 * b, c * KCH,
                             wstage);
        } else {
          for (int b = 0; b < n / 8; ++b)
            hop::tma_load_3d(dst + b * BOX8_BYTES, w8, r.bfull + s, col + 8 * b, c * KCH, wstage);
        }
      }
      col += n;
    }
  }
}

// ---- consumers ----------------------------------------------------------------------

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A thread's share of a chunk's depthwise. A chunk has G = min(8, (Cin -
// 64c) / 8) live groups of 8 channels: thread t takes group j = t % G of
// tile rows t / G + k * S (k < 4) with S = (128 * NWG) / G pixel slots, so
// no thread idles on a narrow chunk (V1 block 0's 32 channels). Decoded once
// a unit (and again for a narrower last chunk): no division per pixel.
struct Items {
  int j;
  int m[4];     // tile row, or -1: no item
  int off[4];   // window byte offset of tap (0, 0) and group j (a pixel outside the output: 0)
  int rows[4];  // bit dy: input row of tap row dy inside the image (none outside the output)
};

template <int NWG>
__device__ __forceinline__ Items decode(const Geo& g, const Unit& x, int live) {
  constexpr int CONSUMERS = 128 * NWG;
  const int t = threadIdx.x, slots = CONSUMERS / live;
  Items it;
  it.j = t % live;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = t / live + k * slots;
    it.m[k] = (t < slots * live && m < 64 * NWG) ? m : -1;
    it.off[k] = 0;
    it.rows[k] = 0;
    if (it.m[k] < 0 || m >= g.th * g.tw) continue;
    const int ih = m / g.tw, iw = m - ih * g.tw;
    const int R = x.R0 + ih, wo = x.wo0 + iw;
    if (R < g.rows && wo < g.Wo) {
      const int hb = (R % g.Ho) * g.stride - g.pad;  // input row of dy = 0
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        if ((unsigned)(hb + dy) < (unsigned)g.H) it.rows[k] |= 1 << dy;
      it.off[k] = (ih * g.stride * g.ww + iw * g.stride) * ROW_BYTES;
    }
  }
  return it;
}

// A thread's items k0 and k0 + 1, straight-line, for their loads and FMAs to
// interleave: a tap row outside the image reads the zero row `zj` (3 pixels
// of 128 zero bytes) and adds nothing, as the plain version's padding; a
// pixel outside the output computes what its A row holds, which no output
// reads; an item past the thread's last (m < 0) is not stored.
__device__ __forceinline__ void depthwise_pair(const Geo& g, const Items& it, int k0,
                                               const unsigned char* wj, const unsigned char* zj,
                                               const float (&w)[9][8], const float (&b)[8],
                                               unsigned char* atom) {
  constexpr int H = 2;
  float a[H][8];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) a[h][e] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const unsigned char* rp[H];
#pragma unroll
    for (int h = 0; h < H; ++h)
      rp[h] = (it.rows[k0 + h] >> dy) & 1 ? wj + it.off[k0 + h] + dy * g.ww * ROW_BYTES : zj;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float xv[8];
        unpack8(*reinterpret_cast<const uint4*>(rp[h] + dx * ROW_BYTES), xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[h][e] = fmaf(xv[e], w[dy * 3 + dx][e], a[h][e]);
      }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int m = it.m[k0 + h];
    if (m < 0) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) a[h][e] = act(a[h][e] + b[e], g.relu6);
    *reinterpret_cast<uint4*>(atom + m * ROW_BYTES + ((it.j ^ (m & 7)) << 4)) =
        make_uint4(pack2(a[h][0], a[h][1]), pack2(a[h][2], a[h][3]), pack2(a[h][4], a[h][5]),
                   pack2(a[h][6], a[h][7]));
  }
}

// Depthwise of chunk c (channels 64c..64c+63, `live` groups) of the unit's
// TM pixels into one A atom, a thread's items in pairs; the dead groups are
// written as zeros (the product takes all 64 columns). With 8 live groups a
// warp reads four whole 128-byte window rows a tap and writes four whole A
// rows.
template <int NWG>
__device__ __forceinline__ void depthwise_chunk(const Geo& g, const bf16* __restrict__ dw_w,
                                                const bf16* __restrict__ dw_b,
                                                const unsigned char* win,
                                                const unsigned char* zero, unsigned char* atom,
                                                int c, int live, const Items& it) {
  constexpr int CONSUMERS = 128 * NWG, TM = 64 * NWG;
  const int ch = c * KCH + 8 * it.j;
  if (it.m[0] >= 0) {
    float w[9][8], b[8];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      unpack8(*reinterpret_cast<const uint4*>(dw_w + (long long)k * g.Cin + ch), w[k]);
    unpack8(*reinterpret_cast<const uint4*>(dw_b + ch), b);
    const unsigned char* wj = win + 16 * it.j;
    const unsigned char* zj = zero + 16 * it.j;
    depthwise_pair(g, it, 0, wj, zj, w, b, atom);
    if (it.m[2] >= 0) depthwise_pair(g, it, 2, wj, zj, w, b, atom);
  }
  const int dead = 8 - live;
  for (int i = threadIdx.x; i < TM * dead; i += CONSUMERS) {
    const int m = i / dead, jd = live + (i - m * dead);
    *reinterpret_cast<uint4*>(atom + m * ROW_BYTES + ((jd ^ (m & 7)) << 4)) =
        make_uint4(0, 0, 0, 0);
  }
}

// Output pixel of tile row m, or -1 outside the output.
__device__ __forceinline__ long long out_pixel(const Geo& g, const Unit& x, int m) {
  if (m >= g.th * g.tw) return -1;
  const int ih = m / g.tw;
  const int R = x.R0 + ih, wo = x.wo0 + m - ih * g.tw;
  if (R >= g.rows || wo >= g.Wo) return -1;
  return (long long)R * g.Wo + wo;
}

// Two adjacent output channels: + their bias (a bf16 pair) in f32,
// activation (kBiasAct), a bf16 pair.
template <int kEpi>
__device__ __forceinline__ uint32_t out_word(const Geo& g, float a0, float a1, uint32_t bias) {
  float v0 = a0 + __uint_as_float(bias << 16), v1 = a1 + __uint_as_float(bias & 0xffff0000u);
  if constexpr (kEpi == kBiasAct) {
    v0 = act(v0, g.relu6);
    v1 = act(v1, g.relu6);
  }
  return pack2(v0, v1);
}

// The epilogue's stores to output pixels pA (row A) and pB (row B; -1:
// outside the output). The accumulator of a warpgroup thread (warp w, lane l)
// holds, for each 8-column group i, columns 8i + 2(l%4) and +1 of rows 16w +
// l/4 (registers 4i, 4i+1) and 16w + l/4 + 8 (4i+2, 4i+3). kBias, kBiasAct:
// + bias, activation, bf16 to `out` (bf16). kRaw: the accumulators to `out`
// (float32): lanes q and q ^ 1 swap a pair, so that an even lane holds 4
// columns of row A and an odd lane the same 4 of row B.
template <int N, int kEpi>
__device__ __forceinline__ void epilogue(const Geo& g, float (&acc)[N / 2],
                                         const uint32_t (&bias)[N / 8], long long pA,
                                         long long pB, void* __restrict__ out_v, int col0) {
  const int q = threadIdx.x & 3;
  if constexpr (kEpi == kRaw) {
    float* out = static_cast<float*>(out_v);
    const bool odd = q & 1;
    const long long p = odd ? pB : pA;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * i] : acc[4 * i + 2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * i + 1] : acc[4 * i + 3], 1);
      const float4 v = odd ? make_float4(r0, r1, acc[4 * i + 2], acc[4 * i + 3])
                           : make_float4(acc[4 * i], acc[4 * i + 1], r0, r1);
      if (p >= 0)
        *reinterpret_cast<float4*>(out + p * g.Cout + col0 + 8 * i + 2 * (q & 2)) = v;
    }
    return;
  } else {
    bf16* out = static_cast<bf16*>(out_v);
    if constexpr (N == 8) {
      if (pA >= 0)
        *reinterpret_cast<uint32_t*>(out + pA * g.Cout + col0 + 2 * q) =
            out_word<kEpi>(g, acc[0], acc[1], bias[0]);
      if (pB >= 0)
        *reinterpret_cast<uint32_t*>(out + pB * g.Cout + col0 + 2 * q) =
            out_word<kEpi>(g, acc[2], acc[3], bias[0]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 8; i += 2) {
        // Words of combination k = (group i + k / 2, row A or B by k % 2):
        // after the transpose lane q of the quad holds combination q's 8
        // columns.
        const uint32_t w0 = out_word<kEpi>(g, acc[4 * i], acc[4 * i + 1], bias[i]);
        const uint32_t w1 = out_word<kEpi>(g, acc[4 * i + 2], acc[4 * i + 3], bias[i]);
        const uint32_t w2 = out_word<kEpi>(g, acc[4 * i + 4], acc[4 * i + 5], bias[i + 1]);
        const uint32_t w3 = out_word<kEpi>(g, acc[4 * i + 6], acc[4 * i + 7], bias[i + 1]);
        // Round 1, with lane q ^ 2: keep the two combinations whose bit 1 is
        // q's, send the other two. Round 2, with lane q ^ 1: the same on bit 0.
        const bool b1 = q & 2, b0 = q & 1;
        const uint32_t k0 = b1 ? w2 : w0, k1 = b1 ? w3 : w1;
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? w0 : w2, 2);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? w1 : w3, 2);
        const uint32_t m0 = b0 ? k1 : k0, m1 = b0 ? r1 : r0;  // combination q of lanes q, q ^ 2
        const uint32_t u0 = __shfl_xor_sync(0xffffffffu, b0 ? k0 : k1, 1);  // of lane q ^ 1
        const uint32_t u1 = __shfl_xor_sync(0xffffffffu, b0 ? r0 : r1, 1);  // of lane q ^ 3
        const uint32_t e0 = b0 ? u0 : m0, e1 = b0 ? m0 : u0;  // lanes (q & 2), (q & 2) + 1
        const uint32_t e2 = b0 ? u1 : m1, e3 = b0 ? m1 : u1;  // lanes (q & 2) ^ 2, + 1
        const uint32_t o0 = b1 ? e2 : e0, o1 = b1 ? e3 : e1, o2 = b1 ? e0 : e2;
        const uint32_t o3 = b1 ? e1 : e3;
        const long long p = (q & 1) ? pB : pA;
        if (p >= 0)
          *reinterpret_cast<uint4*>(out + p * g.Cout + col0 + 8 * (i + (q >> 1))) =
              make_uint4(o0, o1, o2, o3);
      }
    }
  }
}

// Fills the A panel with the depthwise of chunks c0..c1-1 (one atom each):
// after every warpgroup is done reading the panel, and published to wgmma
// when it returns.
template <int NWG>
__device__ __forceinline__ void fill_panel(const Geo& g, const Rings& r, const Unit& x, int c0,
                                           int c1, const bf16* __restrict__ dw_w,
                                           const bf16* __restrict__ dw_b, uint32_t& wi) {
  int live = min(8, (g.Cin - c0 * KCH) / 8);
  Items it = decode<NWG>(g, x, live);
  hop::named_bar_sync(1, 128 * NWG);
  for (int c = c0; c < c1; ++c, ++wi) {
    if (min(8, (g.Cin - c * KCH) / 8) != live) {  // a narrower last chunk
      live = min(8, (g.Cin - c * KCH) / 8);
      it = decode<NWG>(g, x, live);
    }
    const uint32_t s = wi % g.ws;
    hop::mbar_wait(r.wfull + s, (wi / g.ws) & 1);
    depthwise_chunk<NWG>(g, dw_w, dw_b, r.win + s * g.win_stride, r.zero,
                         r.a + (c - c0) * g.atom_bytes, c, live, it);
    hop::mbar_arrive(r.wempty + s);
  }
  hop::fence_proxy_async_smem();  // the panel's stores, for wgmma
  hop::named_bar_sync(1, 128 * NWG);
}

// One output slice of N columns at col0 of unit x: the product over K (the
// depthwise of each range first when the panel holds a range of Cin) and the
// epilogue. Every chunk takes its four 16-wide K steps: the panel's columns
// and the weight's rows beyond Cin are zeros, and no branch stands between
// the wgmma of a warpgroup.
template <int NWG, int N, int kEpi>
__device__ __forceinline__ void slice(const Geo& g, const Rings& r, const Unit& x, int col0,
                                      long long pA, long long pB,
                                      const bf16* __restrict__ dw_w,
                                      const bf16* __restrict__ dw_b,
                                      const bf16* __restrict__ pw_b, void* __restrict__ out,
                                      uint32_t& wi, uint32_t& bi) {
  const int wg = threadIdx.x >> 7;
  uint32_t bias[N / 8];  // this thread's column pairs, loaded while the product runs
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    bias[i] = kEpi == kRaw ? 0u
                           : *reinterpret_cast<const uint32_t*>(pw_b + col0 + 8 * i +
                                                                2 * (threadIdx.x & 3));
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int rg = 0; rg < g.nranges; ++rg) {
    const int c0 = rg * g.kpc, c1 = min(g.nchunks, c0 + g.kpc);
    if (g.nranges > 1) fill_panel<NWG>(g, r, x, c0, c1, dw_w, dw_b, wi);
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
      for (int k = 0; k < 4; ++k) {
        const uint64_t da = hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128);
        const uint64_t db =
            N >= 64 ? hop::gmma_desc(b0 + 2048 * k, BOX128_BYTES, 1024, hop::kSwizzle128)
                    : hop::gmma_desc(b0 + 256 * k, 128, BOX8_BYTES, hop::kInterleave);
        hop::Wgmma<N>::mma(acc, da, db);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > c0) hop::mbar_arrive(r.bempty + held);
      held = s;
    }
    hop::wgmma_wait<0>();
    hop::mbar_arrive(r.bempty + held);
  }
  epilogue<N, kEpi>(g, acc, bias, pA, pB, out, col0);
}

// Every unit of this block: the panel once (all of Cin where it fits), then
// the slices of the unit's columns.
template <int NWG, int kEpi>
__device__ void consume(const Geo& g, const Rings& r, const bf16* __restrict__ dw_w,
                        const bf16* __restrict__ dw_b, const bf16* __restrict__ pw_b,
                        void* __restrict__ out, uint32_t& wi, uint32_t& bi) {
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = (t >> 7) * 64 + ((t & 127) >> 5) * 16;  // the warp's first tile row
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    // the epilogue's output pixels of this lane (-1: outside the output)
    const long long pA = out_pixel(g, x, r0 + (lane >> 2));
    const long long pB = out_pixel(g, x, r0 + (lane >> 2) + 8);
    if (g.nranges == 1) fill_panel<NWG>(g, r, x, 0, g.nchunks, dw_w, dw_b, wi);
    for (int col = x.c_begin; col < x.c_end;) {
      const int n = slice_width(x.c_end - col);
      switch (n) {
        case 128:
          slice<NWG, 128, kEpi>(g, r, x, col, pA, pB, dw_w, dw_b, pw_b, out, wi, bi);
          break;
        case 64:
          slice<NWG, 64, kEpi>(g, r, x, col, pA, pB, dw_w, dw_b, pw_b, out, wi, bi);
          break;
        case 32:
          slice<NWG, 32, kEpi>(g, r, x, col, pA, pB, dw_w, dw_b, pw_b, out, wi, bi);
          break;
        case 16:
          slice<NWG, 16, kEpi>(g, r, x, col, pA, pB, dw_w, dw_b, pw_b, out, wi, bi);
          break;
        default:
          slice<NWG, 8, kEpi>(g, r, x, col, pA, pB, dw_w, dw_b, pw_b, out, wi, bi);
          break;
      }
      col += n;
    }
  }
}

// The maps a launch passes by value (__grid_constant__): the input windows
// (x, and a chain's two scratch buffers) and the weight in both box forms.
struct Maps {
  CUtensorMap x[3];
  CUtensorMap w128, w8;
};

// Threads of a block: NWG consumer warpgroups, then the producers: a whole
// warpgroup with two warps (so that setmaxnreg moves its registers to the
// consumers) or, with one consumer warpgroup, the two producer warps alone.
constexpr int threads_of(int nwg) { return nwg == 2 ? 384 : 192; }

// The tensors of a launch: K stacked blocks (1 for a per-block launch; the
// chain's K stages are C -> C) and where each stage writes.
// `out` is bf16, or float32 at kRaw.
struct Launch {
  const bf16 *dw_w, *dw_b, *pw_b;
  void* out;
  bf16 *scratch0, *scratch1;
  int K;
};

__device__ __forceinline__ void* stage_out(const Launch& l, int k) {
  return k == l.K - 1 ? l.out : (k % 2 == 0 ? l.scratch0 : l.scratch1);
}

// Every stage of a launch, by role; `grid_sync` separates stages (the
// chain's grid barrier). Stage k >= 1 reads what stage k - 1 wrote, through
// maps.x[1 + (k - 1) % 2]. The ring counters carry over between stages.
template <int NWG, int kEpi, class GridSync>
__device__ __forceinline__ void run(const Geo& g, unsigned char* smem_raw, const Maps& maps,
                                    const Launch& l, GridSync grid_sync) {
  const Rings r = rings_of(g, setup_smem(g, smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  uint32_t wi = 0, bi = 0;
  if (wg < NWG) {
    if constexpr (NWG == 2) hop::setmaxnreg_inc<232>();
    for (int k = 0; k < l.K; ++k) {
      consume<NWG, kEpi>(g, r, l.dw_w + (long long)k * 9 * g.Cin, l.dw_b + (long long)k * g.Cin,
                           l.pw_b + (long long)k * g.Cout, stage_out(l, k), wi, bi);
      if (k + 1 < l.K) grid_sync();
    }
  } else {
    if constexpr (NWG == 2) hop::setmaxnreg_dec<40>();
    const int t = threadIdx.x - 128 * NWG;
    for (int k = 0; k < l.K; ++k) {
      if (t == 0)
        produce_window(g, r, &maps.x[k == 0 ? 0 : 1 + (k - 1) % 2], wi);
      else if (t == 32)
        produce_weights(g, r, &maps.w128, &maps.w8, k, bi);
      if (k + 1 < l.K) {
        grid_sync();
        hop::fence_proxy_async_global();  // the last stage's stores, for this stage's TMA loads
      }
    }
  }
}

// ---- host ---------------------------------------------------------------------------

// The window map over x (N, H, W, Cin): dims (Cin, W, N * H), box (64, ww, wh).
inline cudaError_t make_x_map(CUtensorMap* map, const void* x, const Geo& g) {
  const cuuint64_t dims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.N * g.H};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Cin * 2, (cuuint64_t)g.W * g.Cin * 2};
  const cuuint32_t box[3] = {(cuuint32_t)KCH, (cuuint32_t)g.ww, (cuuint32_t)g.wh};
  return hop::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The weight maps over K stacked (Cin, Cout) weights: dims (Cout, Cin, K),
// boxes of 64 columns (128-byte swizzle) and of 8 columns (none) x 64 rows.
inline cudaError_t make_w_maps(Maps& m, const void* w, const Geo& g, int K) {
  const cuuint64_t dims[3] = {(cuuint64_t)g.Cout, (cuuint64_t)g.Cin, (cuuint64_t)K};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Cout * 2, (cuuint64_t)g.Cin * g.Cout * 2};
  const cuuint32_t box8[3] = {8, (cuuint32_t)KCH, 1};
  cudaError_t e = hop::make_map_3d(&m.w8, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, dims, strides,
                                   box8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess || g.Cout < 64) return e;
  const cuuint32_t box128[3] = {64, (cuuint32_t)KCH, 1};
  return hop::make_map_3d(&m.w128, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w,
                          dims, strides, box128, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Checks a plan against the shape; cudaErrorInvalidValue if it breaks a rule
// of the kernel (the Python plan never gives such a plan).
inline cudaError_t check_geo(const Geo& g) {
  const bool ok = (g.nwg == 1 || g.nwg == 2) && g.th >= 1 && g.tw >= 1 &&
                  g.th * g.tw <= 64 * g.nwg && g.kpc >= 1 && g.split >= 1 && g.cw >= 8 &&
                  g.cw % 8 == 0 && g.ws >= 1 && g.bs >= 2 && g.wh <= 256 && g.ww <= 256 &&
                  g.smem_bytes <= SMEM_LIMIT && (long long)g.split * g.cw >= g.Cout;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sw
}  // namespace mnk
