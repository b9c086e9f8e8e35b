// The float32 stem kernels on Hopper: the 3x3 s2 stem alone (stem_conv) or
// with block 0's depthwise and pointwise after it (stem_block0). stem.cu
// launches them; bf16 runs stem_wgmma.cuh.
//
// Exact IEEE float32 on the CUDA cores, in the plain versions' order
// (ops/stem.py): the stem's 27 taps in (dy, dx, c) order, each a __fmul_rn
// then an __fadd_rn (never contracted), + bias, ReLU or ReLU6; stem_block0
// first normalizes the uint8 input (a __fmul_rn, then an __fadd_rn; the
// TF-SAME pad is 0 in the normalized domain, not normalize(0) = -1), and
// after the stem runs block 0's depthwise 3x3 s1 (taps in (dy, dx) order,
// the same multiply-then-add, zero pad in the stem-activation domain, +
// bias, activation) and its pointwise 32 -> Cout (fmaf over k in order, +
// bias, activation). So the stem and the depthwise are bit-equal to the
// plain versions and the pointwise is within float32 rounding of them.
//
// What bounds them on an H100. The exact stem costs two FP instructions a
// tap, 54 an output: at 1.0-224, batch 256, stem_conv issues 5.5 G of them,
// ~0.17 ms at the CUDA cores' issue rate, the same as its bytes bound (154
// MB in, 411 MB out: 0.169 ms). stem_block0 at 1.0-160, batch 256 issues
// ~7.6 G FP instructions (the stem, the depthwise, the pointwise's fmaf),
// ~0.24 ms, against 0.131 ms of bytes. So both are bound by instruction
// issue, and the design spends as few other instructions as it can:
//   - no shared-memory operand per multiply-add: a lane is one output
//     channel and keeps its 27 stem weights in registers; it computes a
//     strip of P pixels along W (stem_conv 8, stem_block0 6) from the
//     strip's window rows, read as warp-uniform 16-byte broadcasts and
//     reused across the strip's overlapping columns (an 8-pixel strip: 13
//     loads a row for 144 FP instructions);
//   - the next window is staged by cp.async into a ring of two slots on
//     mbarriers while this one is computed on;
//   - a persistent grid over the work of ops/stem.f32_stem_plan.
//
// stem_conv (a producer warp and 8 consumer warps): a tile is th rows x tw
// columns of the stem grid (tw a multiple of 8). The producer stages each
// tile's float32 window rows by 16-byte cp.async where a row and its slot
// are 16-byte aligned, else by 4-byte cp.async, the pad zero-filled.
// Consumer thread t owns channel t % Cout; the CONSUMERS / Cout groups of
// Cout threads take the tile's 8-pixel strips in turn. Outputs go straight
// to device memory, a warp's 32 channels of a pixel in one 128-byte line.
//
// stem_block0 (8 warps, each stages, normalizes and computes): a tile is th
// x 16 outputs of block 0 (th 16, 8, 4 or 2), and a unit is `cpu` tiles
// down a 16-column band ("chunks"), so that a chunk reuses the two stem
// rows the chunk above computed: the stem work is 18/16 of the stem's, not
// (th + 2) x 18 / (th x 16). A chunk: (0) its uint8 window (the 16-byte
// granules of each row at any byte offset, a thread a row) lands in its
// ring slot and is normalized into a float32 window; (1) its new stem rows,
// lane = channel, 6-pixel strips by warp, into a stem tile of th + 2 rows
// kept in turn (32 floats a pixel; halo pixels outside the stem grid are
// 0); (2) warp w's depthwise of its block of the tile (4 columns x th / 2
// rows), its stem rows sliding down in registers, into a K-major depthwise
// tile; (3) warp w's pointwise of the same block: fmaf micro-tiles of two
// rows (or one, where two leave lanes idle) of 4 pixels x 8 channels with
// float4 operands, the 32 x Cout weight resident.
// Two barriers a chunk (the window normalized; the stem rows complete); the
// depthwise block is the warp's own, so its pointwise follows at once, and
// the next chunk's window is normalized while other warps finish theirs.
// Nothing between the stages reaches device memory.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace stf {

constexpr int CONSUMERS = 256;           // stem_conv: 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;  // stem_conv: and the producer warp
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use (227 KB)
constexpr int C1 = 32;                   // stem_block0's stem channels
constexpr int B0_TW = 16;                // stem_block0's tile width
constexpr int BARS = 64;                 // bytes kept for the mbarriers
constexpr int CONV_P = 8;                // stem_conv: pixels a strip
constexpr int B0_THREADS = 256;          // stem_block0: 8 warps, each stages and computes
constexpr int B0_P = 6;                  // stem_block0: stem pixels a strip
constexpr int B0_DP = 16 * B0_TW + 4;    // stem_block0: floats a depthwise-tile row holds
constexpr int B0_WB = 4 * 32 + 4;        // stem_block0: floats a pointwise weight block holds
constexpr int B0_HW = B0_TW + 2;         // stem_block0: the stem columns a tile computes
constexpr int B0_PITCH = 3 * (2 * B0_HW + 1) + 1;  // stem_block0's float32 window row

struct Geo {
  int N, H, W, Cout, Hs, Ws, relu6;
  int th, tw, tiles_h, tiles_w, tiles;
  int pt, pl;       // the stem's top and left pad (TF-SAME: 1 on an odd side)
  int hh, hw;       // the stem pixels a tile computes: rows, columns
  int wr, wc;       // window rows, columns (input pixels)
  int pitch;        // floats a float32 window row holds: 3 wc + 1
  int u8pitch;      // stem_block0: bytes a uint8 window row holds (granules)
  int cpu, segs, units;  // stem_block0: chunks a unit walks, units a band, units
  int w_off, win_off, u8_off, roff_off, stem_off, dw_off, smem_bytes;  // bytes
  float scale, offset;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up16(int a) { return (a + 15) / 16 * 16; }

__host__ __device__ inline void tiles_of(Geo& g) {
  g.tiles_h = cdiv(g.Hs, g.th);
  g.tiles_w = cdiv(g.Ws, g.tw);
  g.tiles = g.N * g.tiles_h * g.tiles_w;
  g.wr = 2 * g.hh + 1;
  g.wc = 2 * g.hw + 1;
  g.pitch = 3 * g.wc + 1;
}

// stem_conv: x (N, H, W, 3) float32 -> (N, ceil(H/2), ceil(W/2), Cout);
// smem: the mbarriers, then a ring of two windows.
__host__ __device__ inline Geo conv_geo(int N, int H, int W, int Cout, int relu6, int th,
                                        int tw) {
  Geo g{};
  g.N = N; g.H = H; g.W = W; g.Cout = Cout; g.relu6 = relu6 != 0;
  g.Hs = (H + 1) / 2; g.Ws = (W + 1) / 2;
  g.th = th; g.tw = tw;
  g.pt = H % 2; g.pl = W % 2;
  g.hh = th; g.hw = tw;
  tiles_of(g);
  g.win_off = BARS;
  g.smem_bytes = g.win_off + 2 * g.wr * g.pitch * 4;
  return g;
}

// stem_block0: images (N, H, W, 3) uint8, H and W even -> (N, H/2, W/2,
// Cout); smem: the mbarriers, the weights (stem 27 x 32 and bias, depthwise
// 9 x 32 and bias, pointwise 32 x Cout in 4-column blocks and bias), two
// uint8 windows and their row offsets, the float32 window, the stem tile,
// the depthwise tile.
__host__ __device__ inline Geo b0_geo(int N, int H, int W, int Cout, int relu6, int th,
                                      int cpu, float scale, float offset) {
  Geo g{};
  g.N = N; g.H = H; g.W = W; g.Cout = Cout; g.relu6 = relu6 != 0;
  g.Hs = H / 2; g.Ws = W / 2;
  g.th = th; g.tw = B0_TW;
  g.hh = th + 2; g.hw = B0_HW;
  tiles_of(g);
  g.cpu = cpu;
  g.segs = cdiv(g.tiles_h, max(cpu, 1));
  g.units = N * g.tiles_w * g.segs;
  g.u8pitch = 16 * (cdiv(g.wc * 3, 16) + 1);
  g.w_off = BARS;
  g.roff_off = g.w_off + (28 * C1 + 10 * C1 + Cout / 4 * B0_WB + Cout) * 4;
  g.u8_off = up16(g.roff_off + 2 * g.wr * 4);
  g.win_off = g.u8_off + 2 * g.wr * g.u8pitch;
  g.stem_off = g.win_off + g.wr * g.pitch * 4;
  g.dw_off = g.stem_off + g.hh * g.hw * C1 * 4;
  g.smem_bytes = g.dw_off + C1 * B0_DP * 4;
  g.scale = scale; g.offset = offset;
  return g;
}

struct Tile {
  int n, t0, u0;  // image, first output row and column
  int r0, c0;     // the window's first input row and column (may be negative)
  int cs, ce;     // the window's columns inside the image: [cs, ce)
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int t) {
  Tile x;
  const int tj = t % g.tiles_w;
  t /= g.tiles_w;
  x.n = t / g.tiles_h;
  x.t0 = (t - x.n * g.tiles_h) * g.th;
  x.u0 = tj * g.tw;
  x.r0 = 2 * x.t0 - g.pt;
  x.c0 = 2 * x.u0 - g.pl;
  x.cs = max(x.c0, 0);
  x.ce = min(x.c0 + g.wc, g.W);
  return x;
}

// The exact stem of a strip of P pixels: win points at the strip's first
// window float in window row 0 (rows `pitch` floats apart, 16-byte
// aligned), w holds the channel's 27 weights in (dy, dx, c) order. The
// window's columns are taken in order, so each output's taps run in (dy,
// dx, c) order and each column's values die after it.
template <int P>
__device__ __forceinline__ void stem_strip(const float* win, int pitch, const float (&w)[27],
                                           float (&acc)[P]) {
  constexpr int NV = ((2 * P + 1) * 3 + 3) / 4;  // float4 loads a row
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    float v[4 * NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(win + dy * pitch + 4 * i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < 2 * P + 1; ++j)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if ((j - dx) % 2 != 0 || j < dx || (j - dx) / 2 >= P) continue;
        const int p = (j - dx) / 2;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[p] = __fadd_rn(acc[p], __fmul_rn(v[3 * j + c], w[(dy * 3 + dx) * 3 + c]));
      }
  }
}

// ---- stem_conv --------------------------------------------------------------------------

// The producer: tile x's window into win (rows of g.pitch floats). A row's
// floats inside the image go by 16-byte cp.async where they and the row's
// slot are 16-byte aligned and whole granules, else by 4-byte cp.async;
// the rest of the row (the TF-SAME pad, rows outside the image) is
// zero-filled.
__device__ __forceinline__ void conv_stage(const Geo& g, const Tile& x,
                                           const float* __restrict__ src, float* win) {
  const int lane = threadIdx.x & 31;
  const int a = 3 * (x.cs - x.c0), b = 3 * (x.ce - x.c0);
  for (int r = 0; r < g.wr; ++r) {
    float* d = win + r * g.pitch;
    const int hi = x.r0 + r;
    const bool row = hi >= 0 && hi < g.H && a < b;
    const float* s0 = src + (((long long)x.n * g.H + (row ? hi : 0)) * g.W + x.cs) * 3 - a;
    if (!row || ((reinterpret_cast<uintptr_t>(s0 + a) & 15) == 0 && (a & 3) == 0 &&
                 (b & 3) == 0)) {
      for (int e = 4 * lane; e < g.pitch; e += 128) {
        const bool in = row && e >= a && e < b;
        hop::cp_async16_zfill(d + e, in ? s0 + e : src, in ? 16u : 0u);
      }
    } else {
      for (int e = lane; e < g.pitch; e += 32) {
        const bool in = e >= a && e < b;
        hop::cp_async4_zfill(d + e, in ? s0 + e : src, in ? 4u : 0u);
      }
    }
  }
}

__device__ __forceinline__ void conv_run(const Geo& g, const float* __restrict__ x,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b, float* __restrict__ out,
                                         unsigned char* base) {
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + 2;
  float* win = reinterpret_cast<float*>(base + g.win_off);
  const int t = threadIdx.x, slot_floats = g.wr * g.pitch;
  if (t == 0) {
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, CONSUMERS);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (t >= CONSUMERS) {  // the producer warp
    for (int tile = blockIdx.x, it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
      const int s = it & 1;
      hop::mbar_wait(empty + s, ((it >> 1) & 1) ^ 1);
      conv_stage(g, tile_of(g, tile), x, win + s * slot_floats);
      hop::cp_async_mbar_arrive(full + s);
    }
    hop::cp_async_wait<0>();
    return;
  }

  // consumer thread t: channel c, in group grp of the G groups of Cout threads
  const int c = t % g.Cout, grp = t / g.Cout, G = CONSUMERS / g.Cout;
  const bool active = grp < G;
  float wr[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) wr[k] = active ? w[k * g.Cout + c] : 0.0f;
  const float bias = active ? b[c] : 0.0f;
  // the group's first strip: row ih0, column CONV_P u0; it steps G strips a turn
  const int sw = g.tw / CONV_P, ih0 = grp / sw, u0 = grp - ih0 * sw, dih = G / sw,
            du = G - dih * sw;
  for (int tile = blockIdx.x, it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    hop::mbar_wait(full + s, (it >> 1) & 1);
    const Tile tx = tile_of(g, tile);
    const float* wn = win + s * slot_floats;
    if (active) {
      for (int ih = ih0, su = u0; ih < g.th; ih += dih, su += du) {
        if (su >= sw) {
          su -= sw;
          ++ih;
          if (ih >= g.th) break;
        }
        const int u = CONV_P * su, ho = tx.t0 + ih, wo = tx.u0 + u;
        if (ho >= g.Hs || wo >= g.Ws) continue;
        float acc[CONV_P];
        stem_strip<CONV_P>(wn + 2 * ih * g.pitch + 6 * u, g.pitch, wr, acc);
        float* o = out + (((long long)tx.n * g.Hs + ho) * g.Ws + wo) * g.Cout + c;
        if (wo + CONV_P <= g.Ws) {
#pragma unroll
          for (int p = 0; p < CONV_P; ++p, o += g.Cout) *o = act(__fadd_rn(acc[p], bias), g.relu6);
        } else {
#pragma unroll
          for (int p = 0; p < CONV_P; ++p, o += g.Cout)
            if (wo + p < g.Ws) *o = act(__fadd_rn(acc[p], bias), g.relu6);
        }
      }
    }
    hop::mbar_arrive(empty + s);
  }
}

// ---- stem_block0 ------------------------------------------------------------------------

// A unit is a column band of 16 outputs of one image over `cpu` tiles of th
// rows ("chunks"), walked down: a chunk reuses the last two stem rows of the
// one above, so only a unit's first chunk computes the stem's top halo row.
// Stem row i of a unit whose first chunk starts at output row ts is kept in
// row (i - ts + 1) mod (th + 2) of the stem tile.
struct Chunk {
  int n, t0, u0;   // image, first output row and column
  int k;           // the chunk's place in its unit
  int r0, rows;    // the window's first input row and its rows to stage
  int c0, cs, ce;  // the window's first input column and its columns inside the image
  int srows;       // stem rows the chunk computes: th + 2 (first) or th
  int sbase;       // the stem-tile row of its first one
  int dbase;       // the stem-tile row of output row t0 - 1 (the depthwise's first)
};

__device__ __forceinline__ Chunk chunk_of(const Geo& g, int unit, int k) {
  Chunk x;
  const int tj = unit % g.tiles_w, rest = unit / g.tiles_w;
  const int sg = rest % g.segs;
  x.n = rest / g.segs;
  x.k = k;
  x.t0 = (sg * g.cpu + k) * g.th;
  x.u0 = tj * B0_TW;
  const bool first = k == 0;
  x.srows = first ? g.hh : g.th;
  x.r0 = first ? 2 * (x.t0 - 1) : 2 * (x.t0 + 1);
  x.rows = 2 * x.srows + 1;
  x.c0 = 2 * (x.u0 - 1);
  x.cs = max(x.c0, 0);
  x.ce = min(x.c0 + g.wc, g.W);
  x.dbase = (k * g.th) % g.hh;
  x.sbase = first ? 0 : (k * g.th + 2) % g.hh;
  return x;
}

// The chunks a unit walks (its last segment may hold fewer).
__device__ __forceinline__ int chunks_of(const Geo& g, int unit) {
  const int sg = (unit / g.tiles_w) % g.segs;
  return min(g.cpu, g.tiles_h - sg * g.cpu);
}

// Every thread: chunk x's uint8 window row `threadIdx.x` (if the window has
// it) as the 16-byte granules that hold it (any row pitch, any base
// alignment: a granule that holds one byte of the tensor lies inside its
// pages), its byte offset in its first granule in roff (-1: the row is
// outside the image); then an arrival on `full` once its copies have landed.
__device__ __forceinline__ void b0_stage(const Geo& g, const Chunk& x,
                                         const uint8_t* __restrict__ src, unsigned char* u8,
                                         int* roff, uint64_t* full) {
  const int r = threadIdx.x, hi = x.r0 + r;
  if (r < x.rows) {
    if (hi < 0 || hi >= g.H || x.cs >= x.ce) {
      roff[r] = -1;
    } else {
      const uintptr_t s = reinterpret_cast<uintptr_t>(
          src + (((long long)x.n * g.H + hi) * g.W + x.cs) * 3);
      const uintptr_t g0 = s & ~uintptr_t(15);
      const int count = int(((s + (uintptr_t)(x.ce - x.cs) * 3 - 1) >> 4) - (s >> 4)) + 1;
      roff[r] = int(s - g0);
      unsigned char* d = u8 + r * g.u8pitch;
      for (int k = 0; k < count; ++k)
        hop::cp_async16(d + 16 * k, reinterpret_cast<const void*>(g0 + 16 * k));
    }
  }
  hop::cp_async_mbar_arrive(full);
}

// The staged uint8 window normalized into the float32 window (a __fmul_rn,
// then an __fadd_rn), four floats a thread a turn; outside the image 0.
__device__ __forceinline__ void b0_normalize(const Geo& g, const Chunk& x,
                                             const unsigned char* u8, const int* roff,
                                             float* win) {
  constexpr int Q = B0_PITCH / 4;  // float4s a row
  constexpr int TURNS = ((2 * (16 + 2) + 1) * Q + B0_THREADS - 1) / B0_THREADS;
  const int a = 3 * (x.cs - x.c0), b = 3 * (x.ce - x.c0), pitch = g.u8pitch;
  const float scale = g.scale, offset = g.offset;
#pragma unroll
  for (int turn = 0; turn < TURNS; ++turn) {
    const int i = threadIdx.x + turn * B0_THREADS;
    if (i >= x.rows * Q) break;
    const int r = i / Q, e = 4 * (i - r * Q), off = roff[r];
    const unsigned char* row = u8 + r * pitch + off - a;  // window float e at row[e]
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = off >= 0 && e + q >= a && e + q < b
                 ? __fadd_rn(__fmul_rn(float(row[e + q]), scale), offset)
                 : 0.0f;
    *reinterpret_cast<float4*>(win + r * B0_PITCH + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Block 0's depthwise of one column strip of 4 outputs (tile columns u..u+3)
// over chunk rows y0..y0+ROWS-1 for channel `lane`: the stem rows slide down
// in registers (6 values a row, each loaded once) into the running sums of
// the output rows they feed; each output's taps in (dy, dx) order, + bias,
// activation, into the K-major depthwise tile (row `lane`).
template <int ROWS>
__device__ __forceinline__ void b0_depthwise(const Geo& g, const Chunk& x, const float* stem,
                                             const float* dww, const float* dwb, float* dws,
                                             int y0, int u) {
  const int lane = threadIdx.x & 31;
  float wd[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wd[k] = dww[k * C1 + lane];
  const float bias = dwb[lane];
  float acc[ROWS][4];
#pragma unroll
  for (int y = 0; y < ROWS; ++y)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[y][p] = 0.0f;
#pragma unroll
  for (int yr = 0; yr < ROWS + 2; ++yr) {
    int sr = x.dbase + y0 + yr;
    if (sr >= g.hh) sr -= g.hh;
    const float* sp = stem + (sr * B0_HW + u) * C1 + lane;
    float v[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = sp[q * C1];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = yr - dy;
      if (y < 0 || y >= ROWS) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          acc[y][p] = __fadd_rn(acc[y][p], __fmul_rn(v[p + dx], wd[dy * 3 + dx]));
    }
    if (yr >= 2) {
      const int y = yr - 2;
      *reinterpret_cast<float4*>(dws + lane * B0_DP + (y0 + y) * B0_TW + u) = make_float4(
          act(__fadd_rn(acc[y][0], bias), g.relu6), act(__fadd_rn(acc[y][1], bias), g.relu6),
          act(__fadd_rn(acc[y][2], bias), g.relu6), act(__fadd_rn(acc[y][3], bias), g.relu6));
    }
  }
}

// The pointwise of RJ rows x 4 tile pixels (from px, the first row's
// first) x 8 output channels, 4q..4q+3 and Cout/2 + 4q..: fmaf over k in
// order with float4 operands (a 4-column block of the weight, 32 rows,
// blocks B0_WB floats apart so that 8 lanes' loads meet no bank twice), +
// bias, activation, two 16-byte stores a pixel (the warp's 8 lanes of one
// pixel store 128 contiguous bytes each time).
template <int RJ>
__device__ __forceinline__ void b0_pointwise(const Geo& g, const Chunk& x, const float* dws,
                                             const float* pw, const float* pb, int px, int q,
                                             float* __restrict__ out) {
  constexpr int PX = 4 * RJ;
  const int half = g.Cout / 2;
  float acc[PX][8];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const float* wk0 = pw + q * B0_WB;
  const float* wk1 = pw + (q + g.Cout / 8) * B0_WB;
#pragma unroll 4
  for (int k = 0; k < C1; ++k) {
    float a[PX];
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(dws + k * B0_DP + px + r * B0_TW);
      a[4 * r] = v.x;
      a[4 * r + 1] = v.y;
      a[4 * r + 2] = v.z;
      a[4 * r + 3] = v.w;
    }
    const float4 w0 = *reinterpret_cast<const float4*>(wk0 + 4 * k);
    const float4 w1 = *reinterpret_cast<const float4*>(wk1 + 4 * k);
    const float bw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
  }
  const float4 b0 = *reinterpret_cast<const float4*>(pb + 4 * q);
  const float4 b1 = *reinterpret_cast<const float4*>(pb + half + 4 * q);
  const int wo = x.u0 + px % B0_TW;
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int ho = x.t0 + px / B0_TW + r;
    if (ho >= g.Hs) break;
    float* o = out + (((long long)x.n * g.Hs + ho) * g.Ws + wo) * g.Cout + 4 * q;
#pragma unroll
    for (int i = 4 * r; i < 4 * r + 4; ++i, o += g.Cout) {
      if (wo + i - 4 * r >= g.Ws) break;
      *reinterpret_cast<float4*>(o) =
          make_float4(act(acc[i][0] + b0.x, g.relu6), act(acc[i][1] + b0.y, g.relu6),
                      act(acc[i][2] + b0.z, g.relu6), act(acc[i][3] + b0.w, g.relu6));
      *reinterpret_cast<float4*>(o + half) =
          make_float4(act(acc[i][4] + b1.x, g.relu6), act(acc[i][5] + b1.y, g.relu6),
                      act(acc[i][6] + b1.z, g.relu6), act(acc[i][7] + b1.w, g.relu6));
    }
  }
}

__device__ __forceinline__ void b0_run(const Geo& g, const uint8_t* __restrict__ x,
                                       const float* __restrict__ stem_w,
                                       const float* __restrict__ stem_b,
                                       const float* __restrict__ dw_w,
                                       const float* __restrict__ dw_b,
                                       const float* __restrict__ pw_w,
                                       const float* __restrict__ pw_b, float* __restrict__ out,
                                       unsigned char* base) {
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // a uint8 window slot has landed
  float* sw = reinterpret_cast<float*>(base + g.w_off);  // 27 x 32, then the bias
  float* dww = sw + 28 * C1;                              // 9 x 32, then the bias
  float* pw = dww + 10 * C1;  // 32 x Cout in blocks of 4 columns (B0_WB), then the bias
  float* pb = pw + g.Cout / 4 * B0_WB;
  int* roff = reinterpret_cast<int*>(base + g.roff_off);
  unsigned char* u8 = base + g.u8_off;
  float* win = reinterpret_cast<float*>(base + g.win_off);
  float* stem = reinterpret_cast<float*>(base + g.stem_off);
  float* dws = reinterpret_cast<float*>(base + g.dw_off);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int i = t; i < 27 * C1; i += B0_THREADS) sw[i] = stem_w[i];
  for (int i = t; i < C1; i += B0_THREADS) {
    sw[27 * C1 + i] = stem_b[i];
    dww[9 * C1 + i] = dw_b[i];
  }
  for (int i = t; i < 9 * C1; i += B0_THREADS) dww[i] = dw_w[i];
  for (int i = t; i < C1 * g.Cout; i += B0_THREADS) {  // blocks of 4 columns x 32 rows
    const int k = i / g.Cout, co = i - k * g.Cout;
    pw[(co >> 2) * B0_WB + 4 * k + (co & 3)] = pw_w[i];
  }
  for (int i = t; i < g.Cout; i += B0_THREADS) pb[i] = pw_b[i];
  if (t == 0) {
    hop::mbar_init(full, B0_THREADS);
    hop::mbar_init(full + 1, B0_THREADS);
    hop::fence_mbar_init();
  }
  __syncthreads();

  // the chunks this block walks: its units in turn, each unit's chunks down its band
  const auto advance = [&](int& un, int& kk) {
    if (++kk >= chunks_of(g, un)) {
      un += gridDim.x;
      kk = 0;
    }
  };
  int unit = blockIdx.x, k = 0;
  if (unit >= g.units) return;
  int u1 = unit, k1 = 0, u2, k2;  // the next chunk and the one after
  advance(u1, k1);
  u2 = u1;
  k2 = k1;
  advance(u2, k2);
  b0_stage(g, chunk_of(g, unit, 0), x, u8, roff, full);
  if (u1 < g.units)
    b0_stage(g, chunk_of(g, u1, k1), x, u8 + g.wr * g.u8pitch, roff + g.wr, full + 1);
  hop::mbar_wait(full, 0);
  b0_normalize(g, chunk_of(g, unit, 0), u8, roff, win);
  // warp w's block of the tile: columns u..u+3, rows y0..y0+th/2-1 (its
  // depthwise, then its pointwise: no other warp reads it)
  const int y0 = (warp >> 2) * (g.th / 2), u = 4 * (warp & 3);
  const int cg = g.Cout / 8;
  const bool pairs = g.th / 4 * cg >= 32;
  const int jobs = (pairs ? g.th / 4 : g.th / 2) * cg;
  for (int i = 0;; ++i) {
    const Chunk cx = chunk_of(g, unit, k);
    const int s = i & 1;
    hop::named_bar_sync(1, B0_THREADS);  // the float32 window is complete; the stem tile is free
    // 1. the chunk's new stem rows: channel = lane, 6-pixel strips by warp
    {
      float wr[27];
#pragma unroll
      for (int q = 0; q < 27; ++q) wr[q] = sw[q * C1 + lane];
      const float bias = sw[27 * C1 + lane];
      const int i0 = cx.k == 0 ? cx.t0 - 1 : cx.t0 + 1;  // the stem row of window row 0
      for (int j = warp; j < cx.srows * (B0_HW / B0_P); j += B0_THREADS / 32) {
        const int sr = j / (B0_HW / B0_P), hc = B0_P * (j - sr * (B0_HW / B0_P));
        float acc[B0_P];
        stem_strip<B0_P>(win + 2 * sr * B0_PITCH + 6 * hc, B0_PITCH, wr, acc);
        const int row = i0 + sr, col = cx.u0 - 1 + hc;
        int tr = cx.sbase + sr;
        if (tr >= g.hh) tr -= g.hh;
        float* o = stem + (tr * B0_HW + hc) * C1 + lane;
        const bool rin = row >= 0 && row < g.Hs;
        if (rin && col >= 0 && col + B0_P <= g.Ws) {
#pragma unroll
          for (int p = 0; p < B0_P; ++p) o[p * C1] = act(__fadd_rn(acc[p], bias), g.relu6);
        } else {
#pragma unroll
          for (int p = 0; p < B0_P; ++p)
            o[p * C1] = rin && col + p >= 0 && col + p < g.Ws
                            ? act(__fadd_rn(acc[p], bias), g.relu6)
                            : 0.0f;
        }
      }
    }
    hop::named_bar_sync(1, B0_THREADS);  // the stem rows are complete; the window is free
    // the chunk after next into this chunk's slot (normalized, by every thread, before
    // the barrier above)
    if (u2 < g.units)
      b0_stage(g, chunk_of(g, u2, k2), x, u8 + s * g.wr * g.u8pitch, roff + s * g.wr, full + s);
    // 2. block 0's depthwise into the K-major depthwise tile
    switch (g.th) {
      case 16: b0_depthwise<8>(g, cx, stem, dww, dww + 9 * C1, dws, y0, u); break;
      case 8: b0_depthwise<4>(g, cx, stem, dww, dww + 9 * C1, dws, y0, u); break;
      case 4: b0_depthwise<2>(g, cx, stem, dww, dww + 9 * C1, dws, y0, u); break;
      default: b0_depthwise<1>(g, cx, stem, dww, dww + 9 * C1, dws, y0, u); break;
    }
    __syncwarp();  // the warp's block of the depthwise tile is complete
    // 3. the pointwise of the warp's block: jobs of two rows of 4 pixels x 8
    // channels where they still fill the warp, else of one row
    if (pairs) {
      for (int j = lane; j < jobs; j += 32)
        b0_pointwise<2>(g, cx, dws, pw, pb, (y0 + 2 * (j / cg)) * B0_TW + u, j % cg, out);
    } else {
      for (int j = lane; j < jobs; j += 32)
        b0_pointwise<1>(g, cx, dws, pw, pb, (y0 + j / cg) * B0_TW + u, j % cg, out);
    }
    if (u1 >= g.units) break;
    // 0. the next chunk's window, normalized, while other warps finish their pointwise
    // (the last reads of the window were before the barrier after the stem)
    hop::mbar_wait(full + (s ^ 1), ((i + 1) >> 1) & 1);
    b0_normalize(g, chunk_of(g, u1, k1), u8 + (s ^ 1) * g.wr * g.u8pitch, roff + (s ^ 1) * g.wr,
                 win);
    unit = u1;
    k = k1;
    u1 = u2;
    k1 = k2;
    advance(u2, k2);
  }
}

// A plan the kernels cannot run: cudaErrorInvalidValue (ops/stem.f32_stem_plan
// never gives one).
inline cudaError_t check_conv(const Geo& g, int grid) {
  const bool ok = g.th >= 1 && g.tw >= CONV_P && g.tw % CONV_P == 0 && g.Cout >= 8 &&
                  g.Cout % 8 == 0 &&
                  g.Cout <= CONSUMERS && grid >= 1 && g.smem_bytes <= SMEM_LIMIT;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t check_b0(const Geo& g, int grid) {
  const bool ok = (g.th == 16 || g.th == 8 || g.th == 4 || g.th == 2) && g.cpu >= 1 &&
                  g.Cout >= 8 &&
                  g.Cout % 8 == 0 && grid >= 1 && g.H % 2 == 0 && g.W % 2 == 0 &&
                  g.smem_bytes <= SMEM_LIMIT;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace stf
}  // namespace mnk
