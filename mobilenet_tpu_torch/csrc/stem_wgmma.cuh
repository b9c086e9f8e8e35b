// The bf16 stem kernels on Hopper: the 3x3 s2 stem alone (stem_conv) or
// with block 0's depthwise and pointwise after it (stem_block0). stem.cu
// launches them; float32 stays on its CUDA-core kernels there.
//
// stem_conv's stem is an im2col product on the tensor cores: each output
// pixel is one 64-byte row of an A panel holding its 27 taps in (dy, dx, c)
// order and 5 zero columns (K = 32, two k16 steps), B the 32 x Cout weight
// (rows 27-31 zero), both bf16, the sums in f32 (wgmma m64nNk16, N = 64, 32,
// 16 or 8 a slice): no multiply-add reads a shared-memory operand on the CUDA
// cores; the per-pixel work is gathering 27 values into the row. The A panel
// is K-major with the 128-byte swizzle (rows of 128 bytes, of which the
// first 64 logical bytes hold K; chunk j of row r at j ^ (r % 8)), as
// separable_wgmma.cuh's panel; B is MN-major without swizzle (8-column
// blocks of 32 K rows x 16 bytes, 512 bytes apart), resident in shared
// memory for the whole launch. The tensor cores sum in another order than
// the plain version, so a stem output may round one bf16 step apart.
//
// stem_block0 keeps its stem exact instead: a product of two bf16 values is
// exact in f32, so an FMA chain over the 27 taps in (dy, dx, c) order rounds
// as the plain version's multiply-then-add does, bit for bit. (On wgmma a
// one-step flip of a stem value, carried through the depthwise and the
// pointwise, failed the bf16 gate at batch 256.) A thread owns a halo pixel
// and its 27 normalized taps in registers; the f32 weights come as
// warp-uniform 16-byte broadcasts from shared memory, 8 channels' chains at
// a time. The depthwise is exact the same way; only the pointwise (on
// wgmma) sums in another order.
//
// Both kernels run a persistent grid over output tiles (ops/stem.stem_plan
// gives the tile and the grid). A tile's input window is staged by cp.async
// as the 16-byte granules that hold each of its rows (any row pitch, any
// base alignment: a granule that holds one byte of the tensor lies inside
// its pages), double-buffered: the next tile's window loads while this one
// computes. A row's byte offset inside its first granule is kept beside it
// (roff; -1: the row is outside the image, and reads as zeros). Columns
// outside the image read as zeros: the TF-SAME pad is 0 in the normalized
// domain, not normalize(0) = -1.
//
// stem_conv (one warpgroup a block): a tile of th x tw output pixels (whole
// rows where Ws <= 128) in steps of 128 pixels: each thread gathers one A row
// into a ring of two 128-row slots, one barrier a step, then two m64 blocks
// x the slices of Cout, the epilogue of separable_wgmma.cuh (+ bias in f32,
// ReLU(6), bf16, 16-byte stores).
//
// stem_block0 (two warpgroups): a tile of th x 16 outputs of block 0 (th 12
// or 6) and its one-pixel halo ((th + 2) x 18 <= 256 pixels: a thread a
// pixel). (1) the uint8 window, normalized as it is gathered (a float32
// multiply, then an add, rounded to bf16); (2) the stem, + bias, activation,
// rounded to bf16, kept as f32 in a stem tile (128 bytes a pixel, 16-byte
// chunks swizzled by pixel); halo pixels outside the stem grid are 0, not
// computed; (3) block 0's depthwise 3x3 s1 (f32 taps in (dy, dx) order, +
// bias, activation, rounded), a thread a group of 4 channels down a column
// strip of th / 2 pixels, its taps sliding in registers, straight into a
// K-major swizzled A panel; (4) the pointwise 32 -> Cout on wgmma with the
// weight resident, and the separable epilogue. Nothing between the stages
// reaches device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "numerics.cuh"
#include "separable_wgmma.cuh"

namespace mnk {
namespace stw {

using bf16 = __nv_bfloat16;

constexpr int KS = 32;            // the product's K: 27 taps (or block 0's 32 channels)
constexpr int AROW = 128;         // bytes an A row takes (128-byte swizzle; 64 hold K)
constexpr int BBLK = KS * 16;     // an 8-column block of B: 32 K rows x 16 bytes
constexpr int STEP = 128;         // stem_conv: pixels a step (a thread a row)
constexpr int HW0 = 18;           // stem_block0: the halo tile's width (16 + 2)
constexpr int SMEM_LIMIT = sw::SMEM_LIMIT;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up16(int a) { return (a + 15) / 16 * 16; }

// A window row's pitch in shared memory: the granules that can hold `bytes`
// bytes at any offset.
__host__ __device__ inline int pitch_of(int bytes) { return 16 * (cdiv(bytes, 16) + 1); }

struct Geo {
  int N, H, W, Cout, Hs, Ws, relu6;
  int th, tw, tiles_h, tiles_w, tiles;
  int pt, pl;        // the stem's top and left pad (TF-SAME: 1 on an odd side)
  int wr, wc, pb;    // window rows, columns, bytes a pixel (3 channels)
  int pitch;
  int b_off, bias_off, stem_off, win_off, roff_off, smem_bytes;  // the A panel at 0
  float scale, offset;
};

// stem_conv: x (N, H, W, 3) bf16 -> (N, ceil(H/2), ceil(W/2), Cout).
__host__ __device__ inline Geo conv_geo(int N, int H, int W, int Cout, int relu6, int th,
                                        int tw) {
  Geo g{};
  g.N = N; g.H = H; g.W = W; g.Cout = Cout; g.relu6 = relu6 != 0;
  g.Hs = (H + 1) / 2; g.Ws = (W + 1) / 2;
  g.th = th; g.tw = tw;
  g.tiles_h = cdiv(g.Hs, th); g.tiles_w = cdiv(g.Ws, tw);
  g.tiles = N * g.tiles_h * g.tiles_w;
  g.pt = H % 2; g.pl = W % 2;
  g.wr = 2 * th + 1; g.wc = 2 * tw + 1; g.pb = 6;
  g.pitch = pitch_of(g.wc * g.pb);
  g.b_off = 2 * STEP * AROW;  // after an A ring of two step slots
  g.bias_off = g.b_off + Cout / 8 * BBLK;
  g.win_off = g.bias_off + up16(2 * Cout);
  g.roff_off = g.win_off + 2 * g.wr * g.pitch;
  g.smem_bytes = 1024 + g.roff_off + 2 * g.wr * 4;  // + 1024 to align the base
  return g;
}

// stem_block0: images (N, H, W, 3) uint8, H and W even -> (N, H/2, W/2, Cout).
__host__ __device__ inline Geo b0_geo(int N, int H, int W, int Cout, int relu6, int th,
                                      float scale, float offset) {
  Geo g{};
  g.N = N; g.H = H; g.W = W; g.Cout = Cout; g.relu6 = relu6 != 0;
  g.Hs = H / 2; g.Ws = W / 2;
  g.th = th; g.tw = 16;
  g.tiles_h = cdiv(g.Hs, th); g.tiles_w = cdiv(g.Ws, 16);
  g.tiles = N * g.tiles_h * g.tiles_w;
  g.pt = 0; g.pl = 0;
  g.wr = 2 * (th + 2) + 1; g.wc = 2 * HW0 + 1; g.pb = 3;
  g.pitch = pitch_of(g.wc * g.pb);
  const int hp = (th + 2) * HW0;  // halo pixels
  g.b_off = cdiv(th * 16, 64) * 64 * AROW;  // after the pointwise's A panel: its weight
  g.bias_off = g.b_off + Cout / 8 * BBLK;  // the stem's weight and bias (f32), pw_b
  g.stem_off = g.bias_off + 28 * KS * 4 + up16(2 * Cout);
  g.win_off = g.stem_off + hp * KS * 4;
  g.roff_off = g.win_off + 2 * g.wr * g.pitch;
  g.smem_bytes = 1024 + g.roff_off + 2 * g.wr * 4;
  g.scale = scale; g.offset = offset;
  return g;
}

struct Tile {
  int n, t0, u0;   // image, first output row and column
  int r0, c0;      // the window's first input row and column (may be negative)
  int cs, ce;      // the window's columns inside the image: [cs, ce)
};

// Tile `t`; `halo` 1 for stem_block0 (its window covers the stem's halo).
__device__ __forceinline__ Tile tile_of(const Geo& g, int t, int halo) {
  Tile x;
  const int tw_i = t % g.tiles_w;
  t /= g.tiles_w;
  x.n = t / g.tiles_h;
  x.t0 = (t - x.n * g.tiles_h) * g.th;
  x.u0 = tw_i * g.tw;
  x.r0 = 2 * (x.t0 - halo) - g.pt;
  x.c0 = 2 * (x.u0 - halo) - g.pl;
  x.cs = max(x.c0, 0);
  x.ce = min(x.c0 + g.wc, g.W);
  return x;
}

// Issues the cp.async copies of tile x's window into win (rows of g.pitch
// bytes) and writes each row's granule offset (or -1) to roff: a warp a
// row, a lane a granule.
template <int kThreads>
__device__ __forceinline__ void stage_window(const Geo& g, const Tile& x,
                                             const unsigned char* __restrict__ src,
                                             unsigned char* win, int* roff) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < g.wr; r += kThreads / 32) {
    const int hi = x.r0 + r;
    if (hi < 0 || hi >= g.H) {
      if (lane == 0) roff[r] = -1;
      continue;
    }
    const uintptr_t s = reinterpret_cast<uintptr_t>(
        src + (((long long)x.n * g.H + hi) * g.W + x.cs) * g.pb);
    if (lane == 0) roff[r] = int(s & 15);
    const uintptr_t e = s + (uintptr_t)(x.ce - x.cs) * g.pb;
    const int count = int(((e - 1) >> 4) - (s >> 4)) + 1;
    const uintptr_t g0 = s & ~uintptr_t(15);
    for (int k = lane; k < count; k += 32)
      hop::cp_async16(win + r * g.pitch + 16 * k, reinterpret_cast<const void*>(g0 + 16 * k));
  }
}

// Stores a pixel's 32 K values (bf16 bit pairs, k = 2i low half) as row m
// of a 128-byte-swizzled K-major panel.
__device__ __forceinline__ void store_row(unsigned char* a, int m, const uint32_t (&w)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(a + m * AROW + ((j ^ (m & 7)) << 4)) =
        make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

// The 27 taps of the stem pixel whose window starts at window row wr0 and
// input column wi0 (its dy = dx = 0 tap), as bf16 bits in (dy, dx, c) order,
// then 5 zeros. `get(p)` turns the element at p into bf16 bits.
template <class Get>
__device__ __forceinline__ void gather(const Geo& g, const unsigned char* win, const int* roff,
                                       int wr0, int wi0, int cs, Get get, uint32_t (&w)[16]) {
  uint32_t h[32];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int off = roff[wr0 + dy];
    const unsigned char* rp = win + (wr0 + dy) * g.pitch + off;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int wi = wi0 + dx;
      const bool ok = off >= 0 && (unsigned)wi < (unsigned)g.W;
      const unsigned char* pp = ok ? rp + (wi - cs) * g.pb : win;  // a valid address either way
#pragma unroll
      for (int c = 0; c < 3; ++c) h[(dy * 3 + dx) * 3 + c] = ok ? get(pp, c) : 0u;
    }
  }
#pragma unroll
  for (int k = 27; k < 32; ++k) h[k] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = h[2 * i] | (h[2 * i + 1] << 16);
}

// Copies a (rows, cols) row-major weight into B's layout (rows < KS: the
// rest zero), element by element: no alignment asked of w.
template <int kThreads>
__device__ __forceinline__ void load_b(unsigned char* b, const bf16* __restrict__ w, int rows,
                                       int cols) {
  const uint16_t* wb = reinterpret_cast<const uint16_t*>(w);
  for (int i = threadIdx.x; i < KS * cols; i += kThreads) {
    const int k = i / cols, n = i - k * cols;
    *reinterpret_cast<uint16_t*>(b + (n >> 3) * BBLK + k * 16 + (n & 7) * 2) =
        k < rows ? wb[k * cols + n] : uint16_t(0);
  }
}

// One slice of N output columns at col0: d (64 x N) = the 64 rows of A at a
// (a 1024-aligned run of 128-byte rows) x B's columns col0..col0+N-1.
template <int N>
__device__ __forceinline__ void mma_slice(float (&acc)[N / 2], uint32_t a, uint32_t b, int col0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  hop::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2; ++k)
    hop::Wgmma<N>::mma(acc, hop::gmma_desc(a + 32 * k, 16, 1024, hop::kSwizzle128),
                       hop::gmma_desc(b + (col0 >> 3) * BBLK + 256 * k, 128, BBLK,
                                      hop::kInterleave));
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
}

// The output slices of a 64-row block: + bias (bf16 pairs in shared
// memory), activation, bf16, the separable epilogue's 16-byte stores to
// output pixels pA and pB (-1: none).
template <int N>
__device__ __forceinline__ void out_slice(const sw::Geo& sg, uint32_t a, uint32_t b,
                                          const unsigned char* bias, int col0, long long pA,
                                          long long pB, bf16* __restrict__ out) {
  float acc[N / 2];
  mma_slice<N>(acc, a, b, col0);
  uint32_t bw[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    bw[i] = *reinterpret_cast<const uint32_t*>(bias + 2 * (col0 + 8 * i + 2 * (threadIdx.x & 3)));
  sw::epilogue<N, true>(sg, acc, bw, pA, pB, out, col0);
}

__device__ __forceinline__ void out_block(const sw::Geo& sg, uint32_t a, uint32_t b,
                                          const unsigned char* bias, long long pA, long long pB,
                                          bf16* __restrict__ out) {
  int col = 0;
  for (; col + 64 <= sg.Cout; col += 64) out_slice<64>(sg, a, b, bias, col, pA, pB, out);
  if (col + 32 <= sg.Cout) {
    out_slice<32>(sg, a, b, bias, col, pA, pB, out);
    col += 32;
  }
  if (col + 16 <= sg.Cout) {
    out_slice<16>(sg, a, b, bias, col, pA, pB, out);
    col += 16;
  }
  if (col < sg.Cout) out_slice<8>(sg, a, b, bias, col, pA, pB, out);
}

// The epilogue's view of the output: only Cout and relu6 are read.
__device__ __forceinline__ sw::Geo out_geo(const Geo& g) {
  sw::Geo s{};
  s.Cout = g.Cout;
  s.relu6 = g.relu6;
  return s;
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((1024 - (hop::saddr(raw) & 1023)) & 1023);
}

// ---- stem_conv ----------------------------------------------------------------------

constexpr int CONV_THREADS = 128;

// A bf16 channel's bits.
struct Bf16Bits {
  __device__ __forceinline__ uint32_t operator()(const unsigned char* p, int c) const {
    return *reinterpret_cast<const uint16_t*>(p + 2 * c);
  }
};

__device__ __forceinline__ void conv_run(const Geo& g, const bf16* __restrict__ x,
                                         const bf16* __restrict__ w,
                                         const bf16* __restrict__ b, bf16* __restrict__ out,
                                         unsigned char* raw) {
  unsigned char* base = aligned_base(raw);
  unsigned char* A = base;
  unsigned char* B = base + g.b_off;
  unsigned char* bias = base + g.bias_off;
  unsigned char* win = base + g.win_off;
  int* roff = reinterpret_cast<int*>(base + g.roff_off);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const sw::Geo sg = out_geo(g);

  load_b<CONV_THREADS>(B, w, 27, g.Cout);
  for (int i = t; i < g.Cout; i += CONV_THREADS)
    reinterpret_cast<uint16_t*>(bias)[i] = reinterpret_cast<const uint16_t*>(b)[i];

  const int P = g.th * g.tw, steps = cdiv(P, STEP);
  int tile = blockIdx.x;
  if (tile < g.tiles) stage_window<CONV_THREADS>(g, tile_of(g, tile, 0), src, win, roff);
  hop::cp_async_commit();
  uint32_t slot = 0;
  for (int it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1, nxt = tile + gridDim.x;
    if (nxt < g.tiles)
      stage_window<CONV_THREADS>(g, tile_of(g, nxt, 0), src, win + (buf ^ 1) * g.wr * g.pitch,
                                 roff + (buf ^ 1) * g.wr);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();
    const Tile x = tile_of(g, tile, 0);
    const unsigned char* wn = win + buf * g.wr * g.pitch;
    const int* ro = roff + buf * g.wr;
    for (int s = 0; s < steps; ++s, slot ^= 1) {
      unsigned char* a = A + slot * STEP * AROW;
      const int m = s * STEP + t;
      if (m < P) {
        const int ih = m / g.tw, iw = m - ih * g.tw;
        uint32_t wv[16];
        gather(g, wn, ro, 2 * ih, x.c0 + 2 * iw, x.cs, Bf16Bits{}, wv);
        store_row(a, t, wv);
      }
      hop::fence_proxy_async_smem();
      __syncthreads();  // the slot's rows, for wgmma; the other slot is free
      for (int mb = 0; mb < 2 && s * STEP + 64 * mb < P; ++mb) {
        long long p[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mm = s * STEP + 64 * mb + 16 * warp + (lane >> 2) + 8 * h;
          const int ih = mm / g.tw, ho = x.t0 + ih, wo = x.u0 + mm - ih * g.tw;
          p[h] = (mm < P && ho < g.Hs && wo < g.Ws)
                     ? ((long long)x.n * g.Hs + ho) * g.Ws + wo
                     : -1;
        }
        out_block(sg, hop::saddr(a + 64 * mb * AROW), hop::saddr(B), bias, p[0], p[1], out);
      }
    }
  }
}

// ---- stem_block0 --------------------------------------------------------------------

constexpr int B0_THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The stem tile: pixel q's 32 f32 channels in 8 chunks of 4, chunk j at
// position j ^ (q % 8).
__device__ __forceinline__ int stem_at(int q, int j) { return q * KS + ((j ^ (q & 7)) << 2); }

// The stem of halo pixel m (row hr, column hc of the halo tile) into the
// stem tile: its 27 taps normalized (a float32 multiply, then an add,
// rounded to bf16; 0 outside the image) into registers, then FMA chains of
// 8 channels at a time, taps in (dy, dx, c) order from 0, the weights as
// warp-uniform 16-byte broadcasts; + bias, activation, rounded; 0 outside
// the stem grid.
__device__ __forceinline__ void stem_pixel(const Geo& g, const Tile& x, const unsigned char* win,
                                           const int* roff, const float* sw, const float* sb,
                                           float* stem, int m) {
  const int hr = m / HW0, hc = m - hr * HW0;
  const int i = x.t0 - 1 + hr, j = x.u0 - 1 + hc;
  if (i < 0 || i >= g.Hs || j < 0 || j >= g.Ws) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<float4*>(stem + stem_at(m, q)) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float xv[27];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int off = roff[2 * hr + dy];
    const unsigned char* rp = win + (2 * hr + dy) * g.pitch + off;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int wi = x.c0 + 2 * hc + dx;
      const bool ok = off >= 0 && (unsigned)wi < (unsigned)g.W;
      const unsigned char* pp = ok ? rp + (wi - x.cs) * 3 : win;  // a valid address either way
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xv[(dy * 3 + dx) * 3 + c] =
            ok ? round_bf16(__fadd_rn(__fmul_rn(float(pp[c]), g.scale), g.offset)) : 0.0f;
    }
  }
#pragma unroll
  for (int c8 = 0; c8 < KS; c8 += 8) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const float4 w0 = *reinterpret_cast<const float4*>(sw + t * KS + c8);
      const float4 w1 = *reinterpret_cast<const float4*>(sw + t * KS + c8 + 4);
      acc[0] = fmaf(xv[t], w0.x, acc[0]);
      acc[1] = fmaf(xv[t], w0.y, acc[1]);
      acc[2] = fmaf(xv[t], w0.z, acc[2]);
      acc[3] = fmaf(xv[t], w0.w, acc[3]);
      acc[4] = fmaf(xv[t], w1.x, acc[4]);
      acc[5] = fmaf(xv[t], w1.y, acc[5]);
      acc[6] = fmaf(xv[t], w1.z, acc[6]);
      acc[7] = fmaf(xv[t], w1.w, acc[7]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v;
      v.x = round_bf16(act(acc[4 * h] + sb[c8 + 4 * h], g.relu6));
      v.y = round_bf16(act(acc[4 * h + 1] + sb[c8 + 4 * h + 1], g.relu6));
      v.z = round_bf16(act(acc[4 * h + 2] + sb[c8 + 4 * h + 2], g.relu6));
      v.w = round_bf16(act(acc[4 * h + 3] + sb[c8 + 4 * h + 3], g.relu6));
      *reinterpret_cast<float4*>(stem + stem_at(m, (c8 >> 2) + h)) = v;
    }
  }
}

// Block 0's depthwise of one column strip of kS output pixels (tile column
// iw, rows ih0..ih0+kS-1) for channels 4j..4j+3: taps slide down the strip
// in registers (each stem row loaded once), every output's sum in (dy, dx)
// order, + bias, activation, rounded, into rows of the A panel.
template <int kS>
__device__ __forceinline__ void depthwise_strip(const Geo& g, const float* stem, int ih0, int iw,
                                                int j, const float (&wd)[9][4],
                                                const float (&bd)[4], unsigned char* a) {
  float acc[kS][4];
#pragma unroll
  for (int y = 0; y < kS; ++y)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[y][e] = 0.0f;
#pragma unroll
  for (int yr = 0; yr < kS + 2; ++yr) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float4 v =
          *reinterpret_cast<const float4*>(stem + stem_at((ih0 + yr) * HW0 + iw + dx, j));
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int y = yr - dy;
        if (y < 0 || y >= kS) continue;
        acc[y][0] = fmaf(v.x, wd[dy * 3 + dx][0], acc[y][0]);
        acc[y][1] = fmaf(v.y, wd[dy * 3 + dx][1], acc[y][1]);
        acc[y][2] = fmaf(v.z, wd[dy * 3 + dx][2], acc[y][2]);
        acc[y][3] = fmaf(v.w, wd[dy * 3 + dx][3], acc[y][3]);
      }
    }
  }
#pragma unroll
  for (int y = 0; y < kS; ++y) {
    const int m = (ih0 + y) * 16 + iw;
    *reinterpret_cast<uint2*>(a + m * AROW + (((j >> 1) ^ (m & 7)) << 4) + (j & 1) * 8) =
        make_uint2(sw::pack2(act(acc[y][0] + bd[0], g.relu6), act(acc[y][1] + bd[1], g.relu6)),
                   sw::pack2(act(acc[y][2] + bd[2], g.relu6), act(acc[y][3] + bd[3], g.relu6)));
  }
}

template <int kTH>
__device__ __forceinline__ void b0_run(const Geo& g, const uint8_t* __restrict__ x,
                                       const bf16* __restrict__ stem_w,
                                       const bf16* __restrict__ stem_b,
                                       const bf16* __restrict__ dw_w,
                                       const bf16* __restrict__ dw_b,
                                       const bf16* __restrict__ pw_w,
                                       const bf16* __restrict__ pw_b, bf16* __restrict__ out,
                                       unsigned char* raw) {
  constexpr int HP = (kTH + 2) * HW0, PMB = (kTH * 16 + 63) / 64;
  static_assert(HP <= B0_THREADS, "a halo pixel a thread");
  unsigned char* base = aligned_base(raw);
  unsigned char* A = base;
  unsigned char* Bp = base + g.b_off;
  float* sw = reinterpret_cast<float*>(base + g.bias_off);  // the stem weight, 27 x 32
  float* sb = sw + 27 * KS;
  unsigned char* pb = reinterpret_cast<unsigned char*>(sb + KS);
  float* stem = reinterpret_cast<float*>(base + g.stem_off);
  unsigned char* win = base + g.win_off;
  int* roff = reinterpret_cast<int*>(base + g.roff_off);
  const int t = threadIdx.x, lane = t & 31, warp = (t >> 5) & 3, wg = t >> 7;
  const sw::Geo sg = out_geo(g);

  load_b<B0_THREADS>(Bp, pw_w, KS, g.Cout);
  for (int i = t; i < 27 * KS; i += B0_THREADS) sw[i] = __bfloat162float(stem_w[i]);
  if (t < KS) sb[t] = __bfloat162float(stem_b[t]);
  for (int i = t; i < g.Cout; i += B0_THREADS)
    reinterpret_cast<uint16_t*>(pb)[i] = reinterpret_cast<const uint16_t*>(pw_b)[i];
  // this thread's depthwise: channels 4j..4j+3 of column strip t / 8
  const int j = t & 7, strip = t >> 3;
  const int iw = strip & 15, ih0 = (strip >> 4) * (kTH / 2);
  float wd[9][4], bd[4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) wd[k][e] = __bfloat162float(dw_w[k * KS + 4 * j + e]);
#pragma unroll
  for (int e = 0; e < 4; ++e) bd[e] = __bfloat162float(dw_b[4 * j + e]);

  int tile = blockIdx.x;
  if (tile < g.tiles) stage_window<B0_THREADS>(g, tile_of(g, tile, 1), x, win, roff);
  hop::cp_async_commit();
  for (int it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1, nxt = tile + gridDim.x;
    if (nxt < g.tiles)
      stage_window<B0_THREADS>(g, tile_of(g, nxt, 1), x, win + (buf ^ 1) * g.wr * g.pitch,
                               roff + (buf ^ 1) * g.wr);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();  // this tile's window (and, once, the weights); the last A panel is read
    const Tile tx = tile_of(g, tile, 1);

    // 1-2. the stem of the tile and its halo, a pixel a thread
    if (t < HP) stem_pixel(g, tx, win + buf * g.wr * g.pitch, roff + buf * g.wr, sw, sb, stem, t);
    __syncthreads();

    // 3. block 0's depthwise into the pointwise's A panel
    depthwise_strip<kTH / 2>(g, stem, ih0, iw, j, wd, bd, A);
    hop::fence_proxy_async_smem();
    __syncthreads();

    // 4. the pointwise on wgmma, the separable epilogue
    for (int mb = wg; mb < PMB; mb += 2) {
      long long p[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * mb + 16 * warp + (lane >> 2) + 8 * h;
        const int ho = tx.t0 + (m >> 4), wo = tx.u0 + (m & 15);
        p[h] = (m < kTH * 16 && ho < g.Hs && wo < g.Ws)
                   ? ((long long)tx.n * g.Hs + ho) * g.Ws + wo
                   : -1;
      }
      out_block(sg, hop::saddr(A + 64 * mb * AROW), hop::saddr(Bp), pb, p[0], p[1], out);
    }
  }
}

// A plan the kernel cannot run: cudaErrorInvalidValue (ops/stem.stem_plan
// never gives one).
inline cudaError_t check_conv(const Geo& g, int grid) {
  const bool ok = g.th >= 1 && g.tw >= 1 && g.tw <= 128 && g.th * g.tw <= 8 * STEP &&
                  g.Cout >= 8 && g.Cout % 8 == 0 && g.Cout <= 256 && grid >= 1 &&
                  g.smem_bytes <= SMEM_LIMIT;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t check_b0(const Geo& g, int grid) {
  const bool ok = (g.th == 12 || g.th == 6) && g.Cout >= 8 && g.Cout % 8 == 0 && grid >= 1 &&
                  g.H % 2 == 0 && g.W % 2 == 0 && g.smem_bytes <= SMEM_LIMIT;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace stw
}  // namespace mnk
