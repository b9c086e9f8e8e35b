// The float32 fused depthwise-separable block on Hopper's CUDA cores, shared
// by the per-block kernel (separable_block.cu) and the chain kernel
// (chain.cu), so that a chain stage computes bit for bit what one per-block
// launch does on the same plan. IEEE float32: every product an fmaf on the
// CUDA cores (no tensor core, no TF32); the depthwise sums its 9 taps in
// dy-then-dx order, + bias, activation; each output's pointwise sum runs over
// Cin in ascending order in one thread (no split over K), + bias in f32, the
// activation (none at epi kBias, MobileNet-V2's linear block 0; at kRaw the
// float32 sums are stored without bias or activation, numerics.cuh).
//
// What held the old tile (separable_tile.cuh): one 64-pixel x 128-column tile
// a block, not persistent (50,176 blocks at V1 b00, batch 256; 16 blocks at
// batch 1 for the chain); a fixed 128-column tile (half of b00's products,
// seven eighths of V2 b00's, on zero-padded columns); the depthwise recomputed
// for every 128 columns of Cout, each output's 9 taps as scalar synchronous
// device loads; the weight staged by scalar loads with a division and a
// modulo an element; a 4 x 8 micro-tile of 12 shared loads per 32 fmaf; two
// barriers a 32-channel chunk and nothing in flight across them. The design:
//   - Units: a tile of th x tw output pixels (th rows of the N * Ho output
//     rows stacked image after image, so a tile may hold several small
//     images) x a part of cw output columns. The grid is persistent, capped by
//     occupancy; a block walks units u, u + gridDim.x. The plan
//     (ops/separable_block.f32_sep_plan) picks the tile, the part and the
//     micro-tile form so that the units fill the card at batch 1 as at 256.
//   - Two producer warps fill two mbarrier rings, each on its own so that
//     neither waits on the other's slots: the window warp a ring of ws window
//     chunks by 16-byte cp.async (the tile's (th-1)s+3 x (tw-1)s+3 input
//     window, 32 channels a chunk, only the pixels inside the stacked input:
//     the zeros of the padding are never loaded, the depthwise masks those
//     taps; then the chunk's depthwise weights and bias), the weight warp a
//     ring of bs stages by bulk copies, one a row (32 rows of the pointwise
//     weight x a slice's columns). The next chunks, stages and unit load
//     while the consumer warps compute.
//   - Depthwise (8 consumer warps): warp w takes the chunk's channel quad w,
//     a lane the output pixels lane + 32 i; the quad's 9 tap weights and bias
//     (from the chunk's slot) held in registers; the taps read the staged
//     window as float4 (masked outside the image); the result goes into a
//     K-major panel (kp channels x the tile's pixels) that every output slice
//     of the unit reuses. Where Cin does not fit beside the rings (kp < Cin)
//     the panel takes Cin in ranges, and each slice reruns the depthwise of
//     each range.
//   - Pointwise: the part's columns in slices of up to ns (the plan's width;
//     the rest of the part as one narrower slice, a multiple of 8: no padded
//     column). A thread holds an MR x MR register micro-tile (MR = 4 MG: 8 x 8
//     or 4 x 4), rows mt*4 (+ TMP/2) and columns nt*4 (+ w/2), fed by float4
//     loads of the panel's and the stage's rows: MG float4 loads of each a K
//     step, one 16-byte shared load per 16 fmaf at 8 x 8, conflict-free (a
//     quarter warp reads consecutive float4 or one broadcast). The epilogue
//     adds the bias in f32, applies the activation and stores 16 bytes.
//   Barriers of the consumer warps: two a depthwise pass (the panel's readers
//   done, the panel complete); the rings' mbarriers otherwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace sf {

constexpr int WC = 32;                    // channels a window chunk: a quad a consumer warp
constexpr int WSTR = WC + 4;              // floats a staged pixel: quarter warps spread over the banks
constexpr int WTAIL = 10 * WC;            // floats after a chunk's pixels: 9 tap rows, the bias
constexpr int KB = 32;                    // weight rows a stage
constexpr int CONSUMERS = 256;            // 8 consumer warps
constexpr int THREADS = CONSUMERS + 64;   // + the window and the weight producer warps
constexpr int MAX_TMP = 256;              // tile pixels (rounded up to 4 MG): 8 a depthwise lane
constexpr int MAX_WS = 4, MAX_BS = 4;     // ring slots
constexpr int HEAD = 128;                 // the rings' barriers
constexpr int SMEM_LIMIT = 232448 - 256;  // 227 KB less a stage shape's room, as v3_f32.cuh
static_assert(WC % KB == 0, "a range of whole chunks ends at a weight stage's end");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int rup(int a, int m) { return cdiv(a, m) * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The plan (ops/separable_block.f32_sep_plan).
struct Plan {
  int mg;       // micro-tile form: MR = 4 * mg rows and columns a thread (8 x 8 or 4 x 4)
  int th, tw;   // tile rows (of the N * Ho stacked output rows) and columns
  int kp;       // panel channels (a multiple of WC); below Cin: Cin in ranges
  int split;    // output-column parts a tile
  int cw;       // columns a part (a multiple of 8)
  int ns;       // columns a slice at most (a multiple of 8): a stage's width
  int ws, bs;   // window and weight ring slots
};

struct Geo {
  int N, H, W, Cin, Cout, stride, pad, Ho, Wo, relu6, epi;
  int mg, th, tw, kp, split, cw, ns, ws, bs;
  int rows, tiles_c;       // stacked output rows (N * Ho); tiles along Wo
  int tiles, units;        // tiles; units (tiles x split)
  int TM, TMP, ph, pw, tm_t, nr;  // tile pixels, rounded up to 4 mg; window sides; thread rows; ranges
  int win_bytes, stage_bytes, off_w, off_b, off_a, smem_bytes;
};

// The shared-memory plan; mirrored by ops/separable_block.f32_sep_smem_bytes.
// From the base: the barriers (HEAD), ws window chunks (ph x pw pixels of WSTR
// floats, then the chunk's 9 depthwise tap rows and its bias, WC floats
// each), bs weight stages (KB rows x ns floats), the panel (kp rows x TMP
// floats), each rounded up to 128 bytes.
__host__ __device__ inline Geo make_geo(int N, int H, int W, int Cin, int Cout, int stride,
                                        int relu6, int epi, const Plan& p) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.stride = stride;
  g.relu6 = relu6; g.epi = epi;
  g.pad = stride == 1 ? 1 : 0;  // TF-SAME: stride 2 (even input) pads only at the high end
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.mg = p.mg; g.th = p.th; g.tw = p.tw; g.kp = p.kp; g.split = p.split; g.cw = p.cw;
  g.ns = p.ns; g.ws = p.ws; g.bs = p.bs;
  g.rows = N * g.Ho;
  g.tiles_c = cdiv(g.Wo, imax(p.tw, 1));
  const long long tiles = (long long)cdiv(g.rows, imax(p.th, 1)) * g.tiles_c;
  const long long units = tiles * p.split;
  g.tiles = tiles > 0x7fffffffLL ? -1 : (int)tiles;
  g.units = units > 0x7fffffffLL ? -1 : (int)units;
  g.TM = p.th * p.tw;
  g.TMP = rup(g.TM, 4 * imax(p.mg, 1));
  g.ph = (p.th - 1) * stride + 3;
  g.pw = (p.tw - 1) * stride + 3;
  g.tm_t = g.TMP / (4 * imax(p.mg, 1));
  g.nr = cdiv(Cin, imax(p.kp, 1));
  g.win_bytes = rup((g.ph * g.pw * WSTR + WTAIL) * 4, 128);
  g.stage_bytes = rup(KB * p.ns * 4, 128);
  g.off_w = HEAD;
  g.off_b = g.off_w + p.ws * g.win_bytes;
  g.off_a = g.off_b + p.bs * g.stage_bytes;
  g.smem_bytes = g.off_a + rup(p.kp * g.TMP * 4, 128);
  return g;
}

// Checks a shape and plan; false if they break a rule of the kernel (the
// Python plan never gives such a plan).
__host__ __device__ inline bool geo_ok(const Geo& g) {
  return g.N > 0 && g.H > 0 && g.W > 0 && g.Cin > 0 && g.Cout > 0 && g.Cin % 8 == 0 &&
         g.Cout % 8 == 0 && (g.stride == 1 || (g.stride == 2 && g.H % 2 == 0 && g.W % 2 == 0)) &&
         (g.mg == 1 || g.mg == 2) && g.th >= 1 && g.tw >= 1 && g.TMP <= MAX_TMP &&
         g.kp >= WC && g.kp % WC == 0 && g.kp <= rup(g.Cin, WC) && g.cw >= 8 && g.cw % 8 == 0 &&
         g.split == cdiv(g.Cout, g.cw) && g.ns >= 8 && g.ns % 8 == 0 &&
         g.tm_t * (g.ns / (4 * g.mg)) <= CONSUMERS && g.ws >= 1 && g.ws <= MAX_WS &&
         g.bs >= 1 && g.bs <= MAX_BS && g.tiles > 0 && g.units > 0 &&
         g.smem_bytes <= SMEM_LIMIT;
}

// The tensors of a block.
struct Ptrs {
  const float *x, *dw, *db, *pw, *pb;
  float* out;
};

// A unit: its tile's first stacked output row and column, its part's
// columns [c0, c1), and its window's origin in the stacked input (row sr0 of
// the N * H rows, column sc0) with the staged region (window rows ry0..ry1,
// columns rx0..rx1: those inside the stacked input).
struct Unit {
  int R0, x0, c0, c1, sr0, sc0, ry0, ry1, rx0, rx1;
};

__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  Unit t;
  const int tile = u / g.split, part = u - tile * g.split;
  const int tr = tile / g.tiles_c;
  t.R0 = tr * g.th;
  t.x0 = (tile - tr * g.tiles_c) * g.tw;
  t.c0 = part * g.cw;
  t.c1 = imin(g.Cout, t.c0 + g.cw);
  t.sr0 = t.R0 * g.stride - g.pad;
  t.sc0 = t.x0 * g.stride - g.pad;
  t.ry0 = imax(0, -t.sr0);
  t.ry1 = imin(g.ph, g.N * g.H - t.sr0);
  t.rx0 = imax(0, -t.sc0);
  t.rx1 = imin(g.pw, g.W - t.sc0);
  return t;
}

struct Bars {
  uint64_t *wfull, *wempty, *bfull, *bempty;
};

__device__ __forceinline__ Bars bars_of(unsigned char* base) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base);
  return Bars{b, b + MAX_WS, b + 2 * MAX_WS, b + 2 * MAX_WS + MAX_BS};
}

// The rings' barriers, initialised once a launch: a window slot's full
// barrier takes the window producer's 32 lanes' cp.async arrivals, a weight
// slot's the weight producer's one arrival with the stage's bytes, which its
// bulk copies complete; an empty barrier the consumer threads' arrivals.
__device__ __forceinline__ void setup(unsigned char* base) {
  if (threadIdx.x == 0) {
    const Bars b = bars_of(base);
    for (int s = 0; s < MAX_WS; ++s) {
      hop::mbar_init(b.wfull + s, 32);
      hop::mbar_init(b.wempty + s, CONSUMERS);
    }
    for (int s = 0; s < MAX_BS; ++s) {
      hop::mbar_init(b.bfull + s, 1);
      hop::mbar_init(b.bempty + s, CONSUMERS);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
}

// A ring cursor of one role: the next slot, and a parity bit a slot that
// flips at each use (the cursor restarts at slot 0 in each run on both sides:
// the chain's stages walk the same sequence on each side).
struct Ring {
  uint32_t cur = 0, par = 0;
  __device__ __forceinline__ uint32_t next(int slots, uint32_t& parity) {
    const uint32_t s = cur;
    cur = s + 1 == (uint32_t)slots ? 0 : s + 1;
    parity = (par >> s) & 1u;
    par ^= 1u << s;
    return s;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 fma4(float4 z, float4 w, float4 a) {
  return make_float4(fmaf(z.x, w.x, a.x), fmaf(z.y, w.y, a.y), fmaf(z.z, w.z, a.z),
                     fmaf(z.w, w.w, a.w));
}

// ---- the producer warp -----------------------------------------------------------------

// The two producer warps walk the consumers' order of work (per unit, per
// slice of its part, per range of Cin: the range's window chunks, on the
// first slice only where one range holds Cin, then its weight stages), each
// filling its own ring, so that neither waits on the other's slots.
// The window warp: a chunk's in-image pixels, then its 9 depthwise tap rows
// and bias, by 16-byte cp.async (through L2: a chain stage reads what other
// blocks stored before its grid barrier), each lane arriving on the slot's
// full barrier when its copies land.
__device__ inline void produce_windows(const Geo& g, const Ptrs& p, unsigned char* base,
                                       Ring& wr) {
  const int lane = threadIdx.x & 31, q = (lane % (WC / 4)) * 4, pj = lane / (WC / 4);
  const Bars bars = bars_of(base);
  wr.cur = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    const int rw = t.rx1 - t.rx0;
    for (int c0 = t.c0; c0 < t.c1; c0 += imin(g.ns, t.c1 - c0)) {
      for (int k0 = 0; k0 < g.Cin; k0 += g.kp) {
        const int k1 = imin(g.Cin, k0 + g.kp);
        if (g.nr == 1 && c0 != t.c0) continue;
        for (int kc = k0; kc < k1; kc += WC) {
          const int live = imin(WC, k1 - kc);  // the chunk's channels
          uint32_t par;
          const uint32_t s = wr.next(g.ws, par);
          hop::mbar_wait(bars.wempty + s, par ^ 1);
          float* win = reinterpret_cast<float*>(base + g.off_w + s * g.win_bytes);
          if (q < live) {  // lane: 16 bytes (q) of every fourth pixel from pj
            for (int wy = t.ry0; wy < t.ry1; ++wy) {
              const float* src =
                  p.x + ((long long)(t.sr0 + wy) * g.W + t.sc0 + t.rx0 + pj) * g.Cin + kc + q;
              float* dst = win + (wy * g.pw + t.rx0 + pj) * WSTR + q;
              for (int px = pj; px < rw; px += 4, src += 4 * g.Cin, dst += 4 * WSTR)
                hop::cp_async16(dst, src);
            }
          }
          float* tail = win + g.ph * g.pw * WSTR;
          for (int i = lane; i < 10 * (WC / 4); i += 32) {
            const int r = i / (WC / 4), c = (i % (WC / 4)) * 4;
            if (c < live)
              hop::cp_async16(tail + r * WC + c, (r < 9 ? p.dw + r * g.Cin : p.db) + kc + c);
          }
          hop::cp_async_mbar_arrive(bars.wfull + s);
        }
      }
    }
  }
  hop::cp_async_wait<0>();
}

// The weight warp: a stage's rows of the slice's columns, a bulk copy a row;
// lane 0 arrives on the slot's full barrier with their bytes.
__device__ inline void produce_weights(const Geo& g, const Ptrs& p, unsigned char* base,
                                       Ring& br) {
  const int lane = threadIdx.x & 31;
  const Bars bars = bars_of(base);
  br.cur = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    for (int c0 = t.c0; c0 < t.c1;) {
      const int w = imin(g.ns, t.c1 - c0);
      for (int kk = 0; kk < g.Cin; kk += KB) {  // a range's stages end at its end: kp % KB == 0
        const int rows = imin(KB, g.Cin - kk);
        uint32_t par;
        const uint32_t s = br.next(g.bs, par);
        uint64_t* full = bars.bfull + s;
        hop::mbar_wait(bars.bempty + s, par ^ 1);
        if (lane == 0) hop::mbar_arrive_expect_tx(full, rows * w * 4);
        float* st = reinterpret_cast<float*>(base + g.off_b + s * g.stage_bytes);
        for (int r = lane; r < rows; r += 32)
          hop::bulk_load(st + r * w, p.pw + (long long)(kk + r) * g.Cout + c0, w * 4, full);
      }
      c0 += w;
    }
  }
}

// ---- the consumer warps ----------------------------------------------------------------

// acc[i][j] += the panel's rows (k, pixel mt*4 + i, + TMP/2 for i >= 4) x the
// stage's rows (k, column nt*4 + j, + w/2 for j >= 4), k ascending.
template <int MG>
__device__ __forceinline__ void product(const float* A, const float* B, int rows, int tmp, int w,
                                        int mt, int nt, float (&acc)[4 * MG][4 * MG]) {
  const float* a0 = A + mt * 4;
  const float* b0 = B + nt * 4;
  const int ha = tmp / 2, hb = w / 2;
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float av[4 * MG], bv[4 * MG];
#pragma unroll
    for (int gg = 0; gg < MG; ++gg) {
      const float4 a = ld4(a0 + k * tmp + gg * ha);
      const float4 b = ld4(b0 + k * w + gg * hb);
      av[4 * gg] = a.x; av[4 * gg + 1] = a.y; av[4 * gg + 2] = a.z; av[4 * gg + 3] = a.w;
      bv[4 * gg] = b.x; bv[4 * gg + 1] = b.y; bv[4 * gg + 2] = b.z; bv[4 * gg + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * MG; ++i)
#pragma unroll
      for (int j = 0; j < 4 * MG; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The depthwise of the chunk's channel quad q (channels ch..ch+3; its 9 tap
// weights and bias from the slot's tail, held in registers) at the thread's
// pixels into the panel rows ch - k0.
__device__ __forceinline__ void depthwise(const Geo& g, const float* win, int q,
                                          const int (&woff)[MAX_TMP / 32],
                                          const uint32_t (&taps)[MAX_TMP / 32],
                                          uint32_t live, float* A) {
  const float* tail = win + g.ph * g.pw * WSTR + 4 * q;
  float4 wt[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wt[i] = ld4(tail + i * WC);
  const float4 bias = ld4(tail + 9 * WC);
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < MAX_TMP / 32; ++j) {
    const int m = lane + 32 * j;
    if (m >= g.TMP) break;
    float4 a = zero;
    if (taps[j] == 0x1ffu) {  // every tap in the image: no masks
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          a = fma4(ld4(win + woff[j] + (dy * g.pw + dx) * WSTR), wt[dy * 3 + dx], a);
    } else {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 z = (taps[j] >> (dy * 3 + dx)) & 1u
                               ? ld4(win + woff[j] + (dy * g.pw + dx) * WSTR)
                               : zero;
          a = fma4(z, wt[dy * 3 + dx], a);
        }
    }
    float4 v = zero;
    if ((live >> j) & 1u)
      v = make_float4(act(a.x + bias.x, g.relu6), act(a.y + bias.y, g.relu6),
                      act(a.z + bias.z, g.relu6), act(a.w + bias.w, g.relu6));
    A[m] = v.x;
    A[g.TMP + m] = v.y;
    A[2 * g.TMP + m] = v.z;
    A[3 * g.TMP + m] = v.w;
  }
}

// + bias in f32, the activation at kBiasAct (at kRaw the sums alone),
// 16-byte stores of the thread's pixels that lie in the output.
template <int MG>
__device__ __forceinline__ void store(const Geo& g, const Unit& t, const Ptrs& p, int c0, int w,
                                      int mt, int nt, const float (&acc)[4 * MG][4 * MG]) {
  const bool raw = g.epi == kRaw;
  float4 b[MG];
#pragma unroll
  for (int gn = 0; gn < MG; ++gn)
    b[gn] = raw ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : __ldg(reinterpret_cast<const float4*>(p.pb + c0 + nt * 4 + gn * (w / 2)));
#pragma unroll
  for (int i = 0; i < 4 * MG; ++i) {
    const int m = mt * 4 + (i & 3) + (i >> 2) * (g.TMP / 2);
    const int r = m / g.tw, xo = t.x0 + m - r * g.tw, R = t.R0 + r;
    if (m >= g.TM || R >= g.rows || xo >= g.Wo) continue;
    float* o = p.out + ((long long)R * g.Wo + xo) * g.Cout + c0 + nt * 4;
#pragma unroll
    for (int gn = 0; gn < MG; ++gn) {
      float4 v = make_float4(acc[i][4 * gn], acc[i][4 * gn + 1], acc[i][4 * gn + 2],
                             acc[i][4 * gn + 3]);
      if (!raw)
        v = make_float4(v.x + b[gn].x, v.y + b[gn].y, v.z + b[gn].z, v.w + b[gn].w);
      if (g.epi == kBiasAct)
        v = make_float4(act(v.x, g.relu6), act(v.y, g.relu6), act(v.z, g.relu6),
                        act(v.w, g.relu6));
      st4(o + gn * (w / 2), v);
    }
  }
}

template <int MG>
__device__ inline void consume(const Geo& g, const Ptrs& p, unsigned char* base, Ring& wr,
                               Ring& br) {
  const int tid = threadIdx.x, lane = tid & 31, quad = tid >> 5;
  const Bars bars = bars_of(base);
  float* A = reinterpret_cast<float*>(base + g.off_a);
  wr.cur = 0;
  br.cur = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    // the depthwise pixels of this thread: their window offsets (at the
    // chunk's quad), their in-image taps (bit dy*3+dx) and whether each lies
    // in the output (else its panel column holds zeros)
    int woff[MAX_TMP / 32];
    uint32_t taps[MAX_TMP / 32], live = 0;
#pragma unroll
    for (int j = 0; j < MAX_TMP / 32; ++j) {
      const int m = lane + 32 * j;
      const int r = m / g.tw, c = m - r * g.tw, R = t.R0 + r, xo = t.x0 + c;
      woff[j] = (r * g.stride * g.pw + c * g.stride) * WSTR + quad * 4;
      taps[j] = 0;
      if (m < g.TM && R < g.rows && xo < g.Wo) {
        live |= 1u << j;
        const int iy = (R % g.Ho) * g.stride - g.pad, ix = xo * g.stride - g.pad;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            if ((unsigned)(iy + dy) < (unsigned)g.H && (unsigned)(ix + dx) < (unsigned)g.W)
              taps[j] |= 1u << (dy * 3 + dx);
      }
    }
    for (int c0 = t.c0; c0 < t.c1;) {
      const int w = imin(g.ns, t.c1 - c0), tn_t = w / (4 * MG);
      const int mt = tid / tn_t, nt = tid - mt * tn_t;
      const bool prod = mt < g.tm_t;
      float acc[4 * MG][4 * MG];
#pragma unroll
      for (int i = 0; i < 4 * MG; ++i)
#pragma unroll
        for (int j = 0; j < 4 * MG; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < g.Cin; k0 += g.kp) {
        const int k1 = imin(g.Cin, k0 + g.kp);
        if (g.nr > 1 || c0 == t.c0) {
          hop::named_bar_sync(1, CONSUMERS);  // the panel's last readers are done
          for (int kc = k0; kc < k1; kc += WC) {
            uint32_t par;
            const uint32_t s = wr.next(g.ws, par);
            hop::mbar_wait(bars.wfull + s, par);
            const int ch = kc + 4 * quad;
            if (ch < k1)
              depthwise(g, reinterpret_cast<const float*>(base + g.off_w + s * g.win_bytes),
                        quad, woff, taps, live, A + (ch - k0) * g.TMP);
            hop::mbar_arrive(bars.wempty + s);
          }
          hop::named_bar_sync(1, CONSUMERS);  // the panel is complete
        }
        for (int kk = k0; kk < k1; kk += KB) {
          uint32_t par;
          const uint32_t s = br.next(g.bs, par);
          hop::mbar_wait(bars.bfull + s, par);
          if (prod)
            product<MG>(A + (kk - k0) * g.TMP,
                        reinterpret_cast<const float*>(base + g.off_b + s * g.stage_bytes),
                        imin(KB, k1 - kk), g.TMP, w, mt, nt, acc);
          hop::mbar_arrive(bars.bempty + s);
        }
      }
      if (prod) store<MG>(g, t, p, c0, w, mt, nt, acc);
      c0 += w;
    }
  }
}

// Every unit of a block: the consumer warps, or a producer warp.
template <int MG>
__device__ __forceinline__ void run(const Geo& g, const Ptrs& p, unsigned char* base, Ring& wr,
                                    Ring& br) {
  if (threadIdx.x >= CONSUMERS + 32)
    produce_weights(g, p, base, br);
  else if (threadIdx.x >= CONSUMERS)
    produce_windows(g, p, base, wr);
  else
    consume<MG>(g, p, base, wr, br);
}

// The launch state of an entry point's two kernels (kernel[0] the 4 x 4 form,
// kernel[1] the 8 x 8): on a form's first launch its kernel is granted
// SMEM_LIMIT of dynamic shared memory, and the card's co-resident blocks of it
// at that size are read, once. geo_ok holds every plan to SMEM_LIMIT, so that
// count is a lower bound for each (a cooperative launch of it always fits).
struct Launcher {
  const void* kernel[2];
  int blocks[2];  // co-resident blocks on the card, 0 until read
};

// g's kernel and its persistent grid: the plan's units capped by the
// co-resident blocks.
inline cudaError_t prepare(Launcher& l, const Geo& g, const void** kernel, unsigned* grid) {
  const int f = g.mg == 2 ? 1 : 0;
  *kernel = l.kernel[f];
  if (l.blocks[f] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, THREADS, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    l.blocks[f] = per_sm * sms;
  }
  *grid = (unsigned)imin(g.units, l.blocks[f]);
  return cudaSuccess;
}

}  // namespace sf
}  // namespace mnk
