// The float32 MobileNet-V3 bottleneck on Hopper's CUDA cores: one pass of
// the persistent kernel, shared by the per-block kernel (v3_block.cu) and the
// chain kernel (v3_chain.cu), so that a chain stage computes bit for bit what
// one per-block launch does on the same plan. The numerics are v3_block.cu's
// (its header): IEEE float32, every product an fmaf on the CUDA cores (no
// tensor core, no TF32), each sum in a fixed sequential order (the
// expansion over Cin, the taps dy then dx, the projection over E).
//
// What held the old tile (v3_tile.cuh, one tile a block): two shared loads
// for every two fmaf in the expansion and one for every fmaf in the
// projection, five barriers a 32-channel chunk and every load synchronous, so
// the SM waited on shared memory and on device memory in turn. The design:
//   - Units: an output tile of th x tw pixels of one image, every output
//     channel. The grid is persistent: a block walks units u, u + gridDim.x.
//   - A producer warp (its 32 lanes) stages by 16-byte cp.async, each lane
//     arriving on the slot's full mbarrier when its copies land: a ring of ws
//     input windows (only the window's pixels inside the image, packed row
//     after row: the expansion of the pixels outside is zero and is never
//     computed; the identity expansion stages the whole window, zeros outside
//     the image) and a ring of bs stages, one a 32-channel chunk of E: the
//     chunk's expand weight (Cin x 32), projection weight (32 rows of Cout,
//     not in pass 1 of an SE block), depthwise weight (k*k x 32) and the two
//     biases; channels past E load as zeros. The next chunk's weights and the
//     next unit's window arrive while the current chunk computes.
//   - Expansion (8 consumer warps): items of 4 staged pixels x 4 channels, a
//     thread's 16 accumulators fed by 4-channel float4 loads of the 4 pixel
//     rows and 4 weight rows (8 shared loads for 64 fmaf; the 8 threads of a
//     quarter warp read one pixel row, a broadcast, and 8 consecutive weight
//     vectors), + bias, act, into Z, the chunk's f32 expanded tile over the
//     whole window (rows outside the image zeroed once a unit).
//   - Depthwise: warp w takes channels 4w..4w+3 of the chunk, a lane up to 8
//     output pixels (m = lane + 32 j); a tap row's k weight vectors are held
//     in registers (the same for the whole warp: broadcast loads) while the
//     lane adds its pixels' k taps, f32 in dy-then-dx order, + bias, act,
//     into the A panel (pixel rows of 32 channels); SE pass 1 also sums them
//     (the lane's pixels in order, then a fixed xor tree over the lanes) into
//     `partial`.
//   - Projection: a thread owns a quad of 4 output pixels and up to MAX_NJ
//     quads of 4 output channels, their accumulators live across the chunks
//     (4 panel and 4 weight-row float4 loads for 64 fmaf a quad); the
//     epilogue adds the bias in f32, then the residual from the staged
//     window, and stores 16 bytes a pixel and quad.
//   Two barriers of the consumer warps a chunk: Z complete, the A panel
//   complete.
// Squeeze-excite keeps two passes and the pre-gate tensor: pass 1 runs the
// expansion and depthwise, writes each tile's channel sums and stores the
// depthwise's output (f32, exact: the reference gates this unrounded value)
// to `y` (N x Ho x Wo x E) from the A panel, 128 bytes a pixel; pass 2 is
// the projection alone: each unit first computes its image's gate from the
// sums into shared memory (the sums over the tiles in tile order x
// 1/(Ho*Wo), the two products in f32, the hard sigmoid), then its stages
// bring the tile's rows of y for the chunk (in place of the expand and
// depthwise weights) with the projection weight, and the projection
// multiplies each row by the gate as it loads it; the residual comes from
// the input in device memory. Recomputing the expansion and depthwise in
// pass 2 instead was timed and lost (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace v3f {

constexpr int KE = 32;                    // expanded channels a chunk: a quad a consumer warp
constexpr int CONSUMERS = 256;            // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int LZ = KE + 4;                // floats a pixel row of Z and of the A panel
constexpr int MAX_TM = 256;               // output pixels a unit: 8 a lane in the depthwise
constexpr int MAX_NJ = 4;                 // projection channel quads a thread
constexpr int MAX_WS = 2, MAX_BS = 4;     // ring slots
constexpr int HEAD = 128;                 // the rings' barriers
constexpr int SMEM_LIMIT = 232448 - 256;  // 227 KB less the chain's stage shape

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int rup(int a, int m) { return cdiv(a, m) * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The plan (ops/v3_block.v3_plan).
struct Plan {
  int th, tw;  // output tile rows and columns, th * tw <= MAX_TM
  int ws, bs;  // window and weight ring slots
};

struct Geo {
  int N, H, W, Cin, E, Cout, Se, K, stride, pad, Ho, Wo;
  int act_exp, act, residual, identity;
  int th, tw, ws, bs;
  int tiles_w, tiles_img, ph, pw, TM, nec;
  int pq, cq, nj, cqt;  // projection: pixel quads, channel quads, quads a thread, thread columns
  int kc;               // expansion: thread groups that split Cin (a small window's items)
  int win_bytes, pw_off, dw_off, eb_off, db_off, stage_bytes;  // (SE pass 2: y's rows at dw_off)
  int off_w, off_b, off_z, off_a, off_x, off_g, off_h, smem_bytes;
  float inv_hw;  // 1 / (Ho * Wo), rounded once from double
};

// The shared-memory plan; mirrored by ops/v3_block.v3_smem_bytes. From the
// base: the barriers (HEAD), ws windows (the staged pixels: at most
// min(ph, H) x min(pw, W), the whole window for the identity, x Cin), bs
// stages (expand weight, projection weight, depthwise weight, expand bias,
// depthwise bias of a chunk; SE pass 2: the projection weight, then the
// tile's y rows, th * tw rounded up to 4 x LZ, from the depthwise weight's
// place), Z (the window's pixels x LZ; none for the
// identity), the A panel (th * tw rounded up to 4 pixels x LZ), the
// expansion's K-split partials ((kc - 1) x its items x 16 f32, kc > 1), and
// with SE the gate (E) and the hidden row (Se).
__host__ __device__ inline Geo make_geo(int N, int H, int W, int Cin, int E, int Cout, int Se,
                                        int K, int stride, int act_exp, int act, int residual,
                                        int identity, const Plan& p) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Cin = Cin; g.E = E; g.Cout = Cout; g.Se = Se; g.K = K;
  g.stride = stride; g.act_exp = act_exp; g.act = act; g.residual = residual;
  g.identity = identity;
  g.pad = stride == 1 ? (K - 1) / 2 : (K - 2) / 2;  // TF-SAME: low side (even input at s2)
  g.Ho = cdiv(H, stride);
  g.Wo = cdiv(W, stride);
  g.th = p.th; g.tw = p.tw; g.ws = p.ws; g.bs = p.bs;
  g.tiles_w = cdiv(g.Wo, p.tw);
  g.tiles_img = cdiv(g.Ho, p.th) * g.tiles_w;
  g.ph = (p.th - 1) * stride + K;
  g.pw = (p.tw - 1) * stride + K;
  g.TM = p.th * p.tw;
  g.nec = cdiv(E, KE);
  g.pq = cdiv(g.TM, 4);
  g.cq = Cout / 4;
  g.nj = imax(1, cdiv(g.pq * g.cq, CONSUMERS));
  while (g.nj < g.cq && g.pq * cdiv(g.cq, g.nj) > CONSUMERS) ++g.nj;
  g.cqt = cdiv(g.cq, g.nj);
  const int wpix = identity ? g.ph * g.pw : imin(g.ph, H) * imin(g.pw, W);
  const int items = cdiv(wpix, 4) * (KE / 4);  // the expansion's items at most
  g.kc = identity || items > CONSUMERS / 2 ? 1 : items > CONSUMERS / 4 || Cin < 16 ? 2 : 4;
  g.win_bytes = rup(wpix * Cin * 4, 128);
  g.pw_off = identity ? 0 : Cin * KE * 4;
  g.dw_off = g.pw_off + KE * Cout * 4;
  g.eb_off = g.dw_off + K * K * KE * 4;
  g.db_off = g.eb_off + KE * 4;
  g.stage_bytes = rup(imax(g.db_off + KE * 4, Se > 0 ? g.dw_off + 4 * g.pq * LZ * 4 : 0), 128);
  g.off_w = HEAD;
  g.off_b = g.off_w + p.ws * g.win_bytes;
  g.off_z = g.off_b + p.bs * g.stage_bytes;
  g.off_a = g.off_z + (identity ? 0 : rup(g.ph * g.pw * LZ * 4, 128));
  g.off_x = g.off_a + rup(4 * g.pq * LZ * 4, 128);
  g.off_g = g.off_x + (g.kc > 1 ? rup((g.kc - 1) * items * 16 * 4, 128) : 0);
  g.off_h = g.off_g + (Se > 0 ? rup(E * 4, 128) : 0);
  g.smem_bytes = g.off_h + (Se > 0 ? rup(Se * 4, 128) : 0);
  g.inv_hw = (float)(1.0 / ((double)g.Ho * (double)g.Wo));
  return g;
}

// Checks a shape and plan; false if they break a rule of the kernel (the
// Python plan never gives such a plan).
__host__ __device__ inline bool geo_ok(const Geo& g) {
  const bool acts = g.act_exp >= kLinear && g.act_exp <= kHswish && g.act >= kLinear &&
                    g.act <= kHswish;
  return g.N > 0 && g.H > 0 && g.W > 0 && g.Cin > 0 && g.E > 0 && g.Cout > 0 &&
         g.Cin % 8 == 0 && g.E % 8 == 0 && g.Cout % 8 == 0 && g.Se >= 0 &&
         (g.K == 3 || g.K == 5) && acts && (!g.identity || g.E == g.Cin) &&
         (g.stride == 1 || (g.stride == 2 && g.H % 2 == 0 && g.W % 2 == 0)) &&
         (!g.residual || (g.stride == 1 && g.Cin == g.Cout)) && g.th >= 1 && g.tw >= 1 &&
         g.TM <= MAX_TM && g.nj <= MAX_NJ && g.pq * g.cqt <= CONSUMERS && g.ws >= 1 &&
         g.ws <= MAX_WS && g.bs >= 1 && g.bs <= MAX_BS && g.smem_bytes <= SMEM_LIMIT;
}

// The tensors of a pass.
struct Ptrs {
  const float *x, *ew, *eb, *dw, *db, *pw, *pb, *w1, *b1, *w2, *b2;
  float* partial;  // pass 1's per-tile channel sums (N x tiles x E)
  float* y;        // pass 1's pre-gate depthwise output (N x Ho x Wo x E)
  float* out;
};

// A unit: image, tile of the image, output origin, window origin, and the
// staged region of the window (rows ry0.., columns rx0.., rh x rw).
struct Unit {
  int n, ti, oy0, ox0, iy0, ix0, ry0, rx0, rh, rw;
};

__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  Unit x;
  x.n = u / g.tiles_img;
  x.ti = u - x.n * g.tiles_img;
  const int tr = x.ti / g.tiles_w;
  x.oy0 = tr * g.th;
  x.ox0 = (x.ti - tr * g.tiles_w) * g.tw;
  x.iy0 = x.oy0 * g.stride - g.pad;
  x.ix0 = x.ox0 * g.stride - g.pad;
  if (g.identity) {
    x.ry0 = 0; x.rx0 = 0; x.rh = g.ph; x.rw = g.pw;
  } else {
    x.ry0 = imax(0, -x.iy0);
    x.rx0 = imax(0, -x.ix0);
    x.rh = imin(g.ph, g.H - x.iy0) - x.ry0;
    x.rw = imin(g.pw, g.W - x.ix0) - x.rx0;
  }
  return x;
}

struct Bars {
  uint64_t *wfull, *wempty, *bfull, *bempty;
};

__device__ __forceinline__ Bars bars_of(unsigned char* base) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base);
  return Bars{b, b + MAX_WS, b + 2 * MAX_WS, b + 2 * MAX_WS + MAX_BS};
}

// The rings' barriers, initialised once a launch: full barriers take the
// producer's 32 lanes' cp.async arrivals, empty ones the consumer threads'.
__device__ __forceinline__ void setup(unsigned char* base) {
  if (threadIdx.x == 0) {
    const Bars b = bars_of(base);
    for (int s = 0; s < MAX_WS; ++s) {
      hop::mbar_init(b.wfull + s, 32);
      hop::mbar_init(b.wempty + s, CONSUMERS);
    }
    for (int s = 0; s < MAX_BS; ++s) {
      hop::mbar_init(b.bfull + s, 32);
      hop::mbar_init(b.bempty + s, CONSUMERS);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
}

// A ring cursor of one role: the next slot, and a parity bit a slot that
// flips at each use (the cursor restarts at slot 0 in each pass on both
// sides, so the slot count may change between the chain's stages).
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

// ---- the producer warp -----------------------------------------------------------------

__device__ inline void produce(const Geo& g, const Ptrs& p, unsigned char* base, bool pool,
                               Ring& wr, Ring& br) {
  const int lane = threadIdx.x & 31;
  const Bars bars = bars_of(base);
  const int units = g.N * g.tiles_img, cv = g.Cin / 4;
  wr.cur = 0;
  br.cur = 0;
  if (!pool && g.Se > 0) {  // SE pass 2: the projection weight and the tile's y rows
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit x = unit_of(g, u);
      for (int c = 0; c < g.nec; ++c) {
        const int e0 = c * KE, live = imin(KE, g.E - e0);
        uint32_t par;
        const uint32_t b = br.next(g.bs, par);
        hop::mbar_wait(bars.bempty + b, par ^ 1);
        unsigned char* st = base + g.off_b + b * g.stage_bytes;
        float* d = reinterpret_cast<float*>(st + g.pw_off);
        const float* src = p.pw + (long long)e0 * g.Cout;
        for (int i = lane; i < live * g.cq; i += 32) hop::cp_async16_zfill(d + 4 * i, src + 4 * i, 16u);
        d = reinterpret_cast<float*>(st + g.dw_off);
        for (int i = lane; i < 4 * g.pq * 8; i += 32) {
          const int m = i >> 3, q = (i & 7) * 4;
          const int ih = m / g.tw, iw = m - ih * g.tw;
          const bool ok = m < g.TM && q < live && x.oy0 + ih < g.Ho && x.ox0 + iw < g.Wo;
          const long long pix = ((long long)x.n * g.Ho + x.oy0 + ih) * g.Wo + x.ox0 + iw;
          hop::cp_async16_zfill(d + m * LZ + q, ok ? p.y + pix * g.E + e0 + q : p.pw, ok ? 16u : 0u);
        }
        hop::cp_async_mbar_arrive(bars.bfull + b);
      }
    }
    hop::cp_async_wait<0>();
    return;
  }
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    uint32_t par;
    const uint32_t s = wr.next(g.ws, par);
    hop::mbar_wait(bars.wempty + s, par ^ 1);
    float* win = reinterpret_cast<float*>(base + g.off_w + s * g.win_bytes);
    const long long img = (long long)x.n * g.H;
    for (int i = lane; i < x.rh * x.rw * cv; i += 32) {
      const int px = i / cv, c = (i - px * cv) * 4;
      const int ry = px / x.rw;
      const int iy = x.iy0 + x.ry0 + ry, ix = x.ix0 + x.rx0 + px - ry * x.rw;
      const bool in = (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      hop::cp_async16_zfill(win + px * g.Cin + c,
                            in ? p.x + ((img + iy) * g.W + ix) * g.Cin + c : p.x, in ? 16u : 0u);
    }
    hop::cp_async_mbar_arrive(bars.wfull + s);
    for (int c = 0; c < g.nec; ++c) {
      const int e0 = c * KE;
      const uint32_t b = br.next(g.bs, par);
      hop::mbar_wait(bars.bempty + b, par ^ 1);
      unsigned char* st = base + g.off_b + b * g.stage_bytes;
      // `rows` rows of 32 channels from e0 of a row-major (rows, E) tensor
      const auto chunk_rows = [&](int off, const float* src, int rows) {
        float* d = reinterpret_cast<float*>(st + off);
        for (int i = lane; i < rows * 8; i += 32) {
          const int r = i >> 3, q = (i & 7) * 4;
          const bool ok = e0 + q < g.E;
          hop::cp_async16_zfill(d + r * KE + q, ok ? src + (long long)r * g.E + e0 + q : src,
                                ok ? 16u : 0u);
        }
      };
      if (!g.identity) {
        chunk_rows(0, p.ew, g.Cin);
        chunk_rows(g.eb_off, p.eb, 1);
      }
      if (!pool) {  // the projection weight's rows e0.. of the chunk: contiguous
        float* d = reinterpret_cast<float*>(st + g.pw_off);
        const float* src = p.pw + (long long)e0 * g.Cout;
        for (int i = lane; i < imin(KE, g.E - e0) * g.cq; i += 32)
          hop::cp_async16_zfill(d + 4 * i, src + 4 * i, 16u);
      }
      chunk_rows(g.dw_off, p.dw, g.K * g.K);
      chunk_rows(g.db_off, p.db, 1);
      hop::cp_async_mbar_arrive(bars.bfull + b);
    }
  }
  hop::cp_async_wait<0>();
}

// ---- the consumer warps ----------------------------------------------------------------

// One expansion item (it: 4 staged pixels x 4 channels): its 4 pixel rows
// in the window and their rows in Z (a row past the staged pixels is
// computed from the last one and dropped).
__device__ __forceinline__ void item_rows(const Geo& g, const Unit& x, const float* win, int it,
                                          int pv, const float* (&xr)[4], int (&zo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = imin((it >> 3) * 4 + i, pv - 1);
    const int ry = m / x.rw;
    xr[i] = win + m * g.Cin;
    zo[i] = ((x.ry0 + ry) * g.pw + x.rx0 + m - ry * x.rw) * LZ + (it & 7) * 4;
  }
}

// a[i][..] = the item's sums over input channels [c_lo, c_hi), in order.
__device__ __forceinline__ void item_dot(const float* (&xr)[4], const float* w, int c_lo,
                                         int c_hi, float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
#pragma unroll 2
  for (int c = c_lo; c < c_hi; c += 4) {
    float4 xv[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ld4(xr[i] + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) wv[k] = ld4(w + (c + k) * KE);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xs[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[i][0] = fmaf(xs[k], wv[k].x, a[i][0]);
        a[i][1] = fmaf(xs[k], wv[k].y, a[i][1]);
        a[i][2] = fmaf(xs[k], wv[k].z, a[i][2]);
        a[i][3] = fmaf(xs[k], wv[k].w, a[i][3]);
      }
    }
  }
}

// + bias, act, into Z's rows of the item's staged pixels.
__device__ __forceinline__ void item_store(const Geo& g, float* Z, const float* eb, int it,
                                           int pv, const int (&zo)[4], const float (&a)[4][4]) {
  const float4 b = ld4(eb + (it & 7) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if ((it >> 3) * 4 + i < pv)
      st4(Z + zo[i], make_float4(act_named(a[i][0] + b.x, g.act_exp),
                                 act_named(a[i][1] + b.y, g.act_exp),
                                 act_named(a[i][2] + b.z, g.act_exp),
                                 act_named(a[i][3] + b.w, g.act_exp)));
}

// The chunk's expansion of the staged pixels into Z (see the header). A
// small window (kc 2 or 4: at most a half or a quarter of the threads have
// an item) splits Cin into kc ranges over kc thread groups, a thread an
// item; the groups past the first leave their sums in Xp, and the first
// adds them in group order before its epilogue.
__device__ __forceinline__ void expand(const Geo& g, const Unit& x, const float* win,
                                       const float* ew, const float* eb, float* Z, float* Xp) {
  const int pv = x.rh * x.rw, items = cdiv(pv, 4) * 8;
  const float* xr[4];
  int zo[4];
  float a[4][4];
  if (g.kc == 1) {
    for (int it = threadIdx.x; it < items; it += CONSUMERS) {
      item_rows(g, x, win, it, pv, xr, zo);
      item_dot(xr, ew + (it & 7) * 4, 0, g.Cin, a);
      item_store(g, Z, eb, it, pv, zo, a);
    }
    return;
  }
  const int gsz = CONSUMERS / g.kc, grp = threadIdx.x / gsz, it = threadIdx.x - grp * gsz;
  const int steps = g.Cin / 4;
  float* xp = Xp + ((grp - 1) * items + it) * 16;
  if (it < items) {
    item_rows(g, x, win, it, pv, xr, zo);
    item_dot(xr, ew + (it & 7) * 4, 4 * (grp * steps / g.kc), 4 * ((grp + 1) * steps / g.kc), a);
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(xp + 4 * i, make_float4(a[i][0], a[i][1], a[i][2], a[i][3]));
    }
  }
  hop::named_bar_sync(2, CONSUMERS);  // every group's sums are in Xp
  if (grp > 0 || it >= items) return;
  for (int s = 1; s < g.kc; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = ld4(Xp + ((s - 1) * items + it) * 16 + 4 * i);
      a[i][0] += v.x; a[i][1] += v.y; a[i][2] += v.z; a[i][3] += v.w;
    }
  }
  item_store(g, Z, eb, it, pv, zo, a);
}

// Zeros in Z's rows of the window's pixels outside the image (the taps read
// them: TF-SAME pads the expanded activation), once a unit that has some.
__device__ __forceinline__ void zero_outside(const Geo& g, const Unit& x, float* Z) {
  for (int i = threadIdx.x; i < g.ph * g.pw * (KE / 4); i += CONSUMERS) {
    const int px = i >> 3, py = px / g.pw, pxx = px - py * g.pw;
    if (py < x.ry0 || py >= x.ry0 + x.rh || pxx < x.rx0 || pxx >= x.rx0 + x.rw)
      st4(Z + px * LZ + (i & 7) * 4, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
}

__device__ __forceinline__ float4 fma4(float4 z, float4 w, float4 a) {
  return make_float4(fmaf(z.x, w.x, a.x), fmaf(z.y, w.y, a.y), fmaf(z.z, w.z, a.z),
                     fmaf(z.w, w.w, a.w));
}

// The chunk's depthwise from src (Z, or for the identity the window at the
// chunk's first channel; lds floats a window pixel) into the A panel, see
// the header; pool (SE pass 1): its sums into `partial` too.
template <int K>
__device__ __forceinline__ void depthwise(const Geo& g, const Unit& x, const float* src, int lds,
                                          const unsigned char* st, float* A, float* partial,
                                          bool pool, int live) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cq = warp * 4;
  if (cq >= live) return;
  const float* dws = reinterpret_cast<const float*>(st + g.dw_off) + cq;
  const float4 bias = ld4(reinterpret_cast<const float*>(st + g.db_off) + cq);
  int zo[8];
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = lane + 32 * j;
    const int ih = m / g.tw, iw = m - ih * g.tw;
    zo[j] = ((ih * g.pw + iw) * g.stride) * lds + cq;
    if (m < g.TM && x.oy0 + ih < g.Ho && x.ox0 + iw < g.Wo) ok |= 1u << j;
  }
  float4 a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ok != 0) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      float4 w[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) w[dx] = ld4(dws + (dy * K + dx) * KE);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((ok >> j) & 1u)) continue;
        const float* r = src + zo[j] + dy * g.pw * lds;
        float4 z[K];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) z[dx] = ld4(r + dx * lds);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) a[j] = fma4(z[dx], w[dx], a[j]);
      }
    }
  }
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!((ok >> j) & 1u)) continue;
    const float4 v = make_float4(act_named(a[j].x + bias.x, g.act), act_named(a[j].y + bias.y, g.act),
                                 act_named(a[j].z + bias.z, g.act), act_named(a[j].w + bias.w, g.act));
    if (pool) {
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    st4(A + (lane + 32 * j) * LZ + cq, v);
  }
  if (pool) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum.x += __shfl_xor_sync(0xffffffffu, sum.x, o);
      sum.y += __shfl_xor_sync(0xffffffffu, sum.y, o);
      sum.z += __shfl_xor_sync(0xffffffffu, sum.z, o);
      sum.w += __shfl_xor_sync(0xffffffffu, sum.w, o);
    }
    if (lane == 0) __stcg(reinterpret_cast<float4*>(partial + cq), sum);
  }
}

// The chunk's share of the projection: acc[j][i] (pixel 4 ppq + i, channels
// of quad pct + j * cqt) += A (live channels; kGated: each x the chunk's
// gate, f32, as loaded) x the stage's weight rows.
template <bool kGated>
__device__ __forceinline__ void project(const Geo& g, const float* A, const float* B,
                                        const float* gate, int live, int ppq, int pct,
                                        float (&acc)[MAX_NJ][4][4]) {
  const float* a0 = A + 4 * ppq * LZ;
  for (int k = 0; k < live; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a0 + i * LZ + k);
    if constexpr (kGated) {
      const float4 gv = ld4(gate + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = make_float4(av[i].x * gv.x, av[i].y * gv.y, av[i].z * gv.z, av[i].w * gv.w);
    }
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      const int q = pct + j * g.cqt;
      if (j >= g.nj || q >= g.cq) continue;
      float4 bv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(B + (k + kk) * g.Cout + 4 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float as[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[j][i][0] = fmaf(as[kk], bv[kk].x, acc[j][i][0]);
          acc[j][i][1] = fmaf(as[kk], bv[kk].y, acc[j][i][1]);
          acc[j][i][2] = fmaf(as[kk], bv[kk].z, acc[j][i][2]);
          acc[j][i][3] = fmaf(as[kk], bv[kk].w, acc[j][i][3]);
        }
      }
    }
  }
}

// + bias in f32, then + the residual (the staged window's pixel; win null:
// the input's, from device memory), stored.
__device__ __forceinline__ void store(const Geo& g, const Unit& x,
                                      const float (&acc)[MAX_NJ][4][4], const float* win,
                                      const Ptrs& p, int ppq, int pct) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * ppq + i;
    const int ih = m / g.tw, iw = m - ih * g.tw;
    if (m >= g.TM || x.oy0 + ih >= g.Ho || x.ox0 + iw >= g.Wo) continue;
    const long long pix = ((long long)x.n * g.Ho + x.oy0 + ih) * g.Wo + x.ox0 + iw;
    const float* res =
        win == nullptr ? nullptr : win + ((ih + g.pad - x.ry0) * x.rw + iw + g.pad - x.rx0) * g.Cin;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      const int q = pct + j * g.cqt;
      if (j >= g.nj || q >= g.cq) continue;
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.pb) + q);
      float4 o = make_float4(acc[j][i][0] + b.x, acc[j][i][1] + b.y, acc[j][i][2] + b.z,
                             acc[j][i][3] + b.w);
      if (g.residual) {
        const float4 r = win != nullptr
                             ? ld4(res + 4 * q)
                             : __ldcg(reinterpret_cast<const float4*>(p.x + pix * g.Cin) + q);
        o = make_float4(o.x + r.x, o.y + r.y, o.z + r.z, o.w + r.w);
      }
      *reinterpret_cast<float4*>(p.out + pix * g.Cout + 4 * q) = o;
    }
  }
}

// Image n's squeeze-excite gate from pass 1's sums into G (E), through the
// hidden row Hd (Se), by the consumer threads.
__device__ __forceinline__ void se_gate(const Geo& g, const Ptrs& p, int n, float* G, float* Hd) {
  const int t = threadIdx.x;
  const float* part = p.partial + (long long)n * g.tiles_img * g.E;
  for (int e = t; e < g.E; e += CONSUMERS) {
    float a = 0.0f;
    for (int tt = 0; tt < g.tiles_img; ++tt) a += __ldcg(part + (long long)tt * g.E + e);
    G[e] = a * g.inv_hw;
  }
  hop::named_bar_sync(1, CONSUMERS);
  for (int j = t; j < g.Se; j += CONSUMERS) {
    float a = 0.0f;
    for (int e = 0; e < g.E; ++e) a = fmaf(G[e], __ldg(p.w1 + (long long)e * g.Se + j), a);
    Hd[j] = fmaxf(a + __ldg(p.b1 + j), 0.0f);
  }
  hop::named_bar_sync(1, CONSUMERS);
  for (int e = t; e < g.E; e += CONSUMERS) {
    float a = 0.0f;
    for (int j = 0; j < g.Se; ++j) a = fmaf(Hd[j], __ldg(p.w2 + (long long)j * g.E + e), a);
    a = a + __ldg(p.b2 + e);
    G[e] = fminf(fmaxf(a + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
  }
}

// SE pass 1: the A panel's rows of the tile's output pixels (the chunk's
// live channels) to y, 16 bytes a thread, 8 threads a pixel row.
__device__ __forceinline__ void store_y(const Geo& g, const Unit& x, const float* A, float* y,
                                        int e0, int live) {
  for (int i = threadIdx.x; i < g.TM * 8; i += CONSUMERS) {
    const int m = i >> 3, q = (i & 7) * 4;
    const int ih = m / g.tw, iw = m - ih * g.tw;
    if (q >= live || x.oy0 + ih >= g.Ho || x.ox0 + iw >= g.Wo) continue;
    const long long pix = ((long long)x.n * g.Ho + x.oy0 + ih) * g.Wo + x.ox0 + iw;
    *reinterpret_cast<float4*>(y + pix * g.E + e0 + q) = ld4(A + m * LZ + q);
  }
}

// SE pass 2 by the consumer warps: a unit's gate, then its projection from
// the stages' y rows.
__device__ inline void consume_gated(const Geo& g, const Ptrs& p, unsigned char* base, Ring& br) {
  const int t = threadIdx.x;
  const Bars bars = bars_of(base);
  float* G = reinterpret_cast<float*>(base + g.off_g);
  float* Hd = reinterpret_cast<float*>(base + g.off_h);
  const int ppq = t / g.cqt, pct = t - ppq * g.cqt;
  const bool prj = ppq < g.pq;
  const int units = g.N * g.tiles_img;
  int gate_n = -1;
  br.cur = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    if (x.n != gate_n) {
      hop::named_bar_sync(1, CONSUMERS);  // the previous image's gate is read
      se_gate(g, p, x.n, G, Hd);
      hop::named_bar_sync(1, CONSUMERS);  // the gate is complete
      gate_n = x.n;
    }
    float acc[MAX_NJ][4][4];
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.0f;
    for (int c = 0; c < g.nec; ++c) {
      const int e0 = c * KE;
      uint32_t par;
      const uint32_t bs = br.next(g.bs, par);
      hop::mbar_wait(bars.bfull + bs, par);
      const unsigned char* st = base + g.off_b + bs * g.stage_bytes;
      if (prj)
        project<true>(g, reinterpret_cast<const float*>(st + g.dw_off),
                      reinterpret_cast<const float*>(st + g.pw_off), G + e0, imin(KE, g.E - e0),
                      ppq, pct, acc);
      hop::mbar_arrive(bars.bempty + bs);
    }
    if (prj) store(g, x, acc, nullptr, p, ppq, pct);
  }
}

// Every other pass by the consumer warps: a block without SE, or SE pass 1.
template <int K>
__device__ inline void consume(const Geo& g, const Ptrs& p, unsigned char* base, bool pool,
                               Ring& wr, Ring& br) {
  const int t = threadIdx.x;
  const Bars bars = bars_of(base);
  float* Z = reinterpret_cast<float*>(base + g.off_z);
  float* A = reinterpret_cast<float*>(base + g.off_a);
  const int ppq = t / g.cqt, pct = t - ppq * g.cqt;
  const bool prj = !pool && ppq < g.pq;
  const int units = g.N * g.tiles_img;
  wr.cur = 0;
  br.cur = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u);
    uint32_t par;
    const uint32_t ws = wr.next(g.ws, par);
    hop::mbar_wait(bars.wfull + ws, par);
    const float* win = reinterpret_cast<const float*>(base + g.off_w + ws * g.win_bytes);
    if (!g.identity && x.rh * x.rw < g.ph * g.pw) zero_outside(g, x, Z);
    float acc[MAX_NJ][4][4];
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.0f;
    float* part = p.partial + ((long long)x.n * g.tiles_img + x.ti) * g.E;
    for (int c = 0; c < g.nec; ++c) {
      const int e0 = c * KE, live = imin(KE, g.E - e0);
      const uint32_t bs = br.next(g.bs, par);
      hop::mbar_wait(bars.bfull + bs, par);
      const unsigned char* st = base + g.off_b + bs * g.stage_bytes;
      if (!g.identity)
        expand(g, x, win, reinterpret_cast<const float*>(st),
               reinterpret_cast<const float*>(st + g.eb_off), Z,
               reinterpret_cast<float*>(base + g.off_x));
      hop::named_bar_sync(1, CONSUMERS);  // Z is complete
      if (g.identity)
        depthwise<K>(g, x, win + e0, g.Cin, st, A, part + e0, pool, live);
      else
        depthwise<K>(g, x, Z, LZ, st, A, part + e0, pool, live);
      hop::named_bar_sync(1, CONSUMERS);  // the A panel is complete, Z is free
      if (pool)
        store_y(g, x, A, p.y, e0, live);
      else if (prj)
        project<false>(g, A, reinterpret_cast<const float*>(st + g.pw_off), nullptr, live, ppq,
                       pct, acc);
      hop::mbar_arrive(bars.bempty + bs);
    }
    if (prj) store(g, x, acc, win, p, ppq, pct);
    hop::mbar_arrive(bars.wempty + ws);
  }
}

// One pass of every unit of a block: the consumer warps, or the producer warp.
template <int K>
__device__ __forceinline__ void run_pass(const Geo& g, const Ptrs& p, unsigned char* base,
                                         bool pool, Ring& wr, Ring& br) {
  if (threadIdx.x >= CONSUMERS)
    produce(g, p, base, pool, wr, br);
  else if (!pool && g.Se > 0)
    consume_gated(g, p, base, br);
  else
    consume<K>(g, p, base, pool, wr, br);
}

}  // namespace v3f
}  // namespace mnk
