// The bf16 MobileNet-V3 bottleneck on Hopper: one pass of the persistent
// kernel, shared by the per-block kernel (v3_block.cu) and the chain kernel
// (v3_chain.cu), so that a chain stage computes bit for bit what one
// per-block launch does on the same plan. The numerics are v3_block.cu's
// (its header); float32 runs v3_f32.cuh.
//
// Work is split into units: an output tile of th x tw pixels of one image
// (tiles_h x tiles_w a image) times a part of the output channels (the
// plan's Cout split, for the shapes with few tiles at batch 1). A block
// owns one unit at a time (the grid is persistent, the unit index strided
// by gridDim.x) and:
//   1. stages the tile's input window ((th-1)s+k x (tw-1)s+k pixels = P) by
//      TMA, one box of 64 channels a chunk of Cin, 128-byte swizzled: the
//      K-major A operand of the expansion, MP = P rounded up to 64 rows a
//      chunk; pixels outside the image and channels past Cin load as zeros;
//      a ring of ws whole windows (each with the part's projection bias), so
//      the next unit's window loads while this one computes;
//   2. walks the expanded channels in chunks of 64; a chunk's expand weight
//      (Cin x 64, E contiguous, MN-major boxes of 64 x 64), projection
//      weight (64 rows of E x the part's columns), depthwise weight (k*k
//      rows of 64), expand and depthwise biases and (pass 2 of an SE block)
//      the image's gate arrive together in one stage of a ring of bs, so no
//      consumer load goes to device memory;
//   3. expansion: wgmma m64n64k16 over the window's MP / 64 row blocks (the
//      two consumer warpgroups take alternate blocks), K = Cin in 16-wide
//      steps (none past Cin); epilogue in registers: + bias in f32, act,
//      zero where the window pixel lies outside the image (TF-SAME pads the
//      expanded tensor, and act(0 * w + b) is not 0), rounded to bf16 into
//      the expanded tile Z (MP x 64 bf16, rows padded to 144 bytes). The
//      identity expansion (V3 block 0) reads the window itself as Z;
//   4. depthwise k x k from Z: a thread takes 8 channels of up to four
//      output pixels (the live groups of a ragged last chunk spread over all
//      threads) and, a tap row at a time, holds the row's k weights and
//      loads its k taps of a pixel at once (immediate offsets); f32 taps in
//      dy-then-dx order, + bias, act; pass 1 of an SE
//      block sums them (step 6), else x the image's gate in f32, rounded to
//      bf16 into the A panel (128 pixels x 64, K-major, 128-byte swizzle);
//   5. projection: each warpgroup multiplies its 64 rows of the panel by the
//      stage's weight into accumulators that live across the E chunks, in
//      slices of 128/64, 32, 16 and 8 columns (the binary digits of the
//      part's width: no column is padding), K steps up to the chunk's live
//      channels; the slices of chunk c run while chunk c+1 expands;
//   6. epilogue: + bias in f32, rounded, then + the residual in bf16 (at
//      stride 1 from the staged window, never re-read from device memory),
//      a 4 x 4 word transpose inside each quad of lanes, 16-byte stores.
// Squeeze-excite keeps two passes over the units (the reference gates the
// unrounded f32 activation, so the pre-gate tensor cannot be stored in
// bf16). Pass 1 runs steps 1-4 only: each tile's per-channel f32 sums, in a
// fixed order (a thread's pixels in order, then the threads in order), into
// `partial` (N x tiles x E). Then each image's gate is computed once
// (`se_gate`: the sums over the tiles in tile order, the two FCs in fixed
// input segments and the hard sigmoid; its own launch in v3_block.cu, a
// grid-strided step between grid barriers in the chain), and pass 2 runs
// the whole unit with it.
// Roles: two consumer warpgroups (steps 3-6), then one producer warpgroup
// whose warp 0 runs the window ring and warp 1 the weight ring, each by
// its lane 0; full and empty mbarriers order the rings, a named barrier
// orders Z and the A panel between the warpgroups. setmaxnreg gives the
// consumers 232 registers a thread and the producers 40.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace v3w {

using bf16 = __nv_bfloat16;

constexpr int KCH = 64;                 // channels a window chunk, an E chunk, a weight box's rows
constexpr int ROW = KCH * 2;            // bytes of one pixel of a chunk (a swizzled 128-byte row)
constexpr int ZROW = ROW + 16;          // a pixel of Z: padded, so the epilogue's stores miss no bank
constexpr int TM = 128;                 // output pixels a unit at most (64 a consumer warpgroup)
constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int THREADS = 384;            // + the producer warpgroup
constexpr int BOX64 = KCH * 64 * 2;     // a 64-column x 64-row weight box (128-byte swizzle)
constexpr int BOX8 = KCH * 8 * 2;       // an 8-column x 64-row weight box (no swizzle)
constexpr int HEAD = 1024;              // the rings' barriers, at the base in every pass
constexpr int A_BYTES = TM * ROW;       // the A panel (pass 1: its pool sums)
constexpr int MAX_WS = 4, MAX_BS = 4;   // ring slots
constexpr int WIN_TAIL = 1024;          // a window slot's tail: the part's projection bias
constexpr int MAX_CW = 184;             // a part's columns: 128 or 64, then 32 + 16 + 8
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may use (227 KB)

// The plan (ops/v3_block.v3_wgmma_plan).
struct Plan {
  int th, tw;   // output tile rows and columns, th * tw <= TM
  int split;    // output-channel parts a tile
  int cw;       // columns a part (Cout = split * cw)
  int ws, bs;   // window and weight ring slots (bs >= 2: a chunk's stage is awaited
                // while the previous one is held)
};

struct Geo {
  int N, H, W, Cin, E, Cout, Se, K, stride, pad, Ho, Wo;
  int act_exp, act, residual, identity;
  int th, tw, split, cw, ws, bs;
  int tiles_w, tiles_img, ph, pw, P, MP, nci, nec, nbig, nsmall;
  int exp_bytes, dw_off, eb_off, db_off, gt_off, stage_bytes, win_bytes, off_z, off_b, off_w;
  int smem_bytes;
  float inv_hw;  // 1 / (Ho * Wo), rounded once from double
  float inv_tw, inv_pw;  // 1 / tw, 1 / pw: exact quotients of the tile's pixels (quot)
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// a / d for 0 <= a < 4096 and 1 <= d <= 256, given inv = 1.0f / d: exact
// (the quotient's fraction stays 0.5 / d from an integer), and without the
// integer division's dependent chain.
__device__ __forceinline__ int quot(int a, float inv) {
  return __float2int_rz(((float)a + 0.5f) * inv);
}

// The shared-memory plan; mirrored by ops/v3_block.v3_wgmma_smem_bytes.
// From the 1 KB-aligned base: the barriers (HEAD), the A panel, Z (none for
// the identity), bs weight stages, ws windows; + 1 KB to align the base. A
// weight stage holds a chunk of E's expand boxes, projection boxes, depthwise
// weight (k*k rows of 64), expand and depthwise biases and (pass 2 of an SE
// block) the image's gate (64 f32); a window slot the window's chunks, then
// the part's projection bias.
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
  g.th = p.th; g.tw = p.tw; g.split = p.split; g.cw = p.cw; g.ws = p.ws; g.bs = p.bs;
  g.tiles_w = cdiv(g.Wo, p.tw);
  g.tiles_img = cdiv(g.Ho, p.th) * g.tiles_w;
  g.ph = (p.th - 1) * stride + K;
  g.pw = (p.tw - 1) * stride + K;
  g.P = g.ph * g.pw;
  g.MP = cdiv(g.P, 64) * 64;
  g.nci = cdiv(Cin, KCH);
  g.nec = cdiv(E, KCH);
  g.nbig = p.cw >= 128 ? 2 : p.cw >= 64 ? 1 : 0;
  g.nsmall = (p.cw - 64 * g.nbig) / 8;
  g.exp_bytes = identity ? 0 : g.nci * BOX64;
  g.dw_off = g.exp_bytes + g.nbig * BOX64 + g.nsmall * BOX8;
  g.eb_off = g.dw_off + K * K * ROW;
  g.db_off = g.eb_off + ROW;
  g.gt_off = g.db_off + ROW;
  g.stage_bytes = cdiv(g.gt_off + 2 * ROW, 1024) * 1024;
  g.win_bytes = g.nci * g.MP * ROW + WIN_TAIL;
  g.off_z = HEAD + A_BYTES;
  g.off_b = g.off_z + (identity ? 0 : g.MP * ZROW);
  g.off_w = g.off_b + p.bs * g.stage_bytes;
  g.smem_bytes = 1024 + g.off_w + p.ws * g.win_bytes;
  g.inv_hw = (float)(1.0 / ((double)g.Ho * (double)g.Wo));
  g.inv_tw = 1.0f / (float)p.tw;
  g.inv_pw = 1.0f / (float)g.pw;
  return g;
}

constexpr int FC1_SEGS = 8, FC2_SEGS = 4;  // the SE products' input segments

// Shared memory of the gate step, in floats: pooled (E), hidden (Se), and
// the products' segment sums (FC1_SEGS x Se, FC2_SEGS x E).
__host__ __device__ inline int gate_floats(int E, int Se) {
  return E + Se + FC1_SEGS * Se + FC2_SEGS * E;
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
         g.th * g.tw <= TM && g.ph <= 256 && g.pw <= 256 && g.cw >= 8 && g.cw % 8 == 0 &&
         g.cw <= MAX_CW && g.split * g.cw == g.Cout && g.ws >= 1 && g.ws <= MAX_WS &&
         g.bs >= 2 && g.bs <= MAX_BS && g.smem_bytes <= SMEM_LIMIT &&
         // the chain's gate step keeps its scratch in the tile's memory
         (g.Se == 0 || gate_floats(g.E, g.Se) * 4 <= g.smem_bytes - 1024 - HEAD);
}

// Units of a pass: pass 1 (pool) does not split the channels.
__host__ __device__ inline int units_of(const Geo& g, bool pool) {
  return g.N * g.tiles_img * (pool ? 1 : g.split);
}

struct Unit {
  int n, ti, oy0, ox0, c0;  // image, tile of the image, tile origin, first column
};

__device__ __forceinline__ Unit unit_of(const Geo& g, int u, bool pool) {
  const int split = pool ? 1 : g.split;
  const int t = u / split;
  Unit x;
  x.c0 = (u - t * split) * g.cw;
  x.n = t / g.tiles_img;
  x.ti = t - x.n * g.tiles_img;
  const int tr = x.ti / g.tiles_w;
  x.oy0 = tr * g.th;
  x.ox0 = (x.ti - tr * g.tiles_w) * g.tw;
  return x;
}

// The tensors of a pass that are not read through the TMA maps.
struct Ptrs {
  const bf16 *w1, *b1, *w2, *b2;  // the SE weights (the gate's own step)
  bf16* out;
  float* partial;  // pass 1's per-tile channel sums (N x tiles x E)
  float* gate;     // the images' gates (N x E)
};

// The maps a pass loads through: the input window (rank 4: C, W, H, N), the
// expand weight (64 x 64 boxes, 128-byte swizzle) and the projection weight
// in both box forms.
struct Maps {
  CUtensorMap x, ew, pw128, pw8;
  CUtensorMap dw, eb, db, pb, gate;  // the depthwise weight (k*k, E), the biases, the gates
};

struct Rings {
  uint64_t *wfull, *wempty, *bfull, *bempty;
  unsigned char *a, *z, *b, *win;
};

__device__ __forceinline__ Rings rings_of(const Geo& g, unsigned char* base) {
  Rings r;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
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

// The dynamic shared memory base rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 1024) and the rings' barriers initialised, once a
// launch: they sit at the base in every pass and stage.
__device__ __forceinline__ unsigned char* setup_smem(unsigned char* raw) {
  unsigned char* base = raw + ((1024 - (hop::saddr(raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base);
    for (int s = 0; s < MAX_WS; ++s) {
      hop::mbar_init(bars + s, 1);
      hop::mbar_init(bars + MAX_WS + s, CONSUMERS);
    }
    for (int s = 0; s < MAX_BS; ++s) {
      hop::mbar_init(bars + 2 * MAX_WS + s, 1);
      hop::mbar_init(bars + 2 * MAX_WS + MAX_BS + s, CONSUMERS);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
  return base;
}

// A ring cursor of one role: the next slot, and a parity bit a slot that
// flips at each use of the slot (so the slot count may change between the
// chain's stages: the cursor restarts at slot 0 in each pass, on both sides).
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

// ---- producers (lane 0 of their warp) -------------------------------------------

__device__ inline void produce_window(const Geo& g, const Rings& r, const Maps* m, bool pool,
                                      Ring& ring) {
  ring.cur = 0;
  const int units = units_of(g, pool);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u, pool);
    uint32_t parity;
    const uint32_t s = ring.next(g.ws, parity);
    hop::mbar_wait(r.wempty + s, parity ^ 1);
    unsigned char* dst = r.win + s * g.win_bytes;
    hop::mbar_arrive_expect_tx(r.wfull + s, g.nci * g.P * ROW + (pool ? 0 : g.cw * 2));
    for (int ci = 0; ci < g.nci; ++ci)
      hop::tma_load_4d(dst + ci * g.MP * ROW, &m->x, r.wfull + s, ci * KCH,
                       x.ox0 * g.stride - g.pad, x.oy0 * g.stride - g.pad, x.n);
    if (!pool) hop::tma_load_3d(dst + g.nci * g.MP * ROW, &m->pb, r.wfull + s, x.c0, 0, 0);
  }
}

// A stage a chunk of E: the expand weight's boxes for each chunk of Cin
// (none for the identity), (pass 2) the projection's boxes of the unit's
// columns, the depthwise weight's k*k rows and the chunk's biases, and (pass
// 2 of an SE block) the unit's image's gate.
__device__ inline void produce_weights(const Geo& g, const Rings& r, const Maps* m, bool pool,
                                       Ring& ring) {
  ring.cur = 0;
  const bool gated = !pool && g.Se > 0;
  const uint32_t bytes = g.exp_bytes + (pool ? 0 : g.nbig * BOX64 + g.nsmall * BOX8) +
                         g.K * g.K * ROW + (g.identity ? 0 : ROW) + ROW + (gated ? 2 * ROW : 0);
  const int units = units_of(g, pool);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u, pool);
    for (int c = 0; c < g.nec; ++c) {
      uint32_t parity;
      const uint32_t s = ring.next(g.bs, parity);
      hop::mbar_wait(r.bempty + s, parity ^ 1);
      hop::mbar_arrive_expect_tx(r.bfull + s, bytes);
      unsigned char* dst = r.b + s * g.stage_bytes;
      if (!g.identity)
        for (int ci = 0; ci < g.nci; ++ci)
          hop::tma_load_3d(dst + ci * BOX64, &m->ew, r.bfull + s, c * KCH, ci * KCH, 0);
      if (!pool) {
        unsigned char* prj = dst + g.exp_bytes;
        for (int b = 0; b < g.nbig; ++b)
          hop::tma_load_3d(prj + b * BOX64, &m->pw128, r.bfull + s, x.c0 + 64 * b, c * KCH, 0);
        prj += g.nbig * BOX64;
        for (int b = 0; b < g.nsmall; ++b)
          hop::tma_load_3d(prj + b * BOX8, &m->pw8, r.bfull + s, x.c0 + 64 * g.nbig + 8 * b,
                           c * KCH, 0);
      }
      hop::tma_load_3d(dst + g.dw_off, &m->dw, r.bfull + s, c * KCH, 0, 0);
      if (!g.identity) hop::tma_load_3d(dst + g.eb_off, &m->eb, r.bfull + s, c * KCH, 0, 0);
      hop::tma_load_3d(dst + g.db_off, &m->db, r.bfull + s, c * KCH, 0, 0);
      if (gated) hop::tma_load_3d(dst + g.gt_off, &m->gate, r.bfull + s, c * KCH, x.n, 0);
    }
  }
}

// ---- consumers ----------------------------------------------------------------------

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo_f(w[i]);
    f[2 * i + 1] = hi_f(w[i]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t swz(int p, int j) {  // byte offset of group j of row p
  return p * ROW + ((j ^ (p & 7)) << 4);
}

// act_named with the activation known at compile time, and the dispatch
// to it: f(std::integral_constant<int, kRelu>) and so on.
template <int A>
__device__ __forceinline__ float act_c(float y) {
  if constexpr (A == kRelu) return fmaxf(y, 0.0f);
  if constexpr (A == kRelu6) return fminf(fmaxf(y, 0.0f), 6.0f);
  if constexpr (A == kHswish) return y * (fminf(fmaxf(y + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f));
  return y;
}

template <class F>
__device__ __forceinline__ void with_act(int a, F f) {
  switch (a) {
    case kRelu: f(std::integral_constant<int, kRelu>{}); break;
    case kRelu6: f(std::integral_constant<int, kRelu6>{}); break;
    case kHswish: f(std::integral_constant<int, kHswish>{}); break;
    default: f(std::integral_constant<int, kLinear>{}); break;
  }
}

// The consumer warpgroup of this thread, as the compiler can see it to be
// the same across the warp.
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0); }

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

// The expansion of the chunk in `stage` into Z: this warpgroup's row blocks
// of the window (wgmma m64n64k16, A the window's chunks of Cin, B the
// stage's expand boxes), each awaited (with all of the warpgroup's wgmma:
// the previous chunk's projection too) and followed by its epilogue: + bias
// in f32 (0 past E: TMA's zero fill), activation A, zero outside the image,
// rounded to bf16.
template <int A>
__device__ __forceinline__ void expand_chunk(const Geo& g, uint32_t inmask, uint32_t win,
                                             const unsigned char* stage, unsigned char* z) {
  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const uint32_t sb = hop::saddr(stage);
  uint32_t bias[8];  // the bias pairs of this thread's columns
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bias[i] = *reinterpret_cast<const uint32_t*>(stage + g.eb_off + 16 * i + 4 * q);
  for (int mb = wg, bit = 0; mb < g.MP / 64; mb += 2, bit += 2) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    hop::wgmma_fence();
    for (int ci = 0; ci < g.nci; ++ci) {
      const int ks = cdiv(min(KCH, g.Cin - KCH * ci), 16);
      const uint32_t a0 = win + ci * g.MP * ROW + mb * 64 * ROW;
      const uint32_t b0 = sb + ci * BOX64;
      for (int k = 0; k < ks; ++k)
        hop::Wgmma<64>::mma(acc, hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128),
                            hop::gmma_desc(b0 + 2048 * k, BOX64, 1024, hop::kSwizzle128));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mb * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const bool in = (inmask >> (bit + h)) & 1u;
      unsigned char* row = z + p * ZROW + 4 * q;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v0 = act_c<A>(acc[4 * i + 2 * h] + lo_f(bias[i]));
        const float v1 = act_c<A>(acc[4 * i + 2 * h + 1] + hi_f(bias[i]));
        *reinterpret_cast<uint32_t*>(row + 16 * i) = in ? pack2(v0, v1) : 0u;
      }
    }
  }
}

// A thread's share of a chunk's depthwise: group j (8 channels) of the
// chunk's G live groups, for tile pixels t / G + k * S (k < 4, S = 256 / G
// pixel slots). Decoded once a unit (and again for a narrower last chunk).
struct Items {
  int j;
  int m[4];   // tile pixel, or -1: none, or its output lies outside the image
  int zo[4];  // window pixel of its tap (0, 0)
};

__device__ __forceinline__ Items decode(const Geo& g, const Unit& x, int G) {
  const int t = threadIdx.x, S = CONSUMERS / G;
  Items it;
  const int slot = G == 8 ? t >> 3 : t / G;
  it.j = t - slot * G;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = slot + k * S;
    it.m[k] = -1;
    it.zo[k] = 0;
    if (t < S * G && m < g.th * g.tw) {
      const int ih = quot(m, g.inv_tw), iw = m - ih * g.tw;
      if (x.oy0 + ih < g.Ho && x.ox0 + iw < g.Wo) {
        it.m[k] = m;
        it.zo[k] = ih * g.stride * g.pw + iw * g.stride;
      }
    }
  }
  return it;
}

// The depthwise of a chunk from src (Z; kSwz: the swizzled window, for the
// identity): a tap row at a time, the row's k weights from the stage held
// for all of the thread's pixels and a pixel's k taps loaded at once; per
// pixel f32 taps in dy-then-dx order, + bias, act; pool: added to `sum`
// (this thread's pixels in order); else x the gate (gated), rounded into
// the A panel.
template <int K, bool kSwz>
__device__ __forceinline__ void dw_chunk(const Geo& g, const Items& it, const unsigned char* src,
                                         unsigned char* apanel, const unsigned char* stage,
                                         bool gated, bool pool, float (&sum)[8]) {
  float b[8], gt[8];  // loaded ahead of the taps
  unpack8(*reinterpret_cast<const uint4*>(stage + g.db_off + 16 * it.j), b);
  if (gated) {
    const float4 g0 = *reinterpret_cast<const float4*>(stage + g.gt_off + 32 * it.j);
    const float4 g1 = *reinterpret_cast<const float4*>(stage + g.gt_off + 32 * it.j + 16);
    gt[0] = g0.x; gt[1] = g0.y; gt[2] = g0.z; gt[3] = g0.w;
    gt[4] = g1.x; gt[5] = g1.y; gt[6] = g1.z; gt[7] = g1.w;
  }
  float a[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) a[k][e] = 0.0f;
  if (it.m[0] < 0 && it.m[1] < 0 && it.m[2] < 0 && it.m[3] < 0) return;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float w[K][8];
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      unpack8(*reinterpret_cast<const uint4*>(stage + g.dw_off + (dy * K + dx) * ROW + 16 * it.j),
              w[dx]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (it.m[k] < 0) continue;
      const int p0 = it.zo[k] + dy * g.pw;
      const unsigned char* rp = src + p0 * ZROW + 16 * it.j;
      uint4 raw[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        raw[dx] = *reinterpret_cast<const uint4*>(kSwz ? src + swz(p0 + dx, it.j) : rp + dx * ZROW);
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float v[8];
        unpack8(raw[dx], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[k][e] = fmaf(v[e], w[dx][e], a[k][e]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = it.m[k];
    if (m < 0) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = act_named(a[k][e] + b[e], g.act);
    if (pool) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += v[e];
    } else {
      if (gated) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = v[e] * gt[e];
      }
      *reinterpret_cast<uint4*>(apanel + swz(m, it.j)) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
  }
}

// The projection accumulators: a 128- or 64-column slice, then 32, 16, 8.
struct Acc {
  float big[64], s32[16], s16[8], s8[4];
};

__device__ __forceinline__ float (&first32(float (&a)[64]))[32] {
  return *reinterpret_cast<float(*)[32]>(&a[0]);
}

// This warpgroup's share of chunk c's projection (rows a0 of the A panel),
// issued and committed, not awaited.
__device__ __forceinline__ void project(const Geo& g, uint32_t a0, uint32_t stage, int ks,
                                        Acc& acc) {
  const uint32_t bb = stage + g.exp_bytes, b8 = bb + g.nbig * BOX64;
  hop::wgmma_fence();
  for (int k = 0; k < ks; ++k) {
    const uint64_t da = hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128);
    const uint64_t db = hop::gmma_desc(bb + 2048 * k, BOX64, 1024, hop::kSwizzle128);
    if (g.nbig == 2)
      hop::Wgmma<128>::mma(acc.big, da, db);
    else if (g.nbig == 1)
      hop::Wgmma<64>::mma(first32(acc.big), da, db);
    uint32_t so = b8 + 256 * k;
    if (g.nsmall & 4) {
      hop::Wgmma<32>::mma(acc.s32, da, hop::gmma_desc(so, 128, BOX8, hop::kInterleave));
      so += 4 * BOX8;
    }
    if (g.nsmall & 2) {
      hop::Wgmma<16>::mma(acc.s16, da, hop::gmma_desc(so, 128, BOX8, hop::kInterleave));
      so += 2 * BOX8;
    }
    if (g.nsmall & 1) hop::Wgmma<8>::mma(acc.s8, da, hop::gmma_desc(so, 128, BOX8, hop::kInterleave));
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

// Byte offset in the window of channel col (a multiple of 2) of window pixel wp.
__device__ __forceinline__ uint32_t win_at(const Geo& g, int wp, int col) {
  return (col >> 6) * g.MP * ROW + swz(wp, (col & 63) >> 3) + 2 * (col & 7);
}

// bf16(bf16 pair o + bf16 pair r) in f32: the residual, after the rounding.
__device__ __forceinline__ uint32_t add_res(uint32_t o, uint32_t r) {
  return pack2(lo_f(o) + lo_f(r), hi_f(o) + hi_f(r));
}

__device__ __forceinline__ uint32_t out_word(float a0, float a1, uint32_t bias) {
  return pack2(a0 + lo_f(bias), a1 + hi_f(bias));
}

// + bias, rounded, + the residual, stored: the N columns at col0 of rows A
// and B. The accumulator of a warpgroup thread (warp w, lane l) holds, for
// each 8-column group i, columns 8i + 2(l%4) and +1 of rows 16w + l/4
// (registers 4i, 4i+1) and 16w + l/4 + 8 (4i+2, 4i+3).
template <int N>
__device__ __forceinline__ void store_slice(const Geo& g, const Unit& x,
                                            const float (&acc)[N / 2], int col0,
                                            const OutRow& A, const OutRow& B,
                                            const unsigned char* win, bf16* __restrict__ out) {
  const int q = threadIdx.x & 3;
  const unsigned char* pb = win + g.nci * g.MP * ROW + 2 * (col0 - x.c0);  // the part's bias
  uint32_t bias[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    bias[i] = *reinterpret_cast<const uint32_t*>(pb + 16 * i + 4 * q);
  if constexpr (N == 8) {
    const OutRow* rows[2] = {&A, &B};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const OutRow& o = *rows[h];
      if (o.pix < 0) continue;
      uint32_t w = out_word(acc[2 * h], acc[2 * h + 1], bias[0]);
      if (g.residual)
        w = add_res(w, *reinterpret_cast<const uint32_t*>(win + win_at(g, o.wp, col0 + 2 * q)));
      *reinterpret_cast<uint32_t*>(out + o.pix * g.Cout + col0 + 2 * q) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; i += 2) {
      // Words of combination k = (group i + k / 2, row A or B by k % 2): after
      // the transpose lane q of the quad holds combination q's 8 columns.
      const uint32_t w0 = out_word(acc[4 * i], acc[4 * i + 1], bias[i]);
      const uint32_t w1 = out_word(acc[4 * i + 2], acc[4 * i + 3], bias[i]);
      const uint32_t w2 = out_word(acc[4 * i + 4], acc[4 * i + 5], bias[i + 1]);
      const uint32_t w3 = out_word(acc[4 * i + 6], acc[4 * i + 7], bias[i + 1]);
      // Round 1, with lane q ^ 2: keep the two combinations whose bit 1 is
      // q's, send the other two. Round 2, with lane q ^ 1: the same on bit 0.
      const bool b1 = q & 2, b0 = q & 1;
      const uint32_t k0 = b1 ? w2 : w0, k1 = b1 ? w3 : w1;
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? w0 : w2, 2);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? w1 : w3, 2);
      const uint32_t m0 = b0 ? k1 : k0, m1 = b0 ? r1 : r0;
      const uint32_t u0 = __shfl_xor_sync(0xffffffffu, b0 ? k0 : k1, 1);
      const uint32_t u1 = __shfl_xor_sync(0xffffffffu, b0 ? r0 : r1, 1);
      const uint32_t e0 = b0 ? u0 : m0, e1 = b0 ? m0 : u0;
      const uint32_t e2 = b0 ? u1 : m1, e3 = b0 ? m1 : u1;
      uint32_t o[4] = {b1 ? e2 : e0, b1 ? e3 : e1, b1 ? e0 : e2, b1 ? e1 : e3};
      const OutRow& row = (q & 1) ? B : A;
      const int col = col0 + 8 * (i + (q >> 1));
      if (row.pix >= 0) {
        if (g.residual) {
          const uint4 r = *reinterpret_cast<const uint4*>(win + win_at(g, row.wp, col));
          o[0] = add_res(o[0], r.x);
          o[1] = add_res(o[1], r.y);
          o[2] = add_res(o[2], r.z);
          o[3] = add_res(o[3], r.w);
        }
        *reinterpret_cast<uint4*>(out + row.pix * g.Cout + col) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// Every unit of a pass on this block, by the consumer warpgroups.
__device__ inline void consume(const Geo& g, const Rings& r, const Ptrs& p, bool pool,
                               Ring& wring, Ring& bring) {
  const int t = threadIdx.x, wg = warpgroup(), lane = t & 31;
  const int r0 = wg * 64 + ((t & 127) >> 5) * 16 + (lane >> 2);  // the epilogue's row A
  const bool gated = !pool && g.Se > 0;
  const bool rows = wg * 64 < g.th * g.tw;  // this warpgroup's projection rows hold pixels
  const int units = units_of(g, pool);
  wring.cur = 0;
  bring.cur = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of(g, u, pool);
    uint32_t parity;
    const uint32_t ws = wring.next(g.ws, parity);
    hop::mbar_wait(r.wfull + ws, parity);
    unsigned char* win = r.win + ws * g.win_bytes;
    const unsigned char* src = g.identity ? win : r.z;
    Acc acc;
    if (!pool) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc.big[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc.s32[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc.s16[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.s8[i] = 0.0f;
    }
    int G = 0, held = -1;
    Items it;
    const uint32_t inmask = g.identity ? 0u : in_image(g, x);
    for (int c = 0; c < g.nec; ++c) {
      const int live = min(KCH, g.E - KCH * c) / 8;
      if (live != G) {
        G = live;
        it = decode(g, x, G);
      }
      uint32_t bp;
      const int bs = bring.next(g.bs, bp);
      hop::mbar_wait(r.bfull + bs, bp);
      const unsigned char* stage = r.b + bs * g.stage_bytes;
      if (!g.identity)
        with_act(g.act_exp, [&](auto a) {
          expand_chunk<decltype(a)::value>(g, inmask, hop::saddr(win), stage, r.z);
        });
      hop::wgmma_wait<0>();  // the previous chunk's projection: the A panel is free
      if (!pool) {
        if (held >= 0) hop::mbar_arrive(r.bempty + held);
        held = bs;
      }
      hop::named_bar_sync(1, CONSUMERS);  // Z is complete
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.0f;
      if (g.identity) {
        if (g.K == 3)
          dw_chunk<3, true>(g, it, src, r.a, stage, gated, pool, sum);
        else
          dw_chunk<5, true>(g, it, src, r.a, stage, gated, pool, sum);
      } else {
        if (g.K == 3)
          dw_chunk<3, false>(g, it, src, r.a, stage, gated, pool, sum);
        else
          dw_chunk<5, false>(g, it, src, r.a, stage, gated, pool, sum);
      }
      const int S = CONSUMERS / G;
      float* red = reinterpret_cast<float*>(r.a);
      if (pool) {
        hop::mbar_arrive(r.bempty + bs);  // this thread's reads of the stage are done
        if (t < S * G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) red[t * 8 + e] = sum[e];
        }
      } else {
        if (G & 1)  // the last K step's group past E holds zeros
          for (int m = t; m < TM; m += CONSUMERS)
            *reinterpret_cast<uint4*>(r.a + swz(m, G)) = make_uint4(0, 0, 0, 0);
        hop::fence_proxy_async_smem();  // the panel's stores, for wgmma
      }
      hop::named_bar_sync(1, CONSUMERS);  // the panel (pass 1: the sums) is complete
      if (pool) {
        if (t < G * 8) {  // channel t of the chunk: the threads' sums in thread order
          const int e = t & 7;
          float s = 0.0f;
          for (int tt = t >> 3; tt < S * G; tt += G) s += red[tt * 8 + e];
          p.partial[((long long)x.n * g.tiles_img + x.ti) * g.E + c * KCH + t] = s;
        }
      } else if (rows) {
        project(g, hop::saddr(r.a) + wg * 64 * ROW, hop::saddr(stage), cdiv(G * 8, 16), acc);
      }
    }
    if (!pool) {
      hop::wgmma_wait<0>();
      hop::mbar_arrive(r.bempty + held);
      if (rows) {
        const OutRow A = out_row(g, x, r0), B = out_row(g, x, r0 + 8);
        int col = x.c0;
        if (g.nbig == 2) {
          store_slice<128>(g, x, acc.big, col, A, B, win, p.out);
          col += 128;
        } else if (g.nbig == 1) {
          store_slice<64>(g, x, first32(acc.big), col, A, B, win, p.out);
          col += 64;
        }
        if (g.nsmall & 4) {
          store_slice<32>(g, x, acc.s32, col, A, B, win, p.out);
          col += 32;
        }
        if (g.nsmall & 2) {
          store_slice<16>(g, x, acc.s16, col, A, B, win, p.out);
          col += 16;
        }
        if (g.nsmall & 1) store_slice<8>(g, x, acc.s8, col, A, B, win, p.out);
      }
    }
    hop::mbar_arrive(r.wempty + ws);
  }
}

// out[c] = sum over i in [i0, i1) of v[i] * w[i * ld + c], c < 8, in f32 in
// ascending i; `vec`: the 8 columns load as one 16-byte vector.
__device__ __forceinline__ void dot_cols8(const float* v, const bf16* __restrict__ w, int ld,
                                          int i0, int i1, int cols, bool vec, float (&out)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const float x = v[i];
    const bf16* row = w + (long long)i * ld;
    float wv[8];
    if (vec) {
      unpack8(*reinterpret_cast<const uint4*>(row), wv);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) wv[c] = c < cols ? __bfloat162float(row[c]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = fmaf(x, wv[c], out[c]);
  }
}

// Image n's squeeze-excite gate from pass 1's sums, by `nthr` threads
// (thread index `tid`) that `sync` joins: the tiles' sums in tile order
// x 1/(Ho*Wo), rounded; f32 FC + b1, relu, rounded; f32 FC + b2; the hard
// sigmoid in f32, into p.gate. Each product runs over segments of its input
// (FC1_SEGS, FC2_SEGS), 8 outputs an item from 16-byte weight loads, the
// segments' sums then added in segment order: the arithmetic is fixed by
// the segments, not by the thread count, so the chain's gate step equals
// the per-block launch's. `scratch` holds gate_floats(E, Se) floats of
// shared memory.
template <class Sync>
__device__ __forceinline__ void se_gate(const Geo& g, const Ptrs& p, int n, float* scratch,
                                        int tid, int nthr, Sync sync) {
  const int E = g.E, Se = g.Se;
  float* pooled = scratch;
  float* hidden = pooled + E;
  float* part1 = hidden + Se;             // FC1_SEGS x Se
  float* part2 = part1 + FC1_SEGS * Se;   // FC2_SEGS x E
  const float* part = p.partial + (long long)n * g.tiles_img * E;
  for (int e = tid; e < E; e += nthr) {
    float a = 0.0f;
    for (int tt = 0; tt < g.tiles_img; ++tt) a += __ldcg(part + (long long)tt * E + e);
    pooled[e] = __bfloat162float(__float2bfloat16(a * g.inv_hw));
  }
  sync();
  const int se8 = cdiv(Se, 8), seg1 = cdiv(E, FC1_SEGS);
  for (int q = tid; q < FC1_SEGS * se8; q += nthr) {
    const int sg = q / se8, j0 = 8 * (q - sg * se8), cols = min(8, Se - j0);
    float o[8];
    dot_cols8(pooled, p.w1 + j0, Se, sg * seg1, min(E, (sg + 1) * seg1), cols, Se % 8 == 0, o);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < cols) part1[sg * Se + j0 + c] = o[c];
  }
  sync();
  for (int j = tid; j < Se; j += nthr) {
    float a = part1[j];
    for (int sg = 1; sg < FC1_SEGS; ++sg) a += part1[sg * Se + j];
    hidden[j] = __bfloat162float(__float2bfloat16(fmaxf(a + __bfloat162float(p.b1[j]), 0.0f)));
  }
  sync();
  const int e8 = E / 8, seg2 = cdiv(Se, FC2_SEGS);
  for (int q = tid; q < FC2_SEGS * e8; q += nthr) {
    const int sg = q / e8, c0 = 8 * (q - sg * e8);
    float o[8];
    dot_cols8(hidden, p.w2 + c0, E, sg * seg2, min(Se, (sg + 1) * seg2), 8, true, o);
#pragma unroll
    for (int c = 0; c < 8; ++c) part2[sg * E + c0 + c] = o[c];
  }
  sync();
  for (int e = tid; e < E; e += nthr) {
    float a = part2[e];
    for (int sg = 1; sg < FC2_SEGS; ++sg) a += part2[sg * E + e];
    a = a + __bfloat162float(p.b2[e]);
    __stcg(p.gate + (long long)n * E + e, fminf(fmaxf(a + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f));
  }
  sync();
}

// One pass of every unit of a block by one role: the consumer warpgroups,
// or the producer warpgroup's window producer (its thread 0) and weight
// producer (thread 32).
template <bool kConsumer>
__device__ __forceinline__ void run_pass(const Geo& g, const Rings& r, const Maps* m,
                                         const Ptrs& p, bool pool, Ring& wring, Ring& bring) {
  if constexpr (kConsumer) {
    consume(g, r, p, pool, wring, bring);
  } else {
    const int t = threadIdx.x - CONSUMERS;
    if (t == 0)
      produce_window(g, r, m, pool, wring);
    else if (t == 32)
      produce_weights(g, r, m, pool, bring);
  }
}

// Runs body(std::true_type) on the consumer warpgroups with 232 registers a
// thread and body(std::false_type) on the producer warpgroup with 40: each
// role's whole code lies under its setmaxnreg, so the register allocator
// holds the producers' share to 40.
template <class Body>
__device__ __forceinline__ void by_role(Body body) {
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) < CONSUMERS / 128) {
    hop::setmaxnreg_inc<232>();
    body(std::true_type{});
  } else {
    hop::setmaxnreg_dec<40>();
    body(std::false_type{});
  }
}

// ---- host ---------------------------------------------------------------------------

// The maps of one pass: x (N, H, W, Cin) windows, the expand weight (Cin,
// E), the projection weight (E, Cout) in 64- and 8-column boxes (each only
// where the plan takes it), the depthwise weight, the three biases and the
// gates (N, E) f32.
inline cudaError_t make_maps(Maps& m, const void* x, const void* ew, const void* eb,
                             const void* dw, const void* db, const void* pw, const void* pb,
                             const void* gate, const Geo& g) {
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t xd[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                            (cuuint64_t)g.N};
  const cuuint64_t xs[3] = {(cuuint64_t)g.Cin * 2, (cuuint64_t)g.W * g.Cin * 2,
                            (cuuint64_t)g.H * g.W * g.Cin * 2};
  const cuuint32_t xb[4] = {(cuuint32_t)KCH, (cuuint32_t)g.pw, (cuuint32_t)g.ph, 1};
  cudaError_t e = hop::make_map_4d(&m.x, bf, x, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  if (!g.identity) {
    const cuuint64_t d[3] = {(cuuint64_t)g.E, (cuuint64_t)g.Cin, 1};
    const cuuint64_t s[2] = {(cuuint64_t)g.E * 2, (cuuint64_t)g.Cin * g.E * 2};
    const cuuint32_t b[3] = {(cuuint32_t)KCH, (cuuint32_t)KCH, 1};
    if ((e = hop::make_map_3d(&m.ew, bf, ew, d, s, b, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
      return e;
  }
  const cuuint64_t d[3] = {(cuuint64_t)g.Cout, (cuuint64_t)g.E, 1};
  const cuuint64_t s[2] = {(cuuint64_t)g.Cout * 2, (cuuint64_t)g.E * g.Cout * 2};
  if (g.nbig > 0) {
    const cuuint32_t b[3] = {64, (cuuint32_t)KCH, 1};
    if ((e = hop::make_map_3d(&m.pw128, bf, pw, d, s, b, CU_TENSOR_MAP_SWIZZLE_128B)) !=
        cudaSuccess)
      return e;
  }
  if (g.nsmall > 0) {
    const cuuint32_t b[3] = {8, (cuuint32_t)KCH, 1};
    if ((e = hop::make_map_3d(&m.pw8, bf, pw, d, s, b, CU_TENSOR_MAP_SWIZZLE_NONE)) !=
        cudaSuccess)
      return e;
  }
  {  // the depthwise weight as (k*k, E): a chunk's k*k rows of 64
    const cuuint64_t dd[3] = {(cuuint64_t)g.E, (cuuint64_t)g.K * g.K, 1};
    const cuuint64_t ds[2] = {(cuuint64_t)g.E * 2, (cuuint64_t)g.K * g.K * g.E * 2};
    const cuuint32_t db[3] = {(cuuint32_t)KCH, (cuuint32_t)(g.K * g.K), 1};
    if ((e = hop::make_map_3d(&m.dw, bf, dw, dd, ds, db, CU_TENSOR_MAP_SWIZZLE_NONE)) !=
        cudaSuccess)
      return e;
  }
  const auto vec = [&](CUtensorMap* map, CUtensorMapDataType type, const void* v, int n,
                       int rows, int box) {  // rows of n elements, boxes of `box` x 1
    const int item = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
    const cuuint64_t vd[3] = {(cuuint64_t)n, (cuuint64_t)rows, 1};
    const cuuint64_t vs[2] = {(cuuint64_t)n * item, (cuuint64_t)n * rows * item};
    const cuuint32_t vb[3] = {(cuuint32_t)box, 1, 1};
    return hop::make_map_3d(map, type, v, vd, vs, vb, CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  if (!g.identity && (e = vec(&m.eb, bf, eb, g.E, 1, KCH)) != cudaSuccess) return e;
  if ((e = vec(&m.db, bf, db, g.E, 1, KCH)) != cudaSuccess) return e;
  if ((e = vec(&m.pb, bf, pb, g.Cout, 1, g.cw)) != cudaSuccess) return e;
  if (g.Se > 0 && (e = vec(&m.gate, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gate, g.E, g.N, KCH)) !=
                      cudaSuccess)
    return e;
  return cudaSuccess;
}

}  // namespace v3w
}  // namespace mnk
