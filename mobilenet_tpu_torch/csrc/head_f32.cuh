// The float32 fused head on Hopper's CUDA cores: three kernels that
// fused_head.cu launches in sequence, planned by ops/head.f32_head_plan.
// IEEE float32 throughout: every product an fmaf (no tensor core, no TF32).
//
// What held the old float32 kernels: the post stage ran a block of two
// images over every weight (at batch 256, 128 blocks each read a whole fc:
// V1's 4.1 MB weight passed through L2 128 times), one fmaf chain a column;
// conv_last ran 64 x 128 tiles with synchronous loads, one fmaf per shared
// load pair. The design, head_wgmma.cuh's plan with fmaf micro-tiles in
// place of wgmma:
//
// pool_f32_kernel (V1, no conv_last): the mean over H*W of (N, H*W, C)
// features into (N, ld) rows, a block an image x 64 channels: its 128
// threads stage up to 64 pixels x 64 channels at a time as 16-byte vectors
// (all in flight at once), then a thread a channel sums them in pixel order;
// the sum / (H*W); zeros in the columns [C, ld). Each feature byte is read
// once.
//
// conv_walk_f32_kernel<128, 128> (V2, V3, where its 128-row tiles x
// 128-column slices fill half the card): conv_last (1x1, C -> E) + bias +
// activation, pooled per image. A block owns a 128-column slice of E and a
// group of whole images; the group's pixel rows are walked in 128-row tiles
// that cross image boundaries. A tile's product runs over K chunks of 32
// whose input rows and weight rows arrive by cp.async through a ring of 3
// (the next chunks load while this one multiplies); each of the 256 threads
// owns 8 rows x 8 columns of the tile (16 float4 loads for 256 fmaf, the
// rows' loads broadcast across a quarter warp). The tile, + bias and
// activation, is staged in shared memory over the ring, and a thread a
// column sums its rows in pixel order, carrying its image's sum across
// tiles, and at an image's last pixel stores sum / (H*W). Only the pooled (N,
// E) rows reach device memory; the weight streams through each block once a
// tile, so any C fits.
//
// post_f32_kernel (each post matmul above a batch of 16): out = act(A @ W +
// b) for A (N, lda) pooled rows and W (K, M) row-major. A block owns a 64-row
// x 64-column output tile and a part of K's 32-row chunks, which arrive by
// cp.async through a ring of 4 (4 x 4 fmaf a thread); each weight byte
// leaves L2 once per 64-image tile. The K parts of a tile form a
// thread-block cluster (1 to 8 blocks): each writes its partial tile to its
// shared memory, and after a cluster barrier each block reduces its share of
// the tile's columns over the parts' partials, read through distributed
// shared memory, summed in rank order (a fixed order: no atomics), adds the
// bias, applies the activation.
//
// narrow_f32_kernel<POOL> (a batch of at most 16: the post matmuls, and with
// POOL the conv_last walk): a block owns 8 or 16 columns of the output and
// the whole of K, so a launch puts M / 8 or 16 blocks on the card without a cluster
// (each a thread-block cluster's launch cost ~5 us on the card). K arrives in
// 64-row chunks of A rows and the 8 weight columns through a cp.async ring
// deep enough to hold a block's whole part in flight; the block's threads
// split each chunk's K rows into slices (4 x 4 fmaf a thread), and the
// slices' partial tiles are summed in slice order in shared memory before
// the bias and activation (POOL: over 64-row tiles of every image's pixel
// rows, then pooled in pixel order by a thread a column, as conv_walk).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace hf {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;     // conv_walk and post: 16 x 16 threads (post at 16 rows: x 4)
constexpr int POOL_THREADS = 128;
constexpr int POOL_PIX = 64;     // pixels staged a round
constexpr int POOL_CH = 64;      // channels a block
constexpr int BK = 32;           // conv_walk: K a chunk
constexpr int SMALL_N = 16;      // narrow_f32_kernel from the post matmuls' batch up to this
constexpr int PK = 32;           // post: K a chunk
constexpr int PT = 64;           // post: columns a tile
constexpr int PS = 4;            // post: ring slots (chunks of K)
constexpr int RED_LD = PT + 4;   // post: floats a row of a partial tile
constexpr int MAX_KPARTS = 8;    // post: a portable cluster
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

constexpr int CS = 3;            // conv_walk: ring slots

// narrow's geometry: rows a tile (64 with POOL, else 16), K a chunk (64,
// else 256: a post's K up to 1024 rows in flight at once), ring slots, and K
// slices of the block (256 threads over tr/4 x nc/4 quads, nc the columns a
// block, 8 or 16).
__host__ __device__ constexpr int narrow_rows(bool pool) { return pool ? 64 : SMALL_N; }
__host__ __device__ constexpr int narrow_k(bool pool) { return pool ? 64 : 256; }
__host__ __device__ constexpr int narrow_slots(bool) { return 4; }
__host__ __device__ constexpr int narrow_slices(bool pool, int nc) {
  return THREADS / (narrow_rows(pool) / 4 * (nc / 4));
}

// Dynamic shared memory (ops/head.f32_head_smem_bytes mirrors all three):
// conv_walk: its ring of A chunks (128 x BK) and weight chunks (BK x 128), or
// the staged tile (128 x 132) over them once a tile's chunks are done; post:
// a ring of PS A chunks (64 x 32) and W chunks (32 x 64) and the partial tile
// (64 x RED_LD); narrow: its ring of A chunks (tr x nk) and weight chunks (nk
// x 8) and its slices' partial tiles (slices x tr x 8).
__host__ __device__ inline int conv_smem_bytes() {
  return imax(CS * (128 * BK + BK * 128), 128 * 132) * 4;
}
__host__ __device__ inline int post_smem_bytes() { return (PS * (PT * PK + PK * PT) + PT * RED_LD) * 4; }
__host__ __device__ inline int narrow_smem_bytes(bool pool, int nc) {
  const int tr = narrow_rows(pool), nk = narrow_k(pool);
  return (narrow_slots(pool) * (tr * nk + nk * nc) + narrow_slices(pool, nc) * tr * nc) * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// a[i][..] += x[i][kk] * b[kk][..] over kk < 4, for R rows of 4 columns.
template <int R>
__device__ __forceinline__ void fma_rows(float (&a)[R][4], const float4 (&x)[R],
                                         const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[i][0] = fmaf(xs[kk], b[kk].x, a[i][0]);
      a[i][1] = fmaf(xs[kk], b[kk].y, a[i][1]);
      a[i][2] = fmaf(xs[kk], b[kk].z, a[i][2]);
      a[i][3] = fmaf(xs[kk], b[kk].w, a[i][3]);
    }
  }
}

// ---- pool ---------------------------------------------------------------------------

// out[n][c] = sum_p x[n, p, c] / HW for c < C, 0 for C <= c < cols; grid
// (cdiv(cols, 64), N). vec: C % 4 == 0 and x 16-byte aligned.
__global__ void __launch_bounds__(POOL_THREADS)
    pool_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int HW, int C,
                    int cols, int ldo, int vec) {
  __shared__ __align__(16) float slab[POOL_PIX][POOL_CH];
  const int n = blockIdx.y, c0 = blockIdx.x * POOL_CH, t = threadIdx.x;
  const float* xs = x + (long long)n * HW * C;
  float sum = 0.0f;
  for (int p0 = 0; p0 < HW; p0 += POOL_PIX) {
    const int np = min(POOL_PIX, HW - p0);
    if (vec) {
      for (int i = t; i < np * (POOL_CH / 4); i += POOL_THREADS) {
        const int p = i >> 4, c = c0 + 4 * (i & 15);
        *reinterpret_cast<float4*>(&slab[p][c - c0]) =
            c < C ? __ldg(reinterpret_cast<const float4*>(xs + (long long)(p0 + p) * C + c))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int i = t; i < np * POOL_CH; i += POOL_THREADS) {
        const int p = i / POOL_CH, j = i - p * POOL_CH;
        slab[p][j] = c0 + j < C ? xs[(long long)(p0 + p) * C + c0 + j] : 0.0f;
      }
    }
    __syncthreads();
    if (t < POOL_CH)
      for (int p = 0; p < np; ++p) sum += slab[p][t];
    __syncthreads();
  }
  if (t < POOL_CH && c0 + t < cols) out[(long long)n * ldo + c0 + t] = sum / float(HW);
}

// ---- conv_last walk ---------------------------------------------------------------

struct ConvGeo {
  int N, HW, C, E, act;
  int groups, gimg;  // image groups (grid y), images a group
  int ldo;           // the pooled rows' pitch
};

// grid (cdiv(E, BN), groups); THREADS threads.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
    conv_walk_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, float* __restrict__ pooled,
                         const ConvGeo g) {
  constexpr int RT = BM / 16, CG = BN / 64, LDC = BN + 4, S = CS;
  constexpr int SLOT = BM * BK + BK * BN;  // floats: a chunk's A rows, then its weight rows
  extern __shared__ __align__(16) float sm_conv[];
  float* Cs = sm_conv;  // [BM][LDC], over the ring once a tile's chunks are done
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int e0 = blockIdx.x * BN;
  const int img0 = blockIdx.y * g.gimg, img1 = min(g.N, img0 + g.gimg);
  if (img0 >= img1) return;
  const long long rows = (long long)(img1 - img0) * g.HW;
  const float* xg = x + (long long)img0 * g.HW * g.C;
  const int nch = cdiv(g.C, BK);
  float run = 0.0f;  // threads t < BN: column e0 + t's sum of the image in progress
  int cnt = 0, img = img0;
  const auto load = [&](long long r0, int c) {
    const int k0 = c * BK;
    float* a = sm_conv + (c % S) * SLOT;
    for (int i = t; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), q = (i % (BK / 4)) * 4;
      const bool ok = r0 + r < rows && k0 + q < g.C;
      hop::cp_async16_zfill(a + r * BK + q, ok ? xg + (r0 + r) * g.C + k0 + q : x, ok ? 16u : 0u);
    }
    float* bb = a + BM * BK;
    for (int i = t; i < BK * (BN / 4); i += THREADS) {
      const int k = i / (BN / 4), q = (i - k * (BN / 4)) * 4;
      const bool ok = k0 + k < g.C && e0 + q < g.E;
      hop::cp_async16_zfill(bb + k * BN + q, ok ? w + (long long)(k0 + k) * g.E + e0 + q : w,
                            ok ? 16u : 0u);
    }
  };
  for (long long r0 = 0; r0 < rows; r0 += BM) {
    float acc[CG][RT][4];
#pragma unroll
    for (int gg = 0; gg < CG; ++gg)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[gg][i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < S - 1; ++c) {
      if (c < nch) load(r0, c);
      hop::cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      if (c + S - 1 < nch) load(r0, c + S - 1);
      hop::cp_async_commit();
      hop::cp_async_wait<S - 1>();  // chunk c's group has landed for this thread
      __syncthreads();              // ... and for every thread
      const float* a = sm_conv + (c % S) * SLOT + ty * RT * BK;
      const float* bb = sm_conv + (c % S) * SLOT + BM * BK + tx * 4;
#pragma unroll
      for (int k = 0; k < BK; k += 4) {
#pragma unroll
        for (int h = 0; h < RT; h += 4) {  // four rows at a time: no spill at 128 registers
          float4 av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = ld4(a + (h + i) * BK + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float4 bv[CG];
#pragma unroll
            for (int gg = 0; gg < CG; ++gg) bv[gg] = ld4(bb + (k + kk) * BN + 64 * gg);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xs = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int gg = 0; gg < CG; ++gg) {
                acc[gg][h + i][0] = fmaf(xs, bv[gg].x, acc[gg][h + i][0]);
                acc[gg][h + i][1] = fmaf(xs, bv[gg].y, acc[gg][h + i][1]);
                acc[gg][h + i][2] = fmaf(xs, bv[gg].z, acc[gg][h + i][2]);
                acc[gg][h + i][3] = fmaf(xs, bv[gg].w, acc[gg][h + i][3]);
              }
            }
          }
        }
      }
      __syncthreads();  // chunk c is consumed: its slot may refill
    }
    // + bias, act, staged over the ring; then the pool sums in pixel order
#pragma unroll
    for (int gg = 0; gg < CG; ++gg) {
      const int col = tx * 4 + 64 * gg;
      const float4 bias = e0 + col < g.E ? __ldg(reinterpret_cast<const float4*>(b + e0 + col))
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < RT; ++i)
        *reinterpret_cast<float4*>(Cs + (ty * RT + i) * LDC + col) =
            make_float4(act_named(acc[gg][i][0] + bias.x, g.act),
                        act_named(acc[gg][i][1] + bias.y, g.act),
                        act_named(acc[gg][i][2] + bias.z, g.act),
                        act_named(acc[gg][i][3] + bias.w, g.act));
    }
    __syncthreads();
    if (t < BN) {
      const int nrows = (int)min((long long)BM, rows - r0);
      for (int r = 0; r < nrows; r += 8) {  // 8 rows' loads in flight, then their sums in order
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = r + j < nrows ? Cs[(r + j) * LDC + t] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (r + j >= nrows) break;
          run += v[j];
          if (++cnt == g.HW) {
            if (e0 + t < g.E) pooled[(long long)img * g.ldo + e0 + t] = run / float(g.HW);
            run = 0.0f;
            cnt = 0;
            ++img;
          }
        }
      }
    }
    __syncthreads();  // the staged tile is read before the next tile's chunks land over it
  }
}

// ---- post matmuls ---------------------------------------------------------------------

struct PostGeo {
  int N, K, M;     // rows, K (W's rows), W's columns (a multiple of 4)
  int lda, ldo, m_out;  // A's and out's row pitch, the columns stored
  int act, kparts, nch, ti, tj;
};

__host__ __device__ inline PostGeo post_geo(int N, int K, int M, int lda, int ldo, int m_out,
                                            int act, int kparts) {
  PostGeo g{};
  g.N = N; g.K = K; g.M = M; g.lda = lda; g.ldo = ldo; g.m_out = m_out; g.act = act;
  g.kparts = kparts;
  g.nch = cdiv(K, PK);
  g.ti = cdiv(N, PT);
  g.tj = cdiv(M, PT);
  return g;
}

// grid (tj, kparts, ti), cluster (1, kparts, 1); THREADS threads.
__global__ void __launch_bounds__(THREADS)
    post_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, const PostGeo g) {
  constexpr int SLOT = PT * PK + PK * PT;  // floats: a chunk's A rows, then its W rows
  extern __shared__ __align__(16) float sm_post[];
  float* red = sm_post + PS * SLOT;  // [PT][RED_LD]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int j = blockIdx.x, part = blockIdx.y, i = blockIdx.z;
  const int c_begin = part * g.nch / g.kparts, c_end = (part + 1) * g.nch / g.kparts;
  const int rows = min(PT, g.N - PT * i);
  const auto load = [&](int c) {
    const int k0 = c * PK;
    float* as = sm_post + ((c - c_begin) % PS) * SLOT;
    for (int x = t; x < PT * (PK / 4); x += THREADS) {
      const int r = x >> 3, q = (x & 7) * 4;
      const bool ok = r < rows && k0 + q < g.K;
      hop::cp_async16_zfill(as + r * PK + q, ok ? a + (long long)(PT * i + r) * g.lda + k0 + q : a,
                            ok ? 16u : 0u);
    }
    float* ws = as + PT * PK;
    for (int x = t; x < PK * (PT / 4); x += THREADS) {
      const int k = x >> 4, q = (x & 15) * 4;
      const bool ok = k0 + k < g.K && PT * j + q < g.M;
      hop::cp_async16_zfill(ws + k * PT + q, ok ? w + (long long)(k0 + k) * g.M + PT * j + q : w,
                            ok ? 16u : 0u);
    }
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
  for (int c = 0; c < PS - 1; ++c) {
    if (c_begin + c < c_end) load(c_begin + c);
    hop::cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    if (c + PS - 1 < c_end) load(c + PS - 1);
    hop::cp_async_commit();
    hop::cp_async_wait<PS - 1>();
    __syncthreads();
    const float* as = sm_post + ((c - c_begin) % PS) * SLOT + ty * 4 * PK;
    const float* ws = sm_post + ((c - c_begin) % PS) * SLOT + PT * PK + tx * 4;
#pragma unroll
    for (int k = 0; k < PK; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = ld4(as + r * PK + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(ws + (k + kk) * PT);
      fma_rows<4>(acc, av, bv);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(red + (ty * 4 + r) * RED_LD + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's partial tile is written
  // this block's share of the tile's columns (groups of 4), over the parts'
  // partials in rank order
  const float* parts[MAX_KPARTS];
#pragma unroll
  for (int p = 0; p < MAX_KPARTS; ++p)
    parts[p] = cluster.map_shared_rank(red, p < g.kparts ? p : 0);
  const int g0 = part * (PT / 4) / g.kparts, ng = (part + 1) * (PT / 4) / g.kparts - g0;
  for (int idx = t; idx < rows * ng; idx += THREADS) {
    const int r = idx / ng, c4 = 4 * (g0 + idx - r * ng);
    float4 pv[MAX_KPARTS];
#pragma unroll
    for (int p = 0; p < MAX_KPARTS; ++p)
      if (p < g.kparts) pv[p] = ld4(parts[p] + r * RED_LD + c4);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < MAX_KPARTS; ++p)
      if (p < g.kparts) {
        v[0] += pv[p].x;
        v[1] += pv[p].y;
        v[2] += pv[p].z;
        v[3] += pv[p].w;
      }
    float* o = out + (long long)(PT * i + r) * g.ldo;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = PT * j + c4 + e;
      if (col < g.m_out) o[col] = act_named(v[e] + __ldg(bias + col), g.act);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

// ---- small batches ------------------------------------------------------------------------

// out (or, POOL, the pooled rows) for columns [NC blockIdx.x, + NC) of act(A
// @ W + b): A (rows, lda) with rows = N (POOL: N * HW pixel rows, walked in
// 64-row tiles), W (K, M) row-major; grid cdiv(M, NC), THREADS threads. K
// slice s of the block takes rows [s * KPS, (s + 1) * KPS) of every chunk;
// thread (s, row quad, column quad) 4 x 4 fmaf.
template <bool POOL, int NC>
__global__ void __launch_bounds__(THREADS)
    narrow_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, const PostGeo g,
                      int HW) {
  constexpr int TR = narrow_rows(POOL), NK = narrow_k(POOL), S = narrow_slots(POOL);
  constexpr int NCQ = NC / 4;
  constexpr int KSL = narrow_slices(POOL, NC), SLOT = TR * NK + NK * NC;
  constexpr int KPS = NK / KSL;  // K rows a slice takes of a chunk
  static_assert(KPS % 4 == 0, "a slice takes whole float4 steps of K");
  extern __shared__ __align__(16) float sm_narrow[];
  float* red = sm_narrow + S * SLOT;  // KSL x [TR][NC]
  const int t = threadIdx.x, pos = t % (TR / 4 * NCQ), s = t / (TR / 4 * NCQ);
  const int rq = pos / NCQ, cq = pos % NCQ;  // row quad, column quad
  const int c0 = NC * blockIdx.x;
  const long long rows = POOL ? (long long)g.N * HW : g.N;
  const int nch = cdiv(g.K, NK);
  float run = 0.0f;  // POOL, threads t < NC: column c0 + t's sum of the image in progress
  int cnt = 0, img = 0;
  for (long long r0 = 0; r0 < rows; r0 += TR) {
    const auto load = [&](int c) {
      const int k0 = c * NK;
      float* as = sm_narrow + (c % S) * SLOT;
      // rows past the tile's (a batch below 16, the last pixel tile) are not
      // loaded: their sums are never stored
      const int live = (int)min((long long)TR, rows - r0);
      for (int x = t; x < live * (NK / 4); x += THREADS) {
        const int r = x / (NK / 4), q = (x % (NK / 4)) * 4;
        const bool ok = k0 + q < g.K;
        hop::cp_async16_zfill(as + r * NK + q, ok ? a + (r0 + r) * g.lda + k0 + q : a,
                              ok ? 16u : 0u);
      }
      float* ws = as + TR * NK;
      for (int x = t; x < NK * (NC / 4); x += THREADS) {
        const int k = x / NCQ, q = (x % NCQ) * 4;
        const bool ok = k0 + k < g.K && c0 + q < g.M;
        hop::cp_async16_zfill(ws + k * NC + q, ok ? w + (long long)(k0 + k) * g.M + c0 + q : w,
                              ok ? 16u : 0u);
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < S - 1; ++c) {
      if (c < nch) load(c);
      hop::cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      if (c + S - 1 < nch) load(c + S - 1);
      hop::cp_async_commit();
      hop::cp_async_wait<S - 1>();
      __syncthreads();
      const float* as = sm_narrow + (c % S) * SLOT + rq * 4 * NK + s * KPS;
      const float* ws = sm_narrow + (c % S) * SLOT + TR * NK + s * KPS * NC + cq * 4;
#pragma unroll
      for (int k = 0; k < KPS; k += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(as + i * NK + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(ws + (k + kk) * NC);
        fma_rows<4>(acc, av, bv);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red + (s * TR + rq * 4 + i) * NC + cq * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    // the slices' partial tiles in slice order, + bias, act, into slice 0's
    for (int x = t; x < TR * NC; x += THREADS) {
      const int col = c0 + (x & (NC - 1));
      float v = red[x];
#pragma unroll 4
      for (int sl = 1; sl < KSL; ++sl) v += red[sl * TR * NC + x];
      red[x] = act_named(v + (col < g.M ? __ldg(bias + col) : 0.0f), g.act);
    }
    __syncthreads();
    if constexpr (POOL) {
      if (t < NC) {
        const int nrows = (int)min((long long)TR, rows - r0);
        for (int r = 0; r < nrows; r += 8) {  // as conv_walk: 8 loads in flight, sums in order
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = r + j < nrows ? red[(r + j) * NC + t] : 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (r + j >= nrows) break;
            run += v[j];
            if (++cnt == HW) {
              if (c0 + t < g.m_out) out[(long long)img * g.ldo + c0 + t] = run / float(HW);
              run = 0.0f;
              cnt = 0;
              ++img;
            }
          }
        }
      }
    } else {
      for (int x = t; x < TR * NC; x += THREADS) {
        const int r = x / NC, col = c0 + (x & (NC - 1));
        if (r0 + r < rows && col < g.m_out) out[(r0 + r) * g.ldo + col] = red[x];
      }
    }
    __syncthreads();  // the ring and red are free for the next tile
  }
}

}  // namespace hf
}  // namespace mnk
