// The bf16 fused head on Hopper: three kernels that fused_head.cu launches
// in sequence, planned by ops/head.head_plan.
//
// pool_kernel (V1, no conv_last): the mean over H*W of (N, H*W, C)
// features into (N, ld) rows, a block an image x 64 channels: its 128
// threads stage up to 64 pixels x 64 channels at a time as 16-byte vectors
// (all in flight at once), then a thread a channel sums them in f32 in
// pixel order; the mean, rounded to bf16; zeros in the columns [C, ld).
// Each feature byte is read once.
//
// conv_walk_kernel (V2, V3): conv_last (1x1, C -> E) + bias + activation,
// rounded to bf16, pooled per image, on wgmma. A block owns one column
// slice of E (64 a consumer warpgroup, one or two warpgroups) and a group
// of whole images. Its slice of the weight stays resident in shared memory
// (TMA boxes of 64 columns x 64 K rows, 128-byte swizzle, loaded once);
// the group's pixel rows stream through a ring of 64 x 64 A chunks (TMA,
// 128-byte swizzle; two tiles' worth where shared memory allows) in 64-row
// tiles that cross image boundaries, so no row is padding but the group's
// last tile's. Each warpgroup multiplies the tile by its 64 columns
// (m64n64k16, f32 accumulators), then writes + bias, activation, bf16 to a
// staging tile, issues the next tile's products, and while they run on the
// tensor cores a thread a column sums the staged rows in pixel order,
// carrying its image's f32 sum across tiles, and at an image's last pixel
// stores round(sum / (H*W)). Only the pooled (N, E) rows reach device
// memory. Where the ring holds a whole tile's chunks, a tile's slots are
// freed once its products are done (all of them stay in flight meanwhile);
// where it holds fewer (a wide C: the weight slice leaves little room), the
// eager form frees each chunk's slot as soon as its products are done
// (kEager: at most one chunk's products in flight), so that any ring of two
// slots or more keeps the producer going.
//
// post_kernel (each post matmul): out = round(act(A @ W + b)) for A (N,
// lda) bf16 pooled rows and W (K, M) row-major (M a multiple of 8). A
// block owns a 64-row x 64-column output tile and a part of K's 64-row
// chunks; a producer warp streams the part's A and W chunks through a TMA
// ring (A K-major, W MN-major, both with the 128-byte swizzle; rows of A
// past N and rows of W past K load as zeros), a consumer warpgroup
// multiplies them (m64n64k16). Each weight byte leaves L2 once per 64-image
// tile. The K parts of a tile form a thread-block cluster (1 to 8 blocks):
// each writes its f32 partial tile to its shared memory, and after a
// cluster barrier each block reduces its share of the tile's columns over
// the parts' partials, read through distributed shared memory as 16-byte
// vectors (all parts' at once), summed in rank order (a fixed order: no
// atomics, the same sums on every run), adds the bias in f32, applies the
// activation and rounds. Parts are chosen so that even at batch 1 the
// launch puts >= 128 blocks on the card; at batch 256 there are 4 row tiles
// and fewer parts.
//
// A second post matmul takes the first's output rows from device memory:
// a second launch of post_kernel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "numerics.cuh"

namespace mnk {
namespace hd {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int KCH = 64;                 // K a chunk: one 128-byte A row
constexpr int TM = 64;                  // rows a tile (wgmma m64)
constexpr int TN = 64;                  // columns a warpgroup's tile
constexpr int CHUNK_BYTES = 64 * 64 * 2;  // a 64 x 64 bf16 TMA box
constexpr int SMEM_LIMIT = 232448;
constexpr int POOL_THREADS = 128;
constexpr int POOL_PIX = 64;            // pixels staged a round
constexpr int POOL_CH = 64;             // channels a block
constexpr int POST_THREADS = 160;       // a consumer warpgroup + a producer warp
constexpr int MAX_POST_STAGES = 8;
constexpr int MAX_KPARTS = 8;           // a portable cluster
constexpr int RED_LD = TN + 4;          // floats a row of the partial tile
constexpr int MAX_CONV_STAGES = 16;
constexpr int STAGE_LD = TN / 2 + 4;    // 32-bit words a row of a warpgroup's staging tile

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory (ops/head.head_smem_bytes mirrors both): 1 KB to
// align the base to the 128-byte swizzle's 1024-byte period, then
// conv_walk: the resident weight slice (a box a chunk of C and a
// warpgroup), the A ring of `stages` chunks, a staging tile a warpgroup and
// the ring's and the weight's barriers;
// post: the ring of `stages` A and W chunks, the f32 partial tile, the
// tile's f32 bias, the barriers.
__host__ __device__ inline int conv_smem_bytes(int C, int nwg, int stages) {
  return 1024 + cdiv(C, KCH) * nwg * CHUNK_BYTES + stages * CHUNK_BYTES +
         nwg * TM * STAGE_LD * 4 + 8 * (2 * stages + 1);
}
// The eager ring protocol (conv_walk_kernel<true>): fewer slots than C's
// chunks (ops/head.conv_eager).
__host__ __device__ inline bool conv_eager(int C, int stages) { return stages < cdiv(C, KCH); }
__host__ __device__ inline int post_smem_bytes(int stages) {
  return 1024 + stages * 2 * CHUNK_BYTES + TM * RED_LD * 4 + TN * 4 + 8 * 2 * stages;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (hop::saddr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- pool ---------------------------------------------------------------------------

// out[n][c] = round(sum_p x[n, p, c] / HW) for c < C, 0 for C <= c < cols;
// grid (cdiv(cols, 64), N). vec: C % 8 == 0 and x 16-byte aligned.
__global__ void __launch_bounds__(POOL_THREADS)
    pool_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int HW, int C, int cols,
                int ldo, int vec) {
  __shared__ __align__(16) uint16_t slab[POOL_PIX][POOL_CH];
  const int n = blockIdx.y, c0 = blockIdx.x * POOL_CH, t = threadIdx.x;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x) + (long long)n * HW * C;
  float sum = 0.0f;
  for (int p0 = 0; p0 < HW; p0 += POOL_PIX) {
    const int np = min(POOL_PIX, HW - p0);
    if (vec) {
      for (int i = t; i < np * (POOL_CH / 8); i += POOL_THREADS) {
        const int p = i >> 3, c = c0 + 8 * (i & 7);
        *reinterpret_cast<uint4*>(&slab[p][c - c0]) =
            c < C ? *reinterpret_cast<const uint4*>(xs + (long long)(p0 + p) * C + c)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int i = t; i < np * POOL_CH; i += POOL_THREADS) {
        const int p = i / POOL_CH, j = i - p * POOL_CH;
        slab[p][j] = c0 + j < C ? xs[(long long)(p0 + p) * C + c0 + j] : uint16_t(0);
      }
    }
    __syncthreads();
    if (t < POOL_CH)
      for (int p = 0; p < np; ++p) sum += __uint_as_float(uint32_t(slab[p][t]) << 16);
    __syncthreads();
  }
  if (t < POOL_CH && c0 + t < cols)
    out[(long long)n * ldo + c0 + t] = __float2bfloat16_rn(sum / float(HW));
}

// ---- conv_last walk ---------------------------------------------------------------

struct ConvGeo {
  int N, HW, C, E, act;
  int nwg, groups, gimg;  // warpgroups (64 columns each), image groups, images a group
  int nch, stages, ldo;   // chunks of C, A ring slots
  int w_off, ring_off, stage_off, bar_off, smem;
};

__host__ __device__ inline ConvGeo conv_geo(int N, int HW, int C, int E, int act, int nwg,
                                            int groups, int stages, int ldo) {
  ConvGeo g{};
  g.N = N; g.HW = HW; g.C = C; g.E = E; g.act = act;
  g.nwg = nwg; g.groups = groups; g.gimg = cdiv(N, groups);
  g.nch = cdiv(C, KCH); g.stages = stages; g.ldo = ldo;
  g.w_off = 0;
  g.ring_off = g.nch * nwg * CHUNK_BYTES;
  g.stage_off = g.ring_off + stages * CHUNK_BYTES;
  g.bar_off = g.stage_off + nwg * TM * STAGE_LD * 4;
  g.smem = conv_smem_bytes(C, nwg, stages);
  return g;
}

// Keeps the compiler from moving accesses to the accumulators across a
// wgmma fence or wait (they are written asynchronously in between).
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// One tile's products for warpgroup wg: acc = 0, then each chunk of C as it
// arrives, four m64n64k16 steps a chunk, committed and left in flight
// (kEager: each chunk's slot freed once its products are done, the last
// chunk's left in flight).
template <bool kEager>
__device__ __forceinline__ void issue_tile(const ConvGeo& g, unsigned char* ring,
                                           unsigned char* W, int wg, uint64_t* full,
                                           uint64_t* empty, float (&acc)[TN / 2],
                                           uint32_t& it) {
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int c = 0; c < g.nch; ++c, ++it) {
    const uint32_t s = it % g.stages;
    hop::mbar_wait(full + s, (it / g.stages) & 1);
    const uint32_t a0 = hop::saddr(ring + s * CHUNK_BYTES);
    const uint32_t b0 = hop::saddr(W + (c * g.nwg + wg) * CHUNK_BYTES);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::Wgmma<TN>::mma(acc, hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128),
                          hop::gmma_desc(b0 + 2048 * k, CHUNK_BYTES, 1024, hop::kSwizzle128));
    hop::wgmma_commit();
    if constexpr (kEager) {
      hop::wgmma_wait<1>();  // the previous chunk's products are done
      if (c > 0) hop::mbar_arrive(empty + (it - 1) % g.stages);
    }
  }
}

// A column's running pool: its f32 sum, its image, the image's pixels left.
struct Walk {
  float sum;
  int cur, left;
};

// + bias, activation kAct, bf16 into the staging tile (rows of STAGE_LD
// words: a bf16 pair a word): rows 16 warp + lane / 4 and + 8, columns 8i +
// 2q and + 1 of the accumulator layout.
template <int kAct>
__device__ __forceinline__ void stage_acc(const float (&acc)[TN / 2],
                                          const uint32_t (&bias)[TN / 8], uint32_t* stage) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5, q = lane & 3;
  const int r = 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const float b_lo = bf16_lo(bias[i]), b_hi = bf16_hi(bias[i]);
    stage[r * STAGE_LD + 4 * i + q] =
        pack2(act_named(acc[4 * i] + b_lo, kAct), act_named(acc[4 * i + 1] + b_hi, kAct));
    stage[(r + 8) * STAGE_LD + 4 * i + q] =
        pack2(act_named(acc[4 * i + 2] + b_lo, kAct), act_named(acc[4 * i + 3] + b_hi, kAct));
  }
}

// Waits for tile `tile`'s products, frees its ring slots (kEager: the last
// chunk's, the others are free already), and stages them (+ bias,
// activation, bf16) once the last tile's walk is done with the staging tile.
template <bool kEager>
__device__ __forceinline__ void finish_tile(const ConvGeo& g, uint64_t* empty, int wg, int tile,
                                            float (&acc)[TN / 2], const uint32_t (&bias)[TN / 8],
                                            uint32_t* stage) {
  hop::wgmma_wait<0>();
  fence_acc(acc);
  for (int c = kEager ? g.nch - 1 : 0; c < g.nch; ++c)
    hop::mbar_arrive(empty + (tile * g.nch + c) % g.stages);
  hop::named_bar_sync(1 + wg, 128);
  switch (g.act) {
    case kRelu: stage_acc<kRelu>(acc, bias, stage); break;
    case kRelu6: stage_acc<kRelu6>(acc, bias, stage); break;
    case kHswish: stage_acc<kHswish>(acc, bias, stage); break;
    default: stage_acc<kLinear>(acc, bias, stage); break;
  }
  hop::named_bar_sync(1 + wg, 128);
}

// Column lt's pool over the tile's first nr staged rows, in pixel order:
// the image's running sum carried from tile to tile, stored at its last
// pixel as round(sum / (H*W)). The rows' loads go out eight at a time,
// then their adds in order.
__device__ __forceinline__ void walk_tile(const ConvGeo& g, const uint32_t* stage, int lt,
                                          int nr, int e, bf16* __restrict__ out, Walk& w) {
  const uint16_t* col = reinterpret_cast<const uint16_t*>(stage) + lt;
  constexpr int B = 8;
  for (int rr = 0; rr < nr;) {
    const int end = rr + min(w.left, nr - rr);  // the current image's rows in this tile
    int r = rr;
    for (; r + B <= end; r += B) {
      float v[B];
#pragma unroll
      for (int k = 0; k < B; ++k) v[k] = __uint_as_float(uint32_t(col[(r + k) * 2 * STAGE_LD]) << 16);
#pragma unroll
      for (int k = 0; k < B; ++k) w.sum += v[k];
    }
    for (; r < end; ++r) w.sum += __uint_as_float(uint32_t(col[r * 2 * STAGE_LD]) << 16);
    w.left -= end - rr;
    rr = end;
    if (w.left == 0) {
      out[(long long)w.cur * g.ldo + e] = __float2bfloat16_rn(w.sum / float(g.HW));
      w.sum = 0.0f;
      w.left = g.HW;
      ++w.cur;
    }
  }
}

// grid (cdiv(E, 64 nwg), groups); 128 nwg + 32 threads. kEager: the ring
// holds fewer slots than C has chunks (conv_eager).
template <bool kEager>
__global__ void __launch_bounds__(288)
    conv_walk_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ cb,
                     bf16* __restrict__ out, const ConvGeo g) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* W = base + g.w_off;
  unsigned char* ring = base + g.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + g.bar_off);
  uint64_t* empty = full + g.stages;
  uint64_t* wbar = empty + g.stages;
  const int t = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, t / 128, 0);
  const int slice = blockIdx.x, e0 = slice * TN * g.nwg;
  const int img0 = blockIdx.y * g.gimg, img1 = min(g.N, img0 + g.gimg);
  if (img0 >= g.N) return;
  const int row0 = img0 * g.HW, row1 = img1 * g.HW;
  const int tiles = cdiv(row1 - row0, TM);
  if (t == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 128 * g.nwg);
    }
    hop::mbar_init(wbar, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  if (wg == g.nwg) {  // the producer warp
    if (t == 128 * g.nwg) {
      hop::mbar_arrive_expect_tx(wbar, g.nch * g.nwg * CHUNK_BYTES);
      for (int c = 0; c < g.nch; ++c)
        for (int b = 0; b < g.nwg; ++b)
          hop::tma_load_3d(W + (c * g.nwg + b) * CHUNK_BYTES, &wmap, wbar, e0 + TN * b, KCH * c,
                           0);
      uint32_t it = 0;
      for (int tile = 0; tile < tiles; ++tile)
        for (int c = 0; c < g.nch; ++c, ++it) {
          const uint32_t s = it % g.stages, k = it / g.stages;
          hop::mbar_wait(empty + s, (k & 1) ^ 1);
          hop::mbar_arrive_expect_tx(full + s, CHUNK_BYTES);
          hop::tma_load_3d(ring + s * CHUNK_BYTES, &xmap, full + s, KCH * c, row0 + TM * tile, 0);
        }
    }
    return;
  }
  // a consumer warpgroup: columns e0 + 64 wg .. + 63
  const int lt = t & 127, q = t & 3;
  const int ec = e0 + TN * wg;
  uint32_t bias[TN / 8];
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int e = ec + 8 * i + 2 * q;
    bias[i] = e < g.E ? *reinterpret_cast<const uint32_t*>(cb + e) : 0u;
  }
  uint32_t* stage = reinterpret_cast<uint32_t*>(base + g.stage_off) + wg * TM * STAGE_LD;
  const int my_e = ec + lt;  // this thread's column in the walk (lt < 64)
  const bool walker = lt < TN && my_e < g.E;
  Walk w{0.0f, img0, g.HW};
  float acc[TN / 2];
  uint32_t it = 0;  // chunks issued, in the producer's order
  hop::mbar_wait(wbar, 0);
  issue_tile<kEager>(g, ring, W, wg, full, empty, acc, it);
  // Tile t's products were issued in the last iteration; the next tile's
  // are issued before this tile's walk, so that they run on the tensor
  // cores meanwhile. The last tile is peeled off: every iteration of the
  // loop issues, so the accumulators are in flight on every path into its
  // wait (ptxas then injects no wait of its own).
  for (int tile = 0; tile + 1 < tiles; ++tile) {
    finish_tile<kEager>(g, empty, wg, tile, acc, bias, stage);
    issue_tile<kEager>(g, ring, W, wg, full, empty, acc, it);
    if (walker) walk_tile(g, stage, lt, min(TM, row1 - (row0 + TM * tile)), my_e, out, w);
  }
  finish_tile<kEager>(g, empty, wg, tiles - 1, acc, bias, stage);
  if (walker) walk_tile(g, stage, lt, min(TM, row1 - (row0 + TM * (tiles - 1))), my_e, out, w);
}

// ---- post matmul ---------------------------------------------------------------------

struct PostGeo {
  int N, K, M;      // rows, K (W's rows), W's columns (a multiple of 8)
  int ldo, m_out;   // out's row pitch and the columns stored
  int act, kparts, nch, ti, tj;
  int stages;       // ring slots (ops/head.post_plan)
};

__host__ __device__ inline PostGeo post_geo(int N, int K, int M, int ldo, int m_out, int act,
                                            int kparts, int stages) {
  PostGeo g{};
  g.N = N; g.K = K; g.M = M; g.ldo = ldo; g.m_out = m_out; g.act = act;
  g.kparts = kparts; g.nch = cdiv(K, KCH);
  g.ti = cdiv(N, TM); g.tj = cdiv(M, TN);
  g.stages = stages;
  return g;
}

// grid (tj, kparts, ti), cluster (1, kparts, 1); POST_THREADS threads.
__global__ void __launch_bounds__(POST_THREADS)
    post_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                bf16* __restrict__ out, const PostGeo g) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  float* red = reinterpret_cast<float*>(base + g.stages * 2 * CHUNK_BYTES);
  float* sbias = red + TM * RED_LD;
  uint64_t* full = reinterpret_cast<uint64_t*>(sbias + TN);
  uint64_t* empty = full + g.stages;
  const int t = threadIdx.x;
  const int j = blockIdx.x, part = blockIdx.y, i = blockIdx.z;
  const int c_begin = part * g.nch / g.kparts, c_end = (part + 1) * g.nch / g.kparts;
  if (t == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  if (warp == 4) {
    // the tile's bias, for the reduction (published by the cluster barrier)
    for (int c = t - 128; c < TN; c += 32)
      sbias[c] = TN * j + c < g.m_out ? __bfloat162float(bias[TN * j + c]) : 0.0f;
    if (t == 128) {
      uint32_t it = 0;
      for (int c = c_begin; c < c_end; ++c, ++it) {
        const uint32_t s = it % g.stages, k = it / g.stages;
        unsigned char* slot = base + s * 2 * CHUNK_BYTES;
        hop::mbar_wait(empty + s, (k & 1) ^ 1);
        hop::mbar_arrive_expect_tx(full + s, 2 * CHUNK_BYTES);
        hop::tma_load_3d(slot, &amap, full + s, KCH * c, TM * i, 0);
        hop::tma_load_3d(slot + CHUNK_BYTES, &wmap, full + s, TN * j, KCH * c, 0);
      }
    }
  } else {
    float acc[TN / 2];
#pragma unroll
    for (int x = 0; x < TN / 2; ++x) acc[x] = 0.0f;
    uint32_t it = 0, held = 0;
    for (int c = c_begin; c < c_end; ++c, ++it) {
      const uint32_t s = it % g.stages;
      hop::mbar_wait(full + s, (it / g.stages) & 1);
      const uint32_t a0 = hop::saddr(base + s * 2 * CHUNK_BYTES);
      const uint32_t b0 = a0 + CHUNK_BYTES;
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hop::Wgmma<TN>::mma(acc, hop::gmma_desc(a0 + 32 * k, 16, 1024, hop::kSwizzle128),
                            hop::gmma_desc(b0 + 2048 * k, CHUNK_BYTES, 1024, hop::kSwizzle128));
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > c_begin) hop::mbar_arrive(empty + held);
      held = s;
    }
    hop::wgmma_wait<0>();
    // the partial tile: rows 16 warp + lane / 4 (+ 8), columns 8x + 2q (+ 1)
    const int lane = t & 31, r = 16 * warp + (lane >> 2), q = lane & 3;
#pragma unroll
    for (int x = 0; x < TN / 8; ++x) {
      *reinterpret_cast<float2*>(red + r * RED_LD + 8 * x + 2 * q) =
          make_float2(acc[4 * x], acc[4 * x + 1]);
      *reinterpret_cast<float2*>(red + (r + 8) * RED_LD + 8 * x + 2 * q) =
          make_float2(acc[4 * x + 2], acc[4 * x + 3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's partial tile is written
  // this block's share of the tile's columns (groups of 4), over the parts'
  // partials in rank order, read together as 16-byte vectors
  const float* parts[MAX_KPARTS];
#pragma unroll
  for (int p = 0; p < MAX_KPARTS; ++p)
    parts[p] = cluster.map_shared_rank(red, p < g.kparts ? p : 0);
  const int g0 = part * (TN / 4) / g.kparts, ng = (part + 1) * (TN / 4) / g.kparts - g0;
  const int rows = min(TM, g.N - TM * i);
  for (int idx = t; idx < rows * ng; idx += POST_THREADS) {
    const int r = idx / ng, c4 = 4 * (g0 + idx - r * ng);
    float4 pv[MAX_KPARTS];
#pragma unroll
    for (int p = 0; p < MAX_KPARTS; ++p)
      if (p < g.kparts) pv[p] = *reinterpret_cast<const float4*>(parts[p] + r * RED_LD + c4);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < MAX_KPARTS; ++p)
      if (p < g.kparts) {
        v[0] += pv[p].x;
        v[1] += pv[p].y;
        v[2] += pv[p].z;
        v[3] += pv[p].w;
      }
    bf16* o = out + (long long)(TM * i + r) * g.ldo;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = TN * j + c4 + e;
      if (col < g.m_out) o[col] = __float2bfloat16_rn(act_named(v[e] + sbias[c4 + e], g.act));
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

// ---- host -------------------------------------------------------------------------------

// A map over a row-major (rows, cols) bf16 matrix: dims (cols, rows, 1),
// 64 x 64 boxes with the 128-byte swizzle; cols * 2 a multiple of 16.
inline cudaError_t make_map(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hop::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hd
}  // namespace mnk
