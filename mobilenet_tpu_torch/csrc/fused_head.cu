// Fused classifier head:
//   [conv_last 1x1 + act] -> global average pool -> 0-2 matmuls, each + act.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_head.py fused_head (:168)
// in all its forms: V1 (pool -> fc), V2 (conv_last + ReLU6 -> pool -> fc) and
// V3-Large and -Small (conv_last + hswish -> pool -> head matmul + hswish ->
// fc). Activations: linear, relu, relu6, hswish = y * (clip(y + 3, 0, 6) /
// 6), written as in pallas_head.py:36-44. Cast points follow
// pallas_head.py:60-78: the conv_last product accumulates in f32, adds its
// bias in f32, applies its activation and rounds to the activation dtype;
// the pool is an f32 mean over H*W rounded to the activation dtype; each
// post matmul accumulates in f32, adds its bias in f32, applies its
// activation and rounds.
//
// What bounds it on an H100, bf16 1.0-224. Batch 256: V1 reads 25.7 MB of
// features (7.7 us at 3.35 TB/s: bytes bound); V2's conv_last is 10.3 GFLOP
// (10.4 us at 989 TFLOP/s), V3-L's 3.9 and V3-S's 1.4, on 4.0, 2.0 and 1.2
// MB of features. Batch 1: the post weights read once (V1 2 MB, 0.6 us;
// V3-L 5 MB, 1.5 us). The old design ran each post matmul as fmaf chains of
// a block of two images over every weight (a whole fc on one SM at batch
// 1, 128 copies of the weight through L2 at batch 256) and conv_last as
// WMMA tiles with synchronous loads, one image (49 of 64 rows) a block.
//
// bf16 (head_wgmma.cuh), one launch a stage: V1 pool + post (2 launches),
// V2 conv_walk + post (2), V3 conv_walk + post + post (3).
//  - pool_kernel: 16-byte loads of a 64-pixel x 64-channel slab, all in
//    flight, then f32 sums in pixel order.
//  - conv_walk_kernel: the weight's column slice resident, pixel tiles of 64
//    rows across image boundaries on wgmma, pooled by image segment in pixel
//    order; grid = column slices x image groups (one wave). A ring of fewer
//    slots than C's 64-channel chunks (C above 832; 513-704 from batch 16)
//    frees each chunk's slot as its products finish (conv_walk_kernel<true>).
//    C above 1600 raises: one warpgroup's weight slice does not fit.
//  - post_kernel: wgmma on 64 x 64 output tiles over TMA rings, the weight
//    read once per 64-row tile; K split over a thread-block cluster of up to
//    8 blocks, reduced through distributed shared memory in rank order, so
//    that batch 1-8 puts >= 128 blocks on the card.
// The tensor cores sum in another order than the fmaf chains of the plain
// version: a bf16 output may round one step apart.
//
// float32 (head_f32.cuh), the same stages on the CUDA cores, one launch a
// stage: V1 pool + post (2 launches), V2 conv_walk + post (2), V3 conv_walk
// + post + post (3). IEEE float32 (fmaf, no tensor core).
//  - pool_f32_kernel: 16-byte loads of a 64-pixel x 64-channel slab, then
//    f32 sums in pixel order.
//  - conv_walk_f32_kernel<128, 128>: 128-row pixel tiles across image
//    boundaries x a 128-column slice of E, where those tiles fill half the
//    card; fmaf micro-tiles over a cp.async ring of K chunks, pooled by
//    image in pixel order; any C.
//  - post_f32_kernel: 64 x 64 output tiles, the weight read once per 64-row
//    tile, K split over a thread-block cluster of up to 8 blocks reduced in
//    rank order.
//  - narrow_f32_kernel<POOL>: at a small batch, both matmuls (the conv_last
//    walk with POOL) 8 columns a block with the whole of K, its slices
//    summed in order in shared memory: many blocks and no cluster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "head_f32.cuh"
#include "head_wgmma.cuh"
#include "numerics.cuh"

namespace {

constexpr int MAX_POST = 2;

using mnk::kHswish;
using mnk::kLinear;
using mnk::kNone;

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

// ---- bf16 (head_wgmma.cuh) ------------------------------------------------------------

namespace hd = mnk::hd;

// Raises a kernel's dynamic shared-memory limit once.
template <class K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       hd::SMEM_LIMIT);
  done = e == cudaSuccess;
  return e;
}

// One post matmul: A (N, lda) -> out (N, ldo), columns < m_out stored.
cudaError_t launch_post(const void* a, int lda, const void* w, const void* b, void* out,
                        const hd::PostGeo& g, cudaStream_t st) {
  CUtensorMap amap, wmap;
  cudaError_t e = hd::make_map(&amap, a, g.N, lda);
  if (e == cudaSuccess) e = hd::make_map(&wmap, w, g.K, g.M);
  static bool smem_done = false;
  if (e == cudaSuccess) e = allow_smem(hd::post_kernel, smem_done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tj, g.kparts, g.ti);
  cfg.blockDim = dim3(hd::POST_THREADS);
  cfg.dynamicSmemBytes = hd::post_smem_bytes(g.stages);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = g.kparts;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hd::post_kernel, amap, wmap,
                            static_cast<const hd::bf16*>(b), static_cast<hd::bf16*>(out), g);
}

// The plan's checks (ops/head.head_plan never breaks them): widths the TMA
// maps take, parts and groups in range, shared memory within the limit.
bool bf16_ok(int N, int HW, int C, int E, int conv_act, int n_post, int m0, int act0, int m1,
             int act1, int m_out, int conv_nwg, int conv_groups, int conv_stages, int kp0,
             int kp1, int st0, int st1) {
  bool ok = N > 0 && HW > 0 && C > 0 && n_post >= 0 && n_post <= MAX_POST &&
            conv_act >= kNone && conv_act <= kHswish && m_out > 0;
  if (conv_act != kNone)
    ok = ok && C % 8 == 0 && E > 0 && E % 8 == 0 && (conv_nwg == 1 || conv_nwg == 2) &&
         conv_groups >= 1 && conv_groups <= N && conv_stages >= 2 &&
         conv_stages <= hd::MAX_CONV_STAGES &&
         hd::conv_smem_bytes(C, conv_nwg, conv_stages) <= hd::SMEM_LIMIT;
  const int ms[2] = {m0, m1}, acts[2] = {act0, act1}, kps[2] = {kp0, kp1}, sts[2] = {st0, st1};
  for (int j = 0; j < n_post; ++j)
    ok = ok && ms[j] > 0 && ms[j] % 8 == 0 && acts[j] >= kLinear && acts[j] <= kHswish &&
         kps[j] >= 1 && kps[j] <= hd::MAX_KPARTS && sts[j] >= 1 &&
         sts[j] <= hd::MAX_POST_STAGES;
  const int last = n_post == 0 ? (conv_act != kNone ? E : C) : ms[n_post - 1];
  return ok && m_out <= last;
}

int launch_bf16(const hd::bf16* x, const hd::bf16* cw, const hd::bf16* cb, const hd::bf16* w0,
                const hd::bf16* b0, const hd::bf16* w1, const hd::bf16* b1, hd::bf16* pooled,
                hd::bf16* mid, hd::bf16* out, int N, int HW, int C, int E, int conv_act,
                int n_post, int m0, int act0, int m1, int act1, int m_out, int conv_nwg,
                int conv_groups, int conv_stages, int kp0, int kp1, int st0, int st1,
                cudaStream_t st) {
  if (!bf16_ok(N, HW, C, E, conv_act, n_post, m0, act0, m1, act1, m_out, conv_nwg,
               conv_groups, conv_stages, kp0, kp1, st0, st1))
    return (int)cudaErrorInvalidValue;
  // the pooled rows: width k (the post's K), pitch ld (a multiple of 8)
  hd::bf16* feat = n_post == 0 ? out : pooled;
  int k, ld;
  if (conv_act != kNone) {
    k = ld = E;
    const hd::ConvGeo g =
        hd::conv_geo(N, HW, C, E, conv_act, conv_nwg, conv_groups, conv_stages, ld);
    CUtensorMap xmap, wmap;
    cudaError_t e = hd::make_map(&xmap, x, N * HW, C);
    if (e == cudaSuccess) e = hd::make_map(&wmap, cw, C, E);
    static bool smem_done[2] = {false, false};
    const dim3 grid(hd::cdiv(E, hd::TN * conv_nwg), conv_groups);
    const int threads = 128 * conv_nwg + 32;
    if (hd::conv_eager(C, conv_stages)) {
      if (e == cudaSuccess) e = allow_smem(hd::conv_walk_kernel<true>, smem_done[1]);
      if (e != cudaSuccess) return (int)e;
      hd::conv_walk_kernel<true><<<grid, threads, g.smem, st>>>(xmap, wmap, cb, feat, g);
    } else {
      if (e == cudaSuccess) e = allow_smem(hd::conv_walk_kernel<false>, smem_done[0]);
      if (e != cudaSuccess) return (int)e;
      hd::conv_walk_kernel<false><<<grid, threads, g.smem, st>>>(xmap, wmap, cb, feat, g);
    }
  } else {
    k = C;
    ld = n_post == 0 ? C : rup(C, 8);
    const int vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    hd::pool_kernel<<<dim3(hd::cdiv(ld, hd::POOL_CH), N), hd::POOL_THREADS, 0, st>>>(
        x, feat, HW, C, ld, ld, vec);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_post == 0) return (int)e;
  const bool one = n_post == 1;
  e = launch_post(feat, ld, w0, b0, one ? out : mid,
                  hd::post_geo(N, k, m0, one ? m_out : m0, one ? m_out : m0, act0, kp0, st0), st);
  if (e != cudaSuccess || one) return (int)e;
  return (int)launch_post(mid, m0, w1, b1, out,
                          hd::post_geo(N, m0, m1, m_out, m_out, act1, kp1, st1), st);
}

// ---- float32 (head_f32.cuh) --------------------------------------------------------

namespace hf = mnk::hf;

// One post matmul: A (N, lda) -> out (N, ldo), columns < m_out stored;
// narrow_f32_kernel<false> up to hf::SMALL_N rows, else post_f32_kernel.
cudaError_t launch_post_f32(const float* a, const float* w, const float* b, float* out,
                            const hf::PostGeo& g, cudaStream_t st) {
  cudaError_t e;
  if (g.N <= hf::SMALL_N) {
    static bool done = false;
    if ((e = allow_smem(hf::narrow_f32_kernel<false, 8>, done)) != cudaSuccess) return e;
    hf::narrow_f32_kernel<false, 8><<<hf::cdiv(g.M, 8), hf::THREADS,
                                      hf::narrow_smem_bytes(false, 8), st>>>(a, w, b, out, g, 1);
    return cudaGetLastError();
  }
  static bool smem_done = false;
  if ((e = allow_smem(hf::post_f32_kernel, smem_done)) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tj, g.kparts, g.ti);
  cfg.blockDim = dim3(hf::THREADS);
  cfg.dynamicSmemBytes = hf::post_smem_bytes();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = g.kparts;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hf::post_f32_kernel, a, w, b, out, g);
}

// The plan's checks (ops/head.f32_head_plan never breaks them).
bool f32_ok(int N, int HW, int C, int E, int conv_act, int n_post, int m0, int act0, int m1,
            int act1, int m_out, int conv_bm, int conv_groups, int kp0, int kp1) {
  bool ok = N > 0 && HW > 0 && C > 0 && n_post >= 0 && n_post <= MAX_POST &&
            conv_act >= kNone && conv_act <= kHswish && m_out > 0;
  if (conv_act != kNone)  // conv_bm 128: conv_walk on conv_groups image groups; 8, 16: narrow
    ok = ok && C % 4 == 0 && E > 0 && E % 4 == 0 &&
         ((conv_bm == 128 && conv_groups >= 1 && conv_groups <= N) ||
          ((conv_bm == 8 || conv_bm == 16) && conv_groups == 1));
  const int ms[2] = {m0, m1}, acts[2] = {act0, act1}, kps[2] = {kp0, kp1};
  for (int j = 0; j < n_post; ++j)
    ok = ok && ms[j] > 0 && ms[j] % 4 == 0 && acts[j] >= kLinear && acts[j] <= kHswish &&
         kps[j] >= 1 && kps[j] <= hf::MAX_KPARTS;
  const int last = n_post == 0 ? (conv_act != kNone ? E : C) : ms[n_post - 1];
  return ok && m_out <= last;
}

int launch_f32(const float* x, const float* cw, const float* cb, const float* w0,
               const float* b0, const float* w1, const float* b1, float* pooled, float* mid,
               float* out, int N, int HW, int C, int E, int conv_act, int n_post, int m0,
               int act0, int m1, int act1, int m_out, int conv_bm, int conv_groups, int kp0,
               int kp1, cudaStream_t st) {
  if (!f32_ok(N, HW, C, E, conv_act, n_post, m0, act0, m1, act1, m_out, conv_bm, conv_groups,
              kp0, kp1))
    return (int)cudaErrorInvalidValue;
  float* feat = n_post == 0 ? out : pooled;  // the pooled rows: width k, pitch ld
  int k, ld;
  cudaError_t e = cudaSuccess;
  if (conv_act != kNone) {
    k = ld = E;
    if (conv_bm == 128) {
      static bool done = false;
      if ((e = allow_smem(hf::conv_walk_f32_kernel<128, 128>, done)) != cudaSuccess) return (int)e;
      const hf::ConvGeo g{N, HW, C, E, conv_act, conv_groups, hf::cdiv(N, conv_groups), ld};
      hf::conv_walk_f32_kernel<128, 128><<<dim3(hf::cdiv(E, 128), conv_groups), hf::THREADS,
                                           hf::conv_smem_bytes(), st>>>(x, cw, cb, feat, g);
    } else {  // a small batch: every image's pixel rows, conv_bm columns of E a block
      static bool done[2] = {false, false};
      const hf::PostGeo pg = hf::post_geo(N, C, E, C, ld, E, conv_act, 1);
      if (conv_bm == 16) {
        if ((e = allow_smem(hf::narrow_f32_kernel<true, 16>, done[1])) != cudaSuccess)
          return (int)e;
        hf::narrow_f32_kernel<true, 16><<<hf::cdiv(E, 16), hf::THREADS,
                                          hf::narrow_smem_bytes(true, 16), st>>>(x, cw, cb, feat,
                                                                                  pg, HW);
      } else {
        if ((e = allow_smem(hf::narrow_f32_kernel<true, 8>, done[0])) != cudaSuccess)
          return (int)e;
        hf::narrow_f32_kernel<true, 8><<<hf::cdiv(E, 8), hf::THREADS,
                                         hf::narrow_smem_bytes(true, 8), st>>>(x, cw, cb, feat,
                                                                                pg, HW);
      }
    }
  } else {
    k = C;
    ld = n_post == 0 ? C : rup(C, 8);
    const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    hf::pool_f32_kernel<<<dim3(hf::cdiv(ld, hf::POOL_CH), N), hf::POOL_THREADS, 0, st>>>(
        x, feat, HW, C, ld, ld, vec);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || n_post == 0) return (int)e;
  const bool one = n_post == 1;
  e = launch_post_f32(feat, w0, b0, one ? out : mid,
                      hf::post_geo(N, k, m0, ld, one ? m_out : m0, one ? m_out : m0, act0, kp0),
                      st);
  if (e != cudaSuccess || one) return (int)e;
  return (int)launch_post_f32(mid, w1, b1, out,
                              hf::post_geo(N, m0, m1, m0, m_out, m_out, act1, kp1), st);
}

}  // namespace

extern "C" {

// x, conv_w, conv_b, w0, b0, w1, b1 (w1: m0 rows), pooled (N, E or C rounded
// up to 8), mid (N, m0) | N, HW, C, E, conv_act (-1: none), n_post, m0, act0,
// m1, act1 (m0, m1: the weights' widths, multiples of 8), m_out (the output's
// width and pitch), conv_nwg, conv_groups, conv_stages, kparts0, kparts1,
// stages0, stages1 (ops/head.head_plan)
int fused_head_bf16(const void* x, const void* cw, const void* cb, const void* w0,
                    const void* b0, const void* w1, const void* b1, void* pooled, void* mid,
                    void* out, int N, int HW, int C, int E, int conv_act, int n_post, int m0,
                    int act0, int m1, int act1, int m_out, int conv_nwg, int conv_groups,
                    int conv_stages, int kp0, int kp1, int st0, int st1, void* stream) {
  using B = hd::bf16;
  return launch_bf16((const B*)x, (const B*)cw, (const B*)cb, (const B*)w0, (const B*)b0,
                     (const B*)w1, (const B*)b1, (B*)pooled, (B*)mid, (B*)out, N, HW, C, E,
                     conv_act, n_post, m0, act0, m1, act1, m_out, conv_nwg, conv_groups,
                     conv_stages, kp0, kp1, st0, st1, (cudaStream_t)stream);
}

// The same arguments as fused_head_bf16 in float32, then conv_bm (128:
// conv_walk; 8 or 16: narrow's columns a block), conv_groups (conv_walk's
// image groups), kparts0, kparts1 (post_f32_kernel's K parts; 1 at N <= 16,
// narrow) (ops/head.f32_head_plan); m0, m1: multiples of 4.
int fused_head_f32(const void* x, const void* cw, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* pooled, void* mid,
                   void* out, int N, int HW, int C, int E, int conv_act, int n_post, int m0,
                   int act0, int m1, int act1, int m_out, int conv_bm, int conv_groups, int kp0,
                   int kp1, void* stream) {
  using F = const float*;
  return launch_f32((F)x, (F)cw, (F)cb, (F)w0, (F)b0, (F)w1, (F)b1, (float*)pooled, (float*)mid,
                    (float*)out, N, HW, C, E, conv_act, n_post, m0, act0, m1, act1, m_out,
                    conv_bm, conv_groups, kp0, kp1, (cudaStream_t)stream);
}

// Dynamic shared memory of the float32 kernels (ops/head.f32_head_smem_bytes):
// kind 0 conv_walk, 1 post, 2 narrow (pool: its POOL form; nc: columns a block).
int head_f32_smem_bytes(int kind, int pool, int nc) {
  return kind == 0 ? hf::conv_smem_bytes()
                   : kind == 1 ? hf::post_smem_bytes() : hf::narrow_smem_bytes(pool != 0, nc);
}

// Dynamic shared memory of the bf16 kernels (ops/head.head_smem_bytes):
// kind 0 conv_walk (C, nwg, stages), 1 post (stages).
int head_smem_bytes(int kind, int C, int nwg, int stages) {
  return kind == 0 ? hd::conv_smem_bytes(C, nwg, stages) : hd::post_smem_bytes(stages);
}

}  // extern "C"
