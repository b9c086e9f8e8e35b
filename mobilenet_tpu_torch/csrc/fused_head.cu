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
// float32 (below): IEEE float32 on the CUDA cores, as before.
//  - conv_pool_kernel (only with a conv_last): a block owns CB images and
//    128 of the E output channels (grid N/CB x E/128). Its pixels (CB*HW
//    rows) go through 64-row x 128-channel FMA products over K chunks of 32,
//    then bias, activation, rounding, and the per-image pool sums in pixel
//    order. The (N, H, W, E) conv_last output never reaches device memory;
//    the pooled (N, E) rows do.
//  - head_post_kernel: a block owns HB images; it pools its input (the
//    features, or the pooled rows as H*W = 1, where the mean is the value
//    itself) into shared memory, then runs each post matmul there, a thread
//    computing CPT output columns, one fmaf chain per output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "head_wgmma.cuh"
#include "numerics.cuh"

namespace {

constexpr int CONV_THREADS = 256;  // 16 x 16 threads over the 64 x 128 tile
constexpr int RT = 64;             // conv_last rows per tile
constexpr int CT = 128;            // conv_last channels per block
constexpr int KT = 32;             // conv_last K chunk
constexpr int LDA = KT + 8;
constexpr int LDB = CT + 8;
constexpr int LDC = CT + 4;
constexpr int MAX_CB = 16;         // images per conv_pool block
constexpr int HB = 2;              // images per head_post block
constexpr int POST_THREADS = 512;
constexpr int CPT = 2;             // output columns per thread and pass
constexpr int MAX_POST = 2;
constexpr int SMEM_MAX = 232448;

using mnk::kHswish;
using mnk::kLinear;
using mnk::kNone;

struct ConvSmem {
  static constexpr int A_BYTES = RT * LDA * 4;
  static constexpr int AB_BYTES = A_BYTES + KT * LDB * 4;
  static constexpr int C_BYTES = RT * LDC * 4;
  static constexpr int WORK_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static constexpr int BYTES = WORK_BYTES + MAX_CB * CT * 4;  // + pool sums
};
static_assert(ConvSmem::BYTES <= 48 * 1024, "conv_pool exceeds static smem");

// pooled[n][e] = mean_p act(x[n, p] . cw[:, e] + cb[e]), float32
__global__ void __launch_bounds__(CONV_THREADS)
    conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                     const float* __restrict__ cb, float* __restrict__ pooled, int N, int HW,
                     int C, int E, int CB, int conv_act) {
  using L = ConvSmem;
  using T = float;
  constexpr int VEC = 4;
  __shared__ __align__(128) unsigned char smem[L::BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  float* pool = reinterpret_cast<float*>(smem + L::WORK_BYTES);
  const int tid = threadIdx.x;
  const int img0 = blockIdx.x * CB;
  const int e0 = blockIdx.y * CT;
  const int rows = min(CB, N - img0) * HW;
  const T* xb = x + (long long)img0 * HW * C;  // the block's images are contiguous
  for (int i = tid; i < CB * CT; i += CONV_THREADS) pool[i] = 0.0f;
  for (int r0 = 0; r0 < rows; r0 += RT) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += KT) {
      __syncthreads();  // the previous chunk, or the previous tile's epilogue, is done
      // 16-byte vectors: C and E are multiples of 8, the tensors 16-byte
      // aligned (the wrapper checks), so a thread's loads are independent
      for (int idx = tid; idx < RT * (KT / VEC); idx += CONV_THREADS) {
        const int r = idx / (KT / VEC), k = (idx % (KT / VEC)) * VEC;
        *reinterpret_cast<uint4*>(As + r * LDA + k) =
            (r0 + r < rows && k0 + k < C)
                ? *reinterpret_cast<const uint4*>(xb + (long long)(r0 + r) * C + k0 + k)
                : make_uint4(0u, 0u, 0u, 0u);
      }
      for (int idx = tid; idx < KT * (CT / VEC); idx += CONV_THREADS) {
        const int k = idx / (CT / VEC), c = (idx % (CT / VEC)) * VEC;
        *reinterpret_cast<uint4*>(Bs + k * LDB + c) =
            (k0 + k < C && e0 + c < E)
                ? *reinterpret_cast<const uint4*>(cw + (long long)(k0 + k) * E + e0 + c)
                : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDA + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[k * LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every product done before Cs overwrites A/B
    {
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();
    // bias, activation, rounding, and the pool sums in pixel order
    if (tid < CT && e0 + tid < E) {
      const float bias = cb[e0 + tid];
      for (int r = 0; r < RT && r0 + r < rows; ++r)
        pool[((r0 + r) / HW) * CT + tid] += mnk::act_named(Cs[r * LDC + tid] + bias, conv_act);
    }
  }
  __syncthreads();
  for (int i = tid; i < CB * CT; i += CONV_THREADS) {
    const int bi = i / CT, c = i % CT;
    if (bi * HW < rows && e0 + c < E)
      pooled[(long long)(img0 + bi) * E + e0 + c] = pool[i] / float(HW);
  }
}

struct PostShape {
  int N, HW, C, n_post;
  int post_n[MAX_POST], post_act[MAX_POST];
  int maxw;  // widest row: C and every post width
};

// out[n] = post_{n_post-1}(... post_0(mean_p x[n, p])), float32
__global__ void __launch_bounds__(POST_THREADS)
    head_post_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ w1,
                     const float* __restrict__ b1, float* __restrict__ out, PostShape s) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hin = reinterpret_cast<float*>(smem);  // HB rows of maxw, twice
  float* hout = hin + HB * s.maxw;
  const int tid = threadIdx.x;
  const int img0 = blockIdx.x * HB;
  const int nb = min(HB, s.N - img0);
  for (int idx = tid; idx < HB * s.C; idx += POST_THREADS) {
    const int bi = idx / s.C, c = idx % s.C;
    float sum = 0.0f;
    if (bi < nb) {
      const T* px = x + ((long long)(img0 + bi) * s.HW) * s.C + c;
#pragma unroll 7
      for (int p = 0; p < s.HW; ++p) sum += px[(long long)p * s.C];
    }
    hin[bi * s.maxw + c] = sum / float(s.HW);
  }
  __syncthreads();
  int K = s.C;
  for (int j = 0; j < s.n_post; ++j) {
    const T* w = j == 0 ? w0 : w1;
    const T* b = j == 0 ? b0 : b1;
    const int cols = s.post_n[j];
    for (int col0 = 0; col0 < cols; col0 += POST_THREADS * CPT) {
      float acc[CPT][HB];
#pragma unroll
      for (int q = 0; q < CPT; ++q)
#pragma unroll
        for (int bi = 0; bi < HB; ++bi) acc[q][bi] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        float hv[HB];
#pragma unroll
        for (int bi = 0; bi < HB; ++bi) hv[bi] = hin[bi * s.maxw + k];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int col = col0 + tid + q * POST_THREADS;
          if (col < cols) {
            const float wv = w[(long long)k * cols + col];
#pragma unroll
            for (int bi = 0; bi < HB; ++bi) acc[q][bi] = fmaf(hv[bi], wv, acc[q][bi]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + tid + q * POST_THREADS;
        if (col >= cols) continue;
        const float bias = b[col];
#pragma unroll
        for (int bi = 0; bi < HB; ++bi)
          hout[bi * s.maxw + col] = mnk::act_named(acc[q][bi] + bias, s.post_act[j]);
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
    K = cols;
  }
  for (int idx = tid; idx < nb * K; idx += POST_THREADS) {
    const int bi = idx / K, c = idx % K;
    out[(long long)(img0 + bi) * K + c] = hin[bi * s.maxw + c];
  }
}

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

int launch_f32(const float* x, const float* cw, const float* cb, const float* w0,
               const float* b0, const float* w1, const float* b1, float* pooled, float* out,
               int N, int HW, int C, int E, int conv_act, int n_post, int n0, int act0, int n1,
               int act1, cudaStream_t st) {
  PostShape s;
  s.N = N; s.n_post = n_post;
  s.post_n[0] = n0; s.post_act[0] = act0;
  s.post_n[1] = n1; s.post_act[1] = act1;
  bool ok = N > 0 && HW > 0 && C > 0 && n_post >= 0 && n_post <= MAX_POST &&
            conv_act >= kNone && conv_act <= kHswish && (conv_act == kNone || E > 0);
  for (int j = 0; j < n_post; ++j)
    ok = ok && s.post_n[j] > 0 && s.post_act[j] >= kLinear && s.post_act[j] <= kHswish;
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* feat = x;
  s.HW = HW; s.C = C;
  if (conv_act != kNone) {
    const int cbn = HW >= RT ? 1 : (RT / HW < MAX_CB ? RT / HW : MAX_CB);
    dim3 grid((N + cbn - 1) / cbn, (E + CT - 1) / CT);
    conv_pool_kernel<<<grid, CONV_THREADS, 0, st>>>(x, cw, cb, pooled, N, HW, C, E, cbn,
                                                   conv_act);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    feat = pooled;  // the pooled rows: H*W = 1, the mean is the value
    s.HW = 1; s.C = E;
  }
  s.maxw = s.C;
  for (int j = 0; j < n_post; ++j) s.maxw = s.post_n[j] > s.maxw ? s.post_n[j] : s.maxw;
  const int smem = rup(2 * HB * s.maxw * 4, 128);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // the opt-in granted so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(head_post_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  head_post_kernel<<<(N + HB - 1) / HB, POST_THREADS, smem, st>>>(feat, w0, b0, w1, b1, out,
                                                                  s);
  return (int)cudaGetLastError();
}

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

int fused_head_f32(const void* x, const void* cw, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* pooled, void* out,
                   int N, int HW, int C, int E, int conv_act, int n_post, int n0, int act0,
                   int n1, int act1, void* stream) {
  using F = float;
  return launch_f32((const F*)x, (const F*)cw, (const F*)cb, (const F*)w0, (const F*)b0,
                    (const F*)w1, (const F*)b1, (F*)pooled, (F*)out, N, HW, C, E, conv_act,
                    n_post, n0, act0, n1, act1, (cudaStream_t)stream);
}

// Dynamic shared memory of the bf16 kernels (ops/head.head_smem_bytes):
// kind 0 conv_walk (C, nwg, stages), 1 post (stages).
int head_smem_bytes(int kind, int C, int nwg, int stages) {
  return kind == 0 ? hd::conv_smem_bytes(C, nwg, stages) : hd::post_smem_bytes(stages);
}

}  // extern "C"
