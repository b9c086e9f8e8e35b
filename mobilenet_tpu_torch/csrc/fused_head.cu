// Fused classifier head:
//   [conv_last 1x1 + act] -> global average pool -> 0-2 matmuls, each + act.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_head.py fused_head (:168)
// in all its forms: V1 (pool -> fc), V2 (conv_last + ReLU6 -> pool -> fc) and
// V3-Large (conv_last + hswish -> pool -> head matmul + hswish -> fc).
// Activations: linear, relu, relu6, hswish = y * (clip(y + 3, 0, 6) / 6),
// written as in pallas_head.py:36-44. Cast points follow pallas_head.py:60-78:
// the conv_last product accumulates in f32, adds its bias in f32, applies its
// activation and rounds to the activation dtype; the pool is an f32 mean
// over H*W rounded to the activation dtype; each post matmul accumulates in
// f32, adds its bias in f32, applies its activation and rounds.
//
// Design: two kernels behind one entry point.
//  - conv_pool_kernel (only with a conv_last): a block owns CB images and
//    128 of the E output channels, so that the grid is N/CB x E/128 blocks
//    (2,560 at V2 1.0-224 batch 256, 10 at batch 1). Its pixels (CB*HW rows)
//    go through 64-row x 128-channel products over K chunks of 32 (bf16:
//    WMMA 16x16x16 on the tensor cores; float32: FMA on the CUDA cores, exact
//    float32), then bias, activation, rounding, and the per-image pool sums
//    in pixel order. The (N, H, W, E) conv_last output never reaches device
//    memory; the pooled (N, E) rows do, rounded to the activation dtype.
//  - head_post_kernel: a block owns HB images; it pools its input (the
//    features, or the pooled rows as H*W = 1, where the mean is the value
//    itself) into shared memory, then runs each post matmul there, a thread
//    computing CPT output columns with weight reads coalesced along columns
//    (from L2: every block reads every post weight). V1's pool+fc runs only
//    this kernel, with the arithmetic, in the same order, of the pool+fc
//    kernel it extends (sequential f32 pool sums, one fmaf chain per
//    output).
//
// What bounds it on an H100: V2 1.0-224 at batch 256 reads 4.0 MB of bf16
// features and 3.4 MB of weights and does 10.3 GFLOP in conv_last plus 0.7
// in the fc: a few microseconds at either peak; the kernels' own latency (a
// synchronous tile loop, no load pipelining) is what their time measures.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "numerics.cuh"

namespace {

using mnk::from_f;
using mnk::to_f;

constexpr int CONV_THREADS = 256;  // 8 warps, 2 x 4 over the 64 x 128 tile
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

template <typename T> struct ConvSmem {
  static constexpr int A_BYTES = RT * LDA * int(sizeof(T));
  static constexpr int AB_BYTES = A_BYTES + KT * LDB * int(sizeof(T));
  static constexpr int C_BYTES = RT * LDC * 4;
  static constexpr int WORK_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static constexpr int BYTES = WORK_BYTES + MAX_CB * CT * 4;  // + pool sums
};
static_assert(ConvSmem<float>::BYTES <= 48 * 1024, "conv_pool exceeds static smem");

// pooled[n][e] = round(mean_p round(act(x[n, p] . cw[:, e] + cb[e])))
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
    conv_pool_kernel(const T* __restrict__ x, const T* __restrict__ cw,
                     const T* __restrict__ cb, T* __restrict__ pooled, int N, int HW,
                     int C, int E, int CB, int conv_act) {
  using L = ConvSmem<T>;
  constexpr int VEC = 16 / int(sizeof(T));
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
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[2][2];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(cf[i][j], 0.0f);
    }
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
      if constexpr (std::is_same<T, float>::value) {
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
      } else {
        using namespace nvcuda;
        const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bf[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
        }
      }
    }
    __syncthreads();  // every product done before Cs overwrites A/B
    if constexpr (std::is_same<T, float>::value) {
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
    } else {
      using namespace nvcuda;
      const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, cf[i][j],
                                  LDC, wmma::mem_row_major);
    }
    __syncthreads();
    // bias, activation, rounding, and the pool sums in pixel order
    if (tid < CT && e0 + tid < E) {
      const float bias = to_f(cb[e0 + tid]);
      for (int r = 0; r < RT && r0 + r < rows; ++r)
        pool[((r0 + r) / HW) * CT + tid] +=
            to_f(from_f<T>(mnk::act_named(Cs[r * LDC + tid] + bias, conv_act)));
    }
  }
  __syncthreads();
  for (int i = tid; i < CB * CT; i += CONV_THREADS) {
    const int bi = i / CT, c = i % CT;
    if (bi * HW < rows && e0 + c < E)
      pooled[(long long)(img0 + bi) * E + e0 + c] = from_f<T>(pool[i] / float(HW));
  }
}

struct PostShape {
  int N, HW, C, n_post;
  int post_n[MAX_POST], post_act[MAX_POST];
  int maxw;  // widest row: C and every post width
};

// out[n] = post_{n_post-1}(... post_0(round(mean_p x[n, p])))
template <typename T>
__global__ void __launch_bounds__(POST_THREADS)
    head_post_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                     const T* __restrict__ b0, const T* __restrict__ w1,
                     const T* __restrict__ b1, T* __restrict__ out, PostShape s) {
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
      for (int p = 0; p < s.HW; ++p) sum += to_f(px[(long long)p * s.C]);
    }
    hin[bi * s.maxw + c] = to_f(from_f<T>(sum / float(s.HW)));
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
            const float wv = to_f(w[(long long)k * cols + col]);
#pragma unroll
            for (int bi = 0; bi < HB; ++bi) acc[q][bi] = fmaf(hv[bi], wv, acc[q][bi]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + tid + q * POST_THREADS;
        if (col >= cols) continue;
        const float bias = to_f(b[col]);
#pragma unroll
        for (int bi = 0; bi < HB; ++bi)
          hout[bi * s.maxw + col] =
              to_f(from_f<T>(mnk::act_named(acc[q][bi] + bias, s.post_act[j])));
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
    out[(long long)(img0 + bi) * K + c] = from_f<T>(hin[bi * s.maxw + c]);
  }
}

__host__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
int launch(const void* x, const void* cw, const void* cb, const void* w0, const void* b0,
           const void* w1, const void* b1, void* pooled, void* out, int N, int HW, int C,
           int E, int conv_act, int n_post, int n0, int act0, int n1, int act1,
           void* stream) {
  PostShape s;
  s.N = N; s.n_post = n_post;
  s.post_n[0] = n0; s.post_act[0] = act0;
  s.post_n[1] = n1; s.post_act[1] = act1;
  bool ok = N > 0 && HW > 0 && C > 0 && n_post >= 0 && n_post <= MAX_POST &&
            conv_act >= kNone && conv_act <= kHswish && (conv_act == kNone || E > 0);
  for (int j = 0; j < n_post; ++j)
    ok = ok && s.post_n[j] > 0 && s.post_act[j] >= kLinear && s.post_act[j] <= kHswish;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* feat = x;
  s.HW = HW; s.C = C;
  if (conv_act != kNone) {
    const int cbn = HW >= RT ? 1 : (RT / HW < MAX_CB ? RT / HW : MAX_CB);
    dim3 grid((N + cbn - 1) / cbn, (E + CT - 1) / CT);
    conv_pool_kernel<T><<<grid, CONV_THREADS, 0, st>>>((const T*)x, (const T*)cw,
                                                       (const T*)cb, (T*)pooled, N, HW, C, E,
                                                       cbn, conv_act);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    feat = pooled;  // the pooled rows: H*W = 1, the mean is the value
    s.HW = 1; s.C = E;
  }
  s.maxw = s.C;
  for (int j = 0; j < n_post; ++j) s.maxw = s.post_n[j] > s.maxw ? s.post_n[j] : s.maxw;
  const int smem = rup(2 * HB * s.maxw * 4, 128);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // per instantiation: the opt-in granted so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(head_post_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set = SMEM_MAX;
  }
  head_post_kernel<T><<<(N + HB - 1) / HB, POST_THREADS, smem, st>>>(
      (const T*)feat, (const T*)w0, (const T*)b0, (const T*)w1, (const T*)b1, (T*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_head_bf16(const void* x, const void* cw, const void* cb, const void* w0,
                    const void* b0, const void* w1, const void* b1, void* pooled, void* out,
                    int N, int HW, int C, int E, int conv_act, int n_post, int n0, int act0,
                    int n1, int act1, void* stream) {
  return launch<__nv_bfloat16>(x, cw, cb, w0, b0, w1, b1, pooled, out, N, HW, C, E, conv_act,
                               n_post, n0, act0, n1, act1, stream);
}

int fused_head_f32(const void* x, const void* cw, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* pooled, void* out,
                   int N, int HW, int C, int E, int conv_act, int n_post, int n0, int act0,
                   int n1, int act1, void* stream) {
  return launch<float>(x, cw, cb, w0, b0, w1, b1, pooled, out, N, HW, C, E, conv_act, n_post,
                       n0, act0, n1, act1, stream);
}

}  // extern "C"
