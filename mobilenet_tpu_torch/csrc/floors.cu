// Floor probes: what an H100 sustains for the work that the roofline model
// (mobilenet_tpu_torch/roofline.py) divides by, measured by
// `python -m mobilenet_tpu_torch.floors`.
//
// Replaces the TPU probes of mobilenet_tpu's tools/microbench_floors.py:
//   hbm_copy       <- hbm_copy_rate (:52): a copy of an NHWC batch, each
//                     image's bytes by its own blocks (the TPU kernel's grid
//                     over images), 16-byte loads and stores;
//   hbm_copy_flat  <- hbm_copy_rate_flat (:144): the same bytes as one flat
//                     buffer, a 16-byte vector a thread over a grid that
//                     covers the buffer;
//   stencil        <- vpu_stencil_rate (:116): REPS rounds of the 9
//                     multiply-adds of a depthwise tap set on every element
//                     (its channel's 9 weights, no spatial shift), then the
//                     epilogue min(s + 1, 127), on data held in registers:
//                     device memory is read once and written once, so the
//                     time is the FMA pipes'. The variants of the TPU kernel
//                     (_stencil_kernel :71-113): chain (one sum over the 9
//                     taps), ilp3 (three row sums, added last), const (the
//                     taps' weights as literals 1 + 0.001 t), bf16 (every
//                     product and sum rounded to bf16, no FMA), noepi (chain
//                     without the epilogue).
// What bounds them: the copies their bytes (read + write at 3.35 TB/s), the
// stencil its FMAs (the float32 CUDA-core peak, 67 TFLOP/s with an FMA as two
// operations). Their designs do nothing but that work: full 16-byte vectors,
// enough blocks in flight to cover the memory latency, and for the stencil
// one element a thread with its weights in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "numerics.cuh"

namespace {

using mnk::from_f;
using mnk::to_f;

constexpr int THREADS = 256;
enum Variant { kChain = 0, kIlp3 = 1, kConst = 2, kBf16 = 3, kNoepi = 4 };

__global__ void copy_images(const uint4* __restrict__ x, uint4* __restrict__ out,
                            long long vec_per_image) {
  const long long base = (long long)blockIdx.y * vec_per_image;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < vec_per_image;
       i += (long long)gridDim.x * THREADS)
    out[base + i] = x[base + i];
}

// hbm_copy_flat: one 16-byte vector a thread, FLAT_THREADS threads a block on
// consecutive vectors, a block for every FLAT_THREADS vectors (no loop, no
// occupancy query: the host work of a launch stays at one call). Timed against
// a single wave of blocks holding four streaming loads in flight a thread, and
// against bulk copies through a shared-memory ring, it moved the same bytes
// faster.
constexpr int FLAT_THREADS = 512;

__global__ void __launch_bounds__(FLAT_THREADS)
    copy_flat(const uint4* __restrict__ x, uint4* __restrict__ out, long long vecs) {
  const long long i = (long long)blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (i < vecs) out[i] = x[i];
}

__device__ __forceinline__ float bf(float v) { return to_f(from_f<__nv_bfloat16>(v)); }

template <int V>
__global__ void stencil_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ w,
                               __nv_bfloat16* __restrict__ out, long long elems, int C,
                               int reps) {
  // the const variant's weights: float32 of the double 1 + 0.001 t, as the
  // TPU kernel's acc.dtype.type(1.0 + 0.001 * t) rounds them
  constexpr float kc[9] = {
      (float)(1.0 + 0.001 * 0), (float)(1.0 + 0.001 * 1), (float)(1.0 + 0.001 * 2),
      (float)(1.0 + 0.001 * 3), (float)(1.0 + 0.001 * 4), (float)(1.0 + 0.001 * 5),
      (float)(1.0 + 0.001 * 6), (float)(1.0 + 0.001 * 7), (float)(1.0 + 0.001 * 8)};
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < elems;
       i += (long long)gridDim.x * THREADS) {
    const int c = (int)(i % C);
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = to_f(w[t * C + c]);
    float acc = to_f(x[i]);
    for (int r = 0; r < reps; ++r) {
      float s;
      if constexpr (V == kIlp3) {
        float row[3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float a = acc * wt[dy * 3];
          a = fmaf(acc, wt[dy * 3 + 1], a);
          row[dy] = fmaf(acc, wt[dy * 3 + 2], a);
        }
        s = (row[0] + row[1]) + row[2];
      } else if constexpr (V == kBf16) {  // every product and sum rounded
        s = 0.0f;
#pragma unroll
        for (int t = 0; t < 9; ++t) s = bf(__fadd_rn(s, bf(__fmul_rn(acc, wt[t]))));
      } else {
        s = 0.0f;
#pragma unroll
        for (int t = 0; t < 9; ++t) s = fmaf(acc, V == kConst ? kc[t] : wt[t], s);
      }
      if constexpr (V == kNoepi)
        acc = s;
      else if constexpr (V == kBf16)
        acc = fminf(bf(__fadd_rn(s, 1.0f)), 127.0f);
      else
        acc = fminf(s + 1.0f, 127.0f);
    }
    out[i] = from_f<__nv_bfloat16>(acc);
  }
}

int grid_for(long long work) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * 16;  // persistent: 16 blocks an SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// N images of bytes_per_image bytes each (a multiple of 16), 16-byte aligned.
int hbm_copy(const void* x, void* out, int N, long long bytes_per_image, void* stream) {
  if (N <= 0 || N > 65535 || bytes_per_image <= 0 || bytes_per_image % 16)
    return (int)cudaErrorInvalidValue;
  const long long vec = bytes_per_image / 16;
  long long bx = (vec + THREADS - 1) / THREADS;
  bx = bx < 4096 ? bx : 4096;
  copy_images<<<dim3((unsigned)bx, (unsigned)N), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, vec);
  return (int)cudaGetLastError();
}

// bytes a multiple of 16, both 16-byte aligned.
int hbm_copy_flat(const void* x, void* out, long long bytes, void* stream) {
  if (bytes <= 0 || bytes % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = bytes / 16, grid = (vecs + FLAT_THREADS - 1) / FLAT_THREADS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_flat<<<(unsigned)grid, FLAT_THREADS, 0, (cudaStream_t)stream>>>((const uint4*)x,
                                                                        (uint4*)out, vecs);
  return (int)cudaGetLastError();
}

// x, out: elems bf16 values, channels last (C of them); w: (3, 3, C) bf16.
int stencil(const void* x, const void* w, void* out, long long elems, int C, int reps,
            int variant, void* stream) {
  if (elems <= 0 || C <= 0 || elems % C || reps < 0) return (int)cudaErrorInvalidValue;
  const int g = grid_for(elems);
  if (g < 0) return (int)cudaErrorInvalidDevice;
  const auto* xp = (const __nv_bfloat16*)x;
  const auto* wp = (const __nv_bfloat16*)w;
  auto* op = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kChain: stencil_kernel<kChain><<<g, THREADS, 0, s>>>(xp, wp, op, elems, C, reps); break;
    case kIlp3: stencil_kernel<kIlp3><<<g, THREADS, 0, s>>>(xp, wp, op, elems, C, reps); break;
    case kConst: stencil_kernel<kConst><<<g, THREADS, 0, s>>>(xp, wp, op, elems, C, reps); break;
    case kBf16: stencil_kernel<kBf16><<<g, THREADS, 0, s>>>(xp, wp, op, elems, C, reps); break;
    case kNoepi: stencil_kernel<kNoepi><<<g, THREADS, 0, s>>>(xp, wp, op, elems, C, reps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
