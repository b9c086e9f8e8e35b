// Floor probes: what an H100 sustains for the work that the roofline model
// (mobilenet_tpu_torch/roofline.py) divides by, measured by
// `python -m mobilenet_tpu_torch.floors`.
//
// Replaces the TPU probes of mobilenet_tpu's tools/microbench_floors.py:
//   hbm_copy       <- hbm_copy_rate (:52): a copy of an NHWC batch, each
//                     image's bytes (the TPU kernel's grid over images). An
//                     image's bytes are contiguous in the batch, so this is
//                     copy_flat over the batch's bytes: no cap on the batch,
//                     and no half-idle last block an image;
//   hbm_copy_flat  <- hbm_copy_rate_flat (:144): the same bytes as one flat
//                     buffer, a 16-byte vector a thread over a grid that
//                     covers the buffer (copy_flat);
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
// operations). The copies: full 16-byte vectors and enough blocks in flight
// to cover the memory latency. The stencil issues nothing but its arithmetic
// (below, stencil_kernel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
enum Variant { kChain = 0, kIlp3 = 1, kConst = 2, kBf16 = 3, kNoepi = 4 };

// copy_flat: one 16-byte vector a thread, FLAT_THREADS threads a block on
// consecutive vectors, a block for every FLAT_THREADS vectors (no loop, no
// occupancy query: the host work of a launch stays at one call). Its loads and
// stores are streaming (evict-first): each byte is touched once, and at the
// smallest audit shape the source and the copy together fill the L2. Timed
// against a single wave of blocks holding four streaming loads in flight a
// thread, bulk copies through a shared-memory ring, two vectors a thread, the
// per-image grid (with and without a loop) and the default cache policy, it
// moved the same bytes faster.
constexpr int FLAT_THREADS = 512;

__global__ void __launch_bounds__(FLAT_THREADS)
    copy_flat(const uint4* __restrict__ x, uint4* __restrict__ out, long long vecs) {
  const long long i = (long long)blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (i < vecs) __stcs(out + i, __ldcs(x + i));
}

// The work is a set of independent chains: an element's REPS rounds depend
// each on the last, and nothing else does. So the kernel is a single wave
// of blocks (the grid at most the SMs times the blocks an SM holds, as the
// occupancy query gives them), over which the host's plan
// (floors.stencil_plan) spreads the elements evenly: a thread carries
// `chains` chains at once, for `passes` passes, so that each of its FMAs has
// chains - 1 independent ones beside it, and the threads of an SM its four
// schedulers' latency. A thread's chains are units t, t + stride, ... (a
// unit is one element, or two adjacent ones in bf16), and stride is a
// multiple of C, so all of them are of one channel: its 9 weights are
// loaded once into registers and the channel computed once. The rounds
// loop is unrolled so that a step holds 15-16 chain-rounds, its compare and
// branch under one instruction in ten rounds. A round then issues only
// its arithmetic: 9 FMAs, an add and a min (chain, const); three multiplies,
// six FMAs, three adds and a min (ilp3); 9 FMAs (noepi). What is left above
// the issue time: an FMA whose three operands are registers (weight, acc,
// sum) waits on the register file where two of them share a bank and none
// comes from the operand reuse cache; const's weight is an immediate, so its
// FMAs read two registers and it runs at ~0.85 of chain's time on the H100.
// bf16 works on pairs of
// elements in one 32-bit register with Hopper's bf16x2 instructions: a
// multiply and an add a tap, each rounded once from the exact result, as
// the plain version's bf16 products (exact in float32, then rounded) and
// sums (rounded to float32, then to bf16: double rounding from 24 bits to 8
// gives the one rounding, since 24 >= 2 x 8 + 2) are. A pair's lanes may be
// of two channels (odd C), each lane with its own weight.

template <int V, int NC>
__device__ __forceinline__ void round_f32(float (&acc)[NC], const float (&wt)[9]) {
  // the const variant's weights: float32 of the double 1 + 0.001 t, as the
  // TPU kernel's acc.dtype.type(1.0 + 0.001 * t) rounds them
  constexpr float kc[9] = {
      (float)(1.0 + 0.001 * 0), (float)(1.0 + 0.001 * 1), (float)(1.0 + 0.001 * 2),
      (float)(1.0 + 0.001 * 3), (float)(1.0 + 0.001 * 4), (float)(1.0 + 0.001 * 5),
      (float)(1.0 + 0.001 * 6), (float)(1.0 + 0.001 * 7), (float)(1.0 + 0.001 * 8)};
  // each chain's taps in turn: ptxas then reads its acc from the operand
  // reuse cache, and the FMA's other two registers seldom share a bank
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float s;
    if constexpr (V == kIlp3) {
      float row[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a = acc[j] * wt[dy * 3];
        a = fmaf(acc[j], wt[dy * 3 + 1], a);
        row[dy] = fmaf(acc[j], wt[dy * 3 + 2], a);
      }
      s = (row[0] + row[1]) + row[2];
    } else {
      s = 0.0f;
#pragma unroll
      for (int t = 0; t < 9; ++t) s = fmaf(acc[j], V == kConst ? kc[t] : wt[t], s);
    }
    acc[j] = V == kNoepi ? s : fminf(s + 1.0f, 127.0f);
  }
}

// bf16x2: lanes (low, high) of a 32-bit register, each rounded once to
// nearest even from the exact result
__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// 0 + a * b rounded once: the plain version's first sum, +0 for a -0 product
__device__ __forceinline__ uint32_t bmul0(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0u));
  return d;
}
__device__ __forceinline__ uint32_t bmin(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
constexpr uint32_t kOne2 = 0x3F803F80u, k127x2 = 0x42FE42FEu;  // bf16 1.0, 127.0 in both lanes

template <int NC>
__device__ __forceinline__ void round_bf16(uint32_t (&acc)[NC], const uint32_t (&wt)[9]) {
  uint32_t s[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j] = bmul0(acc[j], wt[0]);
#pragma unroll
  for (int t = 1; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = badd(s[j], bmul(acc[j], wt[t]));
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = bmin(badd(s[j], kOne2), k127x2);
}

template <int V, int NC, typename T>
__device__ __forceinline__ void round_any(T (&acc)[NC], const T (&wt)[9]) {
  if constexpr (V == kBf16)
    round_bf16<NC>(acc, wt);
  else
    round_f32<V, NC>(acc, wt);
}

// REPS rounds, unrolled to 16 / NC rounds a step
template <int V, int NC, typename T>
__device__ __forceinline__ void run_rounds(T (&acc)[NC], const T (&wt)[9], int reps) {
  constexpr int U = 16 / NC;
  int r = 0;
  for (; r + U <= reps; r += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) round_any<V, NC>(acc, wt);
  }
#pragma unroll 1
  for (; r < reps; ++r) round_any<V, NC>(acc, wt);
}

__device__ __forceinline__ float load_f(const unsigned short* p) {
  return __uint_as_float((uint32_t)*p << 16);
}

template <int V, int NC>
__global__ void __launch_bounds__(THREADS)
    stencil_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                   unsigned short* __restrict__ out, long long elems, int C, int reps,
                   int passes, int stride) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= stride) return;
  if constexpr (V == kBf16) {
    // units of two elements: 2u (low lane) and 2u + 1 (high lane)
    const int c0 = (int)((2LL * t) % C), c1 = c0 + 1 == C ? 0 : c0 + 1;
    uint32_t wt[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wt[k] = (uint32_t)w[k * C + c0] | (uint32_t)w[k * C + c1] << 16;
    for (int p = 0; p < passes; ++p) {
      uint32_t acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long long e = 2 * (t + (long long)(p * NC + j) * stride);
        acc[j] = (e < elems ? (uint32_t)x[e] : 0u) | (e + 1 < elems ? (uint32_t)x[e + 1] << 16 : 0u);
      }
      run_rounds<V, NC>(acc, wt, reps);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long long e = 2 * (t + (long long)(p * NC + j) * stride);
        if (e < elems) out[e] = (unsigned short)(acc[j] & 0xFFFFu);
        if (e + 1 < elems) out[e + 1] = (unsigned short)(acc[j] >> 16);
      }
    }
  } else {
    const int c = t % C;
    float wt[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wt[k] = V == kConst ? 0.0f : load_f(w + k * C + c);
    for (int p = 0; p < passes; ++p) {
      float acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long long e = t + (long long)(p * NC + j) * stride;
        acc[j] = e < elems ? load_f(x + e) : 0.0f;
      }
      run_rounds<V, NC>(acc, wt, reps);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long long e = t + (long long)(p * NC + j) * stride;
        if (e < elems) out[e] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[j]));
      }
    }
  }
}

using StencilFn = void (*)(const unsigned short*, const unsigned short*, unsigned short*,
                           long long, int, int, int, int);

// the kernel of (variant, chains); chains one of 1, 2, 3, 4, 8
// (floors.STENCIL_CHAINS)
StencilFn stencil_fn(int variant, int chains) {
#define MNK_ROW(V) {&stencil_kernel<V, 1>, &stencil_kernel<V, 2>, &stencil_kernel<V, 3>, \
                    &stencil_kernel<V, 4>, &stencil_kernel<V, 8>}
  static const StencilFn table[5][5] = {MNK_ROW(kChain), MNK_ROW(kIlp3), MNK_ROW(kConst),
                                        MNK_ROW(kBf16), MNK_ROW(kNoepi)};
#undef MNK_ROW
  const int ci = chains >= 1 && chains <= 4 ? chains - 1 : chains == 8 ? 4 : -1;
  if (variant < 0 || variant > 4 || ci < 0) return nullptr;
  return table[variant][ci];
}

}  // namespace

extern "C" {

// bytes a multiple of 16, both 16-byte aligned.
int hbm_copy_flat(const void* x, void* out, long long bytes, void* stream) {
  if (bytes <= 0 || bytes % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = bytes / 16, grid = (vecs + FLAT_THREADS - 1) / FLAT_THREADS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_flat<<<(unsigned)grid, FLAT_THREADS, 0, (cudaStream_t)stream>>>((const uint4*)x,
                                                                        (uint4*)out, vecs);
  return (int)cudaGetLastError();
}

// Blocks of the (variant, chains) stencil kernel an SM holds at once.
int stencil_blocks_per_sm(int variant, int chains) {
  const StencilFn fn = stencil_fn(variant, chains);
  if (!fn) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, 0) != cudaSuccess) return -1;
  return n;
}

// x, out: elems bf16 values, channels last (C of them); w: (3, 3, C) bf16.
// The plan (floors.stencil_plan): grid blocks of 256 threads, thread t <
// stride (a multiple of C) carrying chains x passes units t + j stride; a
// unit is an element (bf16: two). Refuses a plan that does not cover every
// element once.
int stencil(const void* x, const void* w, void* out, long long elems, int C, int reps,
            int variant, int chains, int passes, int stride, int grid, void* stream) {
  const StencilFn fn = stencil_fn(variant, chains);
  const long long units = variant == kBf16 ? (elems + 1) / 2 : elems;
  if (!fn || elems <= 0 || C <= 0 || elems % C || reps < 0 || passes <= 0 || stride <= 0 ||
      stride % C || grid <= 0 || (long long)grid * THREADS < stride ||
      (long long)chains * passes * stride < units)
    return (int)cudaErrorInvalidValue;
  fn<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const unsigned short*)x,
                                                 (const unsigned short*)w, (unsigned short*)out,
                                                 elems, C, reps, passes, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
