// A run of K >= 2 consecutive MobileNet-V3 bottlenecks in one cooperative
// launch.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_chain_v3.py
// v3_chain_pallas (:239). Its contract is the TPU kernel's: the output equals
// the per-block kernel (v3_block.cu) called once per block in sequence, bit
// for bit, in bf16 and float32. Every stage computes its units with the same
// code as v3_block.cu, on the plan that ops/v3_block gives that block alone
// (bf16: v3_wgmma.cuh on v3_wgmma_plan; float32: v3_f32.cuh on v3_plan),
// and rounds its output to the activation dtype where the per-block route
// writes it to device memory.
//
// Design: the pattern of chain.cu. One persistent grid runs all K stages;
// each stage loops its units over the grid. A stage with
// squeeze-excite runs v3_block.cu's passes without the launch boundaries
// between them: pass 1 over all tiles writes the per-tile channel sums into
// `partial`, a grid-wide barrier (cooperative_groups::this_grid().sync()),
// then (bf16) each image's gate once, by the blocks in turn, and another
// grid barrier, then the gated pass. Another grid barrier separates the
// stages, since blocks run in no order. The launch is cooperative so that
// the whole grid is co-resident; its size is the largest stage's unit count
// capped by what cudaOccupancyMaxActiveBlocksPerMultiprocessor allows at the
// dynamic shared memory of the largest stage (beside its static copy of the
// stage's shape). Activations between stages go through two ping-pong
// scratch buffers that the caller allocates; the SE `partial` (and bf16
// `gate`; float32: each stage's pre-gate tensor after its sums) buffers are
// sized for the largest SE stage. Stage shapes, plans
// and weight pointers reach the kernel as one __grid_constant__ parameter
// table; each stage builds its shape into shared
// memory before its units. bf16 stages load their windows and weights by
// TMA through tensor maps that the host encodes per stage into a pinned
// buffer (v3_chain_bf16_maps), which the caller copies to the device ahead
// of the launch (15 stages' maps exceed the 4 KB parameter limit); after
// each grid barrier the producers fence the other blocks' stores into the
// async proxy (fence.proxy.async.global), as chain.cu does. float32: k = 3
// or 5 is dispatched per stage at run time, so one kernel holds both k
// instantiations; its producer's cp.async copies and its gates' reads of
// `partial` go through L2 (.cg), which the grid barrier makes coherent.
//
// What bounds it on an H100: the chain's input read once, its output written
// once and the blocks' products (the sum of the per-block operation counts):
// intermediates need not leave the chip. For V3-Large b1-b14 at batch 256 in
// bf16 that is ~0.11 ms of operations at 989 TFLOP/s against ~0.03 ms of
// bytes, below the sum of the per-block bounds. This version still writes
// every intermediate to the scratch buffers (they stay partly in the 50 MB
// L2 at batch 1, not at batch 256), and the whole run takes the residency of
// its largest stage (one block an SM in bf16: 384 threads at up to 232
// registers). What it removes is the launch and the kernel boundary of each
// block and of each SE block's later passes, which is where the batch-1
// forward's time goes.
#include <cooperative_groups.h>

#include "v3_f32.cuh"
#include "v3_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_STAGES = 15;  // V3-Large's bottleneck count
// The running stage's shape (bf16: its Geo and plan; float32: its Geo) is
// built into a static shared variable. Read through the parameter table at a
// run-time stage index, every field access of the tile loop is a load, and a
// stage's tiles ran far slower than v3_block's on the card.
constexpr int SHAPE_BYTES = 256;  // what the Python fits function reserves for it
constexpr int PTRS = 10;  // weight pointers a stage: exp w/b, dw w/b, prj w/b, SE w1/b1/w2/b2

// ---- float32 ----------------------------------------------------------------------

namespace f = mnk::v3f;
constexpr int DIMS_F = 14;  // Cin E Cout Se K stride act_exp act residual identity th tw ws bs
static_assert(sizeof(f::Geo) <= SHAPE_BYTES, "the stage shape must fit its reserve");

struct StageF {
  const void* w[PTRS];
  int d[DIMS_F];
};

struct ChainF {
  const void* x;
  void* out;
  void* scratch[2];
  float* partial;
  int N, H, W, stages;
  StageF st[MAX_STAGES];
};
static_assert(sizeof(ChainF) <= 4096, "the parameter table must fit the 4 KB kernel limit");

__host__ __device__ inline f::Geo stage_geo_f(int N, int H, int W, const int* d) {
  return f::make_geo(N, H, W, d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9],
                     f::Plan{d[10], d[11], d[12], d[13]});
}

__global__ void __launch_bounds__(f::THREADS, 1)
    v3_chain_f32_kernel(const __grid_constant__ ChainF a) {
  extern __shared__ __align__(128) unsigned char smem_cf[];
  __shared__ f::Geo sg;  // the running stage's shape and plan
  cg::grid_group grid = cg::this_grid();
  f::setup(smem_cf);
  f::Ring wr, br;
  int h = a.H, wd = a.W;
  const float* src = static_cast<const float*>(a.x);
  for (int k = 0; k < a.stages; ++k) {
    const StageF& st = a.st[k];
    // every thread is past the previous stage (its grid barrier)
    if (threadIdx.x == 0) sg = stage_geo_f(a.N, h, wd, st.d);
    __syncthreads();
    const f::Geo& g = sg;
    const auto t = [&st](int j) { return static_cast<const float*>(st.w[j]); };
    float* dst = static_cast<float*>(k == a.stages - 1 ? a.out : a.scratch[k % 2]);
    const f::Ptrs p{src, t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9),
                    a.partial, a.partial + (long long)a.N * g.tiles_img * g.E, dst};
    h = g.Ho;  // read before the grid barrier, behind which thread 0 rewrites sg
    wd = g.Wo;
    for (int pass = g.Se > 0 ? 1 : 0; pass >= 0; --pass) {
      if (g.K == 3)
        f::run_pass<3>(g, p, smem_cf, pass == 1, wr, br);
      else
        f::run_pass<5>(g, p, smem_cf, pass == 1, wr, br);
      // pass 1: every tile's sums are in `partial`; pass 0: stage k's output is complete
      if (pass == 1 || k + 1 < a.stages) grid.sync();
    }
    src = dst;
  }
}

int launch_f32(const void* x, void* out, void* scratch0, void* scratch1, void* partial, int N,
               int H, int W, int stages, const void* const* ptrs, const int* dims, int* grid,
               void* stream) {
  if (stages < 1 || stages > MAX_STAGES || ptrs == nullptr || dims == nullptr)
    return (int)cudaErrorInvalidValue;
  if (stages > 1 && (scratch0 == nullptr || (stages > 2 && scratch1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  ChainF a{};
  a.x = x;
  a.out = out;
  a.scratch[0] = scratch0;
  a.scratch[1] = scratch1;
  a.partial = static_cast<float*>(partial);
  a.N = N;
  a.H = H;
  a.W = W;
  a.stages = stages;
  int h = H, w = W, cin = -1, smem = 0;
  long long max_units = 0;
  for (int k = 0; k < stages; ++k) {
    const int* d = dims + k * DIMS_F;
    if (cin >= 0 && d[0] != cin) return (int)cudaErrorInvalidValue;  // stages must chain
    const f::Geo g = stage_geo_f(N, h, w, d);
    if (!f::geo_ok(g)) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < PTRS; ++j) {
      const bool needed = j >= 6 ? g.Se > 0 : (j < 2 ? !g.identity : true);
      if (needed && ptrs[k * PTRS + j] == nullptr) return (int)cudaErrorInvalidValue;
      a.st[k].w[j] = ptrs[k * PTRS + j];
    }
    for (int j = 0; j < DIMS_F; ++j) a.st[k].d[j] = d[j];
    if (g.Se > 0 && partial == nullptr) return (int)cudaErrorInvalidValue;
    const long long units = (long long)N * g.tiles_img;
    if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    max_units = units > max_units ? units : max_units;
    smem = g.smem_bytes > smem ? g.smem_bytes : smem;
    h = g.Ho;
    w = g.Wo;
    cin = g.Cout;
  }
  static int smem_set = -1;  // the dynamic opt-in granted
  cudaError_t e;
  if (smem_set < 0) {
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, v3_chain_f32_kernel)) != cudaSuccess) return (int)e;
    const int dynamic = 232448 - (int)attr.sharedSizeBytes;
    e = cudaFuncSetAttribute(v3_chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic);
    if (e != cudaSuccess) return (int)e;
    smem_set = dynamic;
  }
  if (smem > smem_set) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v3_chain_f32_kernel, f::THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long cap = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(max_units < cap ? max_units : cap);
  if (grid != nullptr) *grid = (int)blocks;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)v3_chain_f32_kernel, dim3(blocks),
                                  dim3(f::THREADS), args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- bf16 -------------------------------------------------------------------------

namespace w = mnk::v3w;
constexpr int DIMS_W = 16;  // DIMS_F's first 10, then th, tw, split, cw, ws, bs

struct StageW {
  const void* w[PTRS];
  int d[DIMS_W];
};

struct ChainW {
  const void* x;
  void* out;
  void* scratch[2];
  float* partial;
  float* gate;
  const w::Maps* maps;  // each stage's tensor maps, in device memory
  int N, H, W, stages;
  StageW st[MAX_STAGES];
};
static_assert(sizeof(ChainW) <= 4096, "the parameter table must fit the 4 KB kernel limit");
static_assert(sizeof(w::Geo) <= SHAPE_BYTES, "the stage shape must fit its reserve");
static_assert(sizeof(w::Maps) == 1152, "ops/v3_chain.MAPS_BYTES");

__host__ __device__ inline w::Geo stage_geo(int N, int H, int W, const int* d) {
  return w::make_geo(N, H, W, d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9],
                     w::Plan{d[10], d[11], d[12], d[13], d[14], d[15]});
}

__global__ void __launch_bounds__(w::THREADS, 1)
    v3_chain_bf16_kernel(const __grid_constant__ ChainW a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ w::Geo sg;  // the running stage's shape and plan
  cg::grid_group grid = cg::this_grid();
  unsigned char* base = w::setup_smem(smem_raw);
  w::by_role([&](auto role) {
    constexpr bool kConsumer = decltype(role)::value;
    w::Ring wring, bring;
    int h = a.H, wd = a.W;
    for (int k = 0; k < a.stages; ++k) {
      const StageW& st = a.st[k];
      // every thread is past the previous stage (its grid barrier)
      if (threadIdx.x == 0) sg = stage_geo(a.N, h, wd, st.d);
      __syncthreads();
      const w::Geo& g = sg;
      const w::Rings r = w::rings_of(g, base);
      using bf16 = w::bf16;
      const auto t = [&st](int j) { return static_cast<const bf16*>(st.w[j]); };
      const w::Ptrs p{t(6), t(7), t(8), t(9),
                      static_cast<bf16*>(k == a.stages - 1 ? a.out : a.scratch[k % 2]),
                      a.partial, a.gate};
      const w::Maps* maps = a.maps + k;
      if (g.Se > 0) {
        w::run_pass<kConsumer>(g, r, maps, p, true, wring, bring);
        grid.sync();  // every tile's sums are in `partial`
        if constexpr (kConsumer)  // the tile's memory is free between the passes
          for (int n = blockIdx.x; n < g.N; n += gridDim.x)
            w::se_gate(g, p, n, reinterpret_cast<float*>(r.a), threadIdx.x, w::CONSUMERS,
                       [] { hop::named_bar_sync(1, w::CONSUMERS); });
        grid.sync();  // every image's gate is in `gate`
        if constexpr (!kConsumer) hop::fence_proxy_async_global();  // for its TMA loads
      }
      w::run_pass<kConsumer>(g, r, maps, p, false, wring, bring);
      h = g.Ho;
      wd = g.Wo;
      if (k + 1 < a.stages) {
        grid.sync();  // stage k's output is complete
        if constexpr (!kConsumer) hop::fence_proxy_async_global();  // for stage k + 1's TMA loads
      }
    }
  });
}

// The stages' shapes, checked, in order; the largest unit count and dynamic
// shared memory; the window sources. Returns a CUDA error code.
int chain_geos(int N, int H, int W, int stages, const void* const* ptrs, const int* dims,
               const void* x, void* scratch0, void* scratch1, w::Geo* geos, const void** srcs,
               long long* max_units, int* smem) {
  if (stages < 1 || stages > MAX_STAGES || ptrs == nullptr || dims == nullptr)
    return (int)cudaErrorInvalidValue;
  if (stages > 1 && (scratch0 == nullptr || (stages > 2 && scratch1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  int h = H, wd = W, cin = -1;
  *max_units = 0;
  *smem = 0;
  for (int k = 0; k < stages; ++k) {
    const int* d = dims + k * DIMS_W;
    if (cin >= 0 && d[0] != cin) return (int)cudaErrorInvalidValue;  // stages must chain
    const w::Geo g = geos[k] = stage_geo(N, h, wd, d);
    if (!w::geo_ok(g)) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < PTRS; ++j) {
      const bool needed = j >= 6 ? g.Se > 0 : (j < 2 ? !g.identity : true);
      if (needed && ptrs[k * PTRS + j] == nullptr) return (int)cudaErrorInvalidValue;
    }
    srcs[k] = k == 0 ? x : ((k - 1) % 2 == 0 ? scratch0 : scratch1);
    const long long units = w::units_of(g, false);
    if (units > *max_units) *max_units = units;
    if (g.smem_bytes > *smem) *smem = g.smem_bytes;
    h = g.Ho;
    wd = g.Wo;
    cin = g.Cout;
  }
  return (int)cudaSuccess;
}

int launch_bf16(const void* x, void* out, void* scratch0, void* scratch1, void* partial,
                void* gate, const void* maps, int N, int H, int W, int stages,
                const void* const* ptrs, const int* dims, int* grid, void* stream) {
  w::Geo geos[MAX_STAGES];
  const void* srcs[MAX_STAGES];
  long long max_units = 0;
  int smem = 0;
  int code = chain_geos(N, H, W, stages, ptrs, dims, x, scratch0, scratch1, geos, srcs,
                        &max_units, &smem);
  if (code != 0) return code;
  ChainW a{};
  a.x = x;
  a.out = out;
  a.scratch[0] = scratch0;
  a.scratch[1] = scratch1;
  a.partial = static_cast<float*>(partial);
  a.gate = static_cast<float*>(gate);
  a.maps = static_cast<const w::Maps*>(maps);
  a.N = N;
  a.H = H;
  a.W = W;
  a.stages = stages;
  for (int k = 0; k < stages; ++k) {
    if (geos[k].Se > 0 && (partial == nullptr || gate == nullptr))
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < PTRS; ++j) a.st[k].w[j] = ptrs[k * PTRS + j];
    for (int j = 0; j < DIMS_W; ++j) a.st[k].d[j] = dims[k * DIMS_W + j];
  }
  static int smem_set = -1;  // the dynamic opt-in granted
  cudaError_t e;
  if (smem_set < 0) {
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, v3_chain_bf16_kernel)) != cudaSuccess) return (int)e;
    const int dynamic = w::SMEM_LIMIT - (int)attr.sharedSizeBytes;
    e = cudaFuncSetAttribute(v3_chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic);
    if (e != cudaSuccess) return (int)e;
    smem_set = dynamic;
  }
  if (smem > smem_set) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v3_chain_bf16_kernel, w::THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long cap = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(max_units < cap ? max_units : cap);
  if (grid != nullptr) *grid = (int)blocks;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)v3_chain_bf16_kernel, dim3(blocks),
                                  dim3(w::THREADS), args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: stages x 10 weight pointers (exp_w, exp_b, dw_w, dw_b, prj_w, prj_b,
// se_w1, se_b1, se_w2, se_b2; 0 where the block has no such tensor); dims:
// stages x 14 ints (Cin, E, Cout, Se, K, stride, act_exp, act, residual,
// identity, th, tw, ws, bs: the plan of ops/v3_block.v3_plan), bf16 stages x
// 16 (then th, tw, split, cw, ws, bs: the plan of ops/v3_block.v3_wgmma_plan). Stage k reads stage
// k-1's output; H and W are the first stage's input. `grid` (may be null)
// receives the launch's block count: the largest stage's units or the
// co-resident cap, the smaller. bf16: `gate` holds N x E f32 for the SE
// stages; `maps` is the device copy of what v3_chain_bf16_maps wrote.
int v3_chain_bf16(const void* x, void* out, void* scratch0, void* scratch1, void* partial,
                  void* gate, const void* maps, int N, int H, int W, int stages,
                  const void* const* ptrs, const int* dims, int* grid, void* stream) {
  return launch_bf16(x, out, scratch0, scratch1, partial, gate, maps, N, H, W, stages, ptrs,
                     dims, grid, stream);
}

// The bf16 chain's tensor maps (sizeof(Maps) = 1152 bytes a stage, 64-byte
// aligned host memory at `host`), for the same arguments as v3_chain_bf16.
int v3_chain_bf16_maps(void* host, const void* x, void* scratch0, void* scratch1,
                       const void* gate, int N, int H, int W, int stages,
                       const void* const* ptrs, const int* dims) {
  w::Geo geos[MAX_STAGES];
  const void* srcs[MAX_STAGES];
  long long max_units = 0;
  int smem = 0;
  int code = chain_geos(N, H, W, stages, ptrs, dims, x, scratch0, scratch1, geos, srcs,
                        &max_units, &smem);
  if (code != 0) return code;
  w::Maps* m = static_cast<w::Maps*>(host);
  for (int k = 0; k < stages; ++k) {
    const void* const* pk = ptrs + k * PTRS;
    const cudaError_t e =
        w::make_maps(m[k], srcs[k], pk[0], pk[1], pk[2], pk[3], pk[4], pk[5], gate, geos[k]);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

int v3_chain_f32(const void* x, void* out, void* scratch0, void* scratch1, void* partial,
                 int N, int H, int W, int stages, const void* const* ptrs, const int* dims,
                 int* grid, void* stream) {
  return launch_f32(x, out, scratch0, scratch1, partial, N, H, W, stages, ptrs, dims, grid,
                    stream);
}

}  // extern "C"
