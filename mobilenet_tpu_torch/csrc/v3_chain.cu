// A run of K >= 2 consecutive MobileNet-V3 bottlenecks in one cooperative
// launch.
//
// Replaces the TPU kernel mobilenet_tpu/ops/pallas_chain_v3.py
// v3_chain_pallas (:239). Its contract is the TPU kernel's: the output equals
// the per-block kernel (v3_block.cu) called once per block in sequence, bit
// for bit, in bf16 and float32. Every stage computes its units with the same
// code as v3_block.cu, on the plan that ops/v3_block gives that block alone
// (bf16: v3_wgmma.cuh on v3_wgmma_plan; float32: v3_tile.cuh on v3_plan),
// and rounds its output to the activation dtype where the per-block route
// writes it to device memory.
//
// Design: the pattern of chain.cu. One persistent grid runs all K stages;
// each stage loops its units (float32: tiles) over the grid. A stage with
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
// `gate`) buffers are sized for the largest SE stage. Stage shapes, plans
// and weight pointers reach the kernel as one __grid_constant__ parameter
// table; each stage builds (bf16) or copies (float32) its shape into shared
// memory before its units. bf16 stages load their windows and weights by
// TMA through tensor maps that the host encodes per stage into a pinned
// buffer (v3_chain_bf16_maps), which the caller copies to the device ahead
// of the launch (15 stages' maps exceed the 4 KB parameter limit); after
// each grid barrier the producers fence the other blocks' stores into the
// async proxy (fence.proxy.async.global), as chain.cu does. float32: k = 3
// or 5 is dispatched per stage at run time, so one kernel holds both k
// instantiations of both passes; its stages load through L2 (__ldcg).
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

#include "v3_tile.cuh"
#include "v3_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using mnk::v3::SMEM_MAX;
using mnk::v3::V3_THREADS;
using mnk::v3::V3Shape;
using mnk::v3::make_shape;
using mnk::v3::v3_tile;

constexpr int MAX_STAGES = 15;  // V3-Large's bottleneck count
// The running stage's V3Shape is copied into a static shared variable. Read
// through the parameter table at a run-time stage index, every field access
// of the tile loop is a load, and a stage's tiles ran far slower than
// v3_block's on the card; kept at the head of the dynamic shared memory,
// where the compiler cannot tell it from the tile's buffers, it was reloaded
// after every shared store, still well behind v3_block.
constexpr int SHAPE_BYTES = 256;  // what the Python fits function reserves for it
static_assert(sizeof(V3Shape) <= SHAPE_BYTES, "the stage shape must fit its reserve");
constexpr int PTRS = 10;  // weight pointers a stage: exp w/b, dw w/b, prj w/b, SE w1/b1/w2/b2
constexpr int DIMS = 12;  // ints a stage: Cin E Cout Se K stride act_exp act residual identity TH TW

struct Stage {
  const void* w[PTRS];
  V3Shape s;
};

struct ChainArgs {
  const void* x;
  void* out;
  void* scratch[2];
  float* partial;
  int stages;
  Stage st[MAX_STAGES];
};
static_assert(sizeof(ChainArgs) <= 4096, "the parameter table must fit the 4 KB kernel limit");

template <typename T, int K>
__device__ __forceinline__ void run_stage(const V3Shape& s, const Stage& g, const T* src, T* dst,
                                          float* partial, unsigned char* smem,
                                          cg::grid_group& grid) {
  const int tiles_img = s.tiles_h * s.tiles_w;
  const int tiles = s.N * tiles_img;
  const auto w = [&g](int j) { return static_cast<const T*>(g.w[j]); };
  if (s.Se > 0) {
    for (int i = blockIdx.x; i < tiles; i += gridDim.x)
      v3_tile<T, K, true, true, const V3Shape&>(src, w(0), w(1), w(2), w(3), w(4), w(5), w(6),
                                                w(7), w(8), w(9), partial, dst, s,
                                                i / tiles_img, i % tiles_img, smem);
    grid.sync();  // every tile's sums are in `partial`
  }
  for (int i = blockIdx.x; i < tiles; i += gridDim.x)
    v3_tile<T, K, false, true, const V3Shape&>(src, w(0), w(1), w(2), w(3), w(4), w(5), w(6),
                                               w(7), w(8), w(9), partial, dst, s,
                                               i / tiles_img, i % tiles_img, smem);
}

template <typename T>
__global__ void __launch_bounds__(V3_THREADS, 2)
    v3_chain_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ V3Shape s;
  cg::grid_group grid = cg::this_grid();
  const T* src = static_cast<const T*>(a.x);
  for (int k = 0; k < a.stages; ++k) {
    T* dst = static_cast<T*>(k == a.stages - 1 ? a.out : a.scratch[k % 2]);
    const Stage& g = a.st[k];
    // every thread is past the previous stage's tiles (its grid barrier)
    if (threadIdx.x < sizeof(V3Shape) / 4)
      reinterpret_cast<int*>(&s)[threadIdx.x] = reinterpret_cast<const int*>(&g.s)[threadIdx.x];
    __syncthreads();
    if (s.K == 3)
      run_stage<T, 3>(s, g, src, dst, a.partial, smem, grid);
    else
      run_stage<T, 5>(s, g, src, dst, a.partial, smem, grid);
    if (k + 1 < a.stages) grid.sync();  // stage k's output is complete
    src = dst;
  }
}

// Opts the kernel in to all the dynamic shared memory that its static
// shared memory (the stage's shape) leaves of the per-block limit.
template <typename T>
cudaError_t opt_in(int* granted) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, v3_chain_kernel<T>);
  if (e != cudaSuccess) return e;
  const int dynamic = SMEM_MAX - (int)attr.sharedSizeBytes;
  e = cudaFuncSetAttribute(v3_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dynamic);
  if (e == cudaSuccess) *granted = dynamic;
  return e;
}

template <typename T>
int launch(const void* x, void* out, void* scratch0, void* scratch1, void* partial, int N,
           int H, int W, int stages, const void* const* ptrs, const int* dims, int* grid,
           void* stream) {
  if (stages < 1 || stages > MAX_STAGES || ptrs == nullptr || dims == nullptr)
    return (int)cudaErrorInvalidValue;
  if (stages > 1 && (scratch0 == nullptr || (stages > 2 && scratch1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  ChainArgs a{};
  a.x = x;
  a.out = out;
  a.scratch[0] = scratch0;
  a.scratch[1] = scratch1;
  a.partial = static_cast<float*>(partial);
  a.stages = stages;
  int h = H, w = W, cin = -1, smem = 0;
  long long max_tiles = 0;
  for (int k = 0; k < stages; ++k) {
    const int* d = dims + k * DIMS;
    Stage& g = a.st[k];
    if (cin >= 0 && d[0] != cin) return (int)cudaErrorInvalidValue;  // stages must chain
    if (!make_shape(&g.s, N, h, w, d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9],
                    d[10], d[11], (int)sizeof(T)))
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < PTRS; ++j) g.w[j] = ptrs[k * PTRS + j];
    const bool identity = d[9] != 0, se = d[3] > 0;
    for (int j = 0; j < PTRS; ++j) {
      const bool needed = j >= 6 ? se : (j < 2 ? !identity : true);
      if (needed && g.w[j] == nullptr) return (int)cudaErrorInvalidValue;
    }
    if (se && partial == nullptr) return (int)cudaErrorInvalidValue;
    const long long tiles = (long long)N * g.s.tiles_h * g.s.tiles_w;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
    smem = g.s.smem > smem ? g.s.smem : smem;
    h = g.s.Ho;
    w = g.s.Wo;
    cin = d[2];
  }
  static int smem_set = -1;  // per instantiation: the dynamic opt-in granted
  cudaError_t e;
  if (smem_set < 0) {
    e = opt_in<T>(&smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > smem_set) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v3_chain_kernel<T>, V3_THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long cap = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(max_tiles < cap ? max_tiles : cap);
  if (grid != nullptr) *grid = (int)blocks;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)v3_chain_kernel<T>, dim3(blocks),
                                  dim3(V3_THREADS), args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


// ---- bf16 -------------------------------------------------------------------------

namespace w = mnk::v3w;
constexpr int DIMS_W = 16;  // DIMS, then the plan's split, cw, ws, bs (TH, TW as th, tw)

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
// stages x 12 ints (Cin, E, Cout, Se, K, stride, act_exp, act, residual,
// identity, TH, TW), bf16 stages x 16 (then split, cw, ws, bs: the plan of
// ops/v3_block.v3_wgmma_plan, TH and TW its th and tw). Stage k reads stage
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
  return launch<float>(x, out, scratch0, scratch1, partial, N, H, W, stages, ptrs, dims,
                       grid, stream);
}

}  // extern "C"
