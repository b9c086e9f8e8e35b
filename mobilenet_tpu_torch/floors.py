"""Floor probes on the card: the rates that an H100 sustains for moving bytes
and for float32 multiply-adds on the CUDA cores, beside the published peaks
that the roofline model (`roofline.py`) divides by.

    python -m mobilenet_tpu_torch.floors [--out PATH | --copy-ab ROUNDS |
                                          --stencil-ab ROUNDS] [--parent DIR]

The probe kernels are `csrc/floors.cu` (which names the TPU probes of the JAX
package's tools/microbench_floors.py that they replace); each has its plain
PyTorch version here, which the wrappers run on CPU tensors. The run times,
at the audit geometries (batch 256, 112^2 x 64 down to 7^2 x 1024):
  - hbm_copy_flat, a 16-byte vector a thread of `csrc/floors.cu`'s
    copy_flat (hbm_copy, the batch image by image, is the same kernel),
    beside the library copy `Tensor.copy_` as a yardstick the port never
    calls -> GB/s, read + write, by CUDA events over a CUDA graph of the
    calls, each reading a source the L2 no longer holds (`cold_inputs`; the
    depthwise and matmul rates below by CUDA events over back-to-back
    calls);
  - the stencil, each variant (chain, ilp3, const, bf16, noepi, and the
    TPU tool's grid and width forms) -> T-FMA/s, against the CUDA cores'
    peak for its type (float32 33.5 T-FMA/s, bf16 66.9), by `graph_ms`
    (CUDA events over back-to-back calls beside it);
  - the implied multiply-add rate of the port's depthwise kernel at two V1
    layers (9 x outputs over its time, HBM and epilogue included);
  - one bf16 `torch.matmul` at 8192^3 -> TFLOP/s (the JAX tool leaves this
    product to XLA outside any kernel);
and writes them to build/achievable_h100.json for `roofline.py --achievable`.
With --copy-ab, instead only the copy probe against `Tensor.copy_` in
alternating runs (the order turned each round), a run's ms summed over the
five audit shapes, by CUDA events over back-to-back calls and over a CUDA
graph of them, on cold sources and on one source read again: each copy's
runs, medians, spreads and medians at each shape as one JSON line. With --stencil-ab, instead each STENCIL_RUNS entry in
alternating runs by `graph_ms`: its runs, median, spread and share of its
bound. --parent DIR adds to either A/B the probes of the checkout unpacked
at DIR (`git archive <commit> | tar -x -C DIR`; its kernels build under
DIR/build at first use), timed in the same process.
Needs a CUDA card; refuses to run without one.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import subprocess
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from .ops import _build
from .ops.separable_block import _sms

VARIANTS = ("chain", "ilp3", "const", "bf16", "noepi")
# the TPU tool's audit geometries (V1 1.0-224's activations, batch 256)
AUDIT_SHAPES = (("112x64", (256, 112, 112, 64)), ("56x128", (256, 56, 56, 128)),
                ("28x256", (256, 28, 28, 256)), ("14x512", (256, 14, 14, 512)),
                ("7x1024", (256, 7, 7, 1024)))
# the TPU tool's stencil formulations: (label, variant, h, w, c, reps, images)
STENCIL_RUNS = (("chain", "chain", 56, 56, 128, 256, 1), ("ilp3", "ilp3", 56, 56, 128, 256, 1),
                ("const", "const", 56, 56, 128, 256, 1), ("bf16", "bf16", 56, 56, 128, 256, 1),
                ("noepi", "noepi", 56, 56, 128, 256, 1),
                ("chain_g8", "chain", 56, 56, 128, 64, 8),
                ("ilp3_g8", "ilp3", 56, 56, 128, 64, 8),
                ("const_c512", "const", 14, 14, 512, 256, 1))
# NVIDIA's H100 SXM data sheet: HBM bytes/s, float32 CUDA-core FMA/s (67
# TFLOP/s, an FMA counting two), bf16 tensor-core FLOP/s; and the bf16 rate
# outside the tensor cores, twice float32's (133.8 TFLOP/s, NVIDIA H100 Tensor
# Core GPU Architecture whitepaper, H100 SXM5)
PUBLISHED = {"hbm_gbps": 3350.0, "cuda_core_tfmas": 33.5, "cuda_core_bf16_tfmas": 66.9,
             "mxu_tflops": 989.0}
L2_BYTES = 50 * 2 ** 20  # the H100's L2 cache
OUT = Path(__file__).resolve().parents[1] / "build" / "achievable_h100.json"


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16 or (x.numel() * x.element_size()) % 16:
        raise ValueError(f"{name}: needs a contiguous, 16-byte aligned tensor of a "
                         "multiple of 16 bytes")


def hbm_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def hbm_copy_flat(x: torch.Tensor) -> torch.Tensor:
    """A copy of x's bytes as one flat buffer. On CPU tensors the plain
    version; on CUDA tensors the kernel or raise."""
    _check("hbm_copy_flat", x)
    if x.device.type == "cpu":
        return hbm_copy_plain(x)
    lib = _build.library()
    out = torch.empty_like(x)
    code = lib.hbm_copy_flat(x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "hbm_copy_flat")
    hbm_copy_flat.launches += 1
    return out


# The TPU tool's per-image copy of a batch (N, ...): an image's bytes are
# contiguous, so it is the flat copy of the batch, one kernel and one counter.
hbm_copy = hbm_copy_flat


def stencil_plain(x: torch.Tensor, w: torch.Tensor, reps: int,
                  variant: str = "chain") -> torch.Tensor:
    """The TPU probe's arithmetic (`_stencil_kernel`) in plain ops: x
    (..., C) bf16, w (3, 3, C) bf16; REPS rounds of the 9 products of each
    element with its channel's weights summed (float32; bf16 rounds every
    product and sum), then min(s + 1, 127) (noepi: none); rounded to bf16."""
    dt = torch.bfloat16 if variant == "bf16" else torch.float32
    acc, wt = x.to(dt), w.to(dt)
    consts = [float(torch.tensor(1.0 + 0.001 * t, dtype=torch.float32)) for t in range(9)]
    for _ in range(reps):
        if variant == "ilp3":
            rows = []
            for dy in range(3):
                s = acc * wt[dy, 0]
                for dx in (1, 2):
                    s = s + acc * wt[dy, dx]
                rows.append(s)
            s = (rows[0] + rows[1]) + rows[2]
        else:
            s = torch.zeros_like(acc)
            for t in range(9):
                s = s + acc * (consts[t] if variant == "const" else wt[t // 3, t % 3])
        acc = s if variant == "noepi" else torch.clamp_max(s + 1.0, 127.0)
    return acc.to(x.dtype)


STENCIL_THREADS = 256  # the stencil kernel's block
STENCIL_CHAINS = (1, 2, 3, 4, 8)  # the chains a thread carries: the kernel's instances
# the plan's order among chain counts of one cost: as the H100 ran them at
# the timed runs (PERF.md §6), four chains first, one last
CHAINS_BY_SPEED = (4, 2, 3, 8, 1)


class StencilPlan(NamedTuple):
    chains: int  # independent chains a thread carries at once
    passes: int  # passes a thread makes, `chains` units each
    stride: int  # units between a thread's chains: a multiple of C
    grid: int    # blocks of STENCIL_THREADS, one wave


def stencil_units(elems: int, variant: str) -> int:
    """The kernel's units: bf16 works on pairs of adjacent elements."""
    return -(-elems // 2) if variant == "bf16" else elems


@functools.lru_cache(maxsize=None)
def stencil_plan(units: int, c: int, sms: int, blocks_per_sm: Tuple[int, ...]) -> StencilPlan:
    """The stencil kernel's plan for `units` units of C channels on a card of
    `sms` SMs that holds blocks_per_sm[i] blocks of the kernel with
    STENCIL_CHAINS[i] chains at once. Thread t < stride carries the units t
    + j stride, j < chains x passes (k), the ones below `units` real: all
    of one channel, since stride is a multiple of C, and each thread has
    floor or ceil of units / stride real ones. For each chains and the
    fewest passes (and up to three more) whose threads fit one wave, stride
    is the least multiple of C with k x stride >= units; an SM's blocks
    then issue ceil(grid / sms) x k chain-rounds a thread slot, which the
    plan minimizes (ties: CHAINS_BY_SPEED's order, then fewer passes)."""
    if units < 1 or c < 1:
        raise ValueError(f"stencil_plan: needs units >= 1 and C >= 1, got {units}, {c}")
    best = None
    for chains, bps in zip(STENCIL_CHAINS, blocks_per_sm):
        cap = sms * bps * STENCIL_THREADS // c * c  # a wave's threads, a multiple of C
        if cap < 1:
            continue
        least = -(-units // (chains * cap))
        for passes in range(least, least + 4):
            k = chains * passes
            stride = -(-(-(-units // k)) // c) * c
            grid = -(-stride // STENCIL_THREADS)
            key = (-(-grid // sms) * k, CHAINS_BY_SPEED.index(chains), passes)
            if best is None or key < best[0]:
                best = (key, StencilPlan(chains, passes, stride, grid))
    if best is None:
        raise ValueError(f"stencil_plan: C {c} exceeds a wave's threads")
    return best[1]


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(variant: str, index: int) -> Tuple[int, ...]:
    lib = _build.library()
    with torch.cuda.device(index):
        bps = tuple(lib.stencil_blocks_per_sm(VARIANTS.index(variant), n) for n in STENCIL_CHAINS)
    if min(bps) < 1:
        raise RuntimeError(f"stencil: the occupancy query failed ({bps})")
    return bps


def stencil(x: torch.Tensor, w: torch.Tensor, reps: int, variant: str = "chain") -> torch.Tensor:
    """The stencil probe on x (..., C) bf16 with weights w (3, 3, C) bf16.
    On CPU tensors the plain version; on CUDA tensors the kernel (on
    `stencil_plan`) or raise."""
    c = int(x.shape[-1])
    if variant not in VARIANTS:
        raise ValueError(f"stencil: variant {variant!r} not in {VARIANTS}")
    if (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or tuple(w.shape) != (3, 3, c)
            or not (x.is_contiguous() and w.is_contiguous()) or w.device != x.device
            or reps < 0):
        raise ValueError("stencil: needs contiguous bf16 x (..., C), w (3, 3, C), reps >= 0")
    if x.device.type == "cpu":
        return stencil_plain(x, w, reps, variant)
    lib = _build.library()
    index = x.device.index or 0
    plan = stencil_plan(stencil_units(x.numel(), variant), c, _sms(index),
                        _blocks_per_sm(variant, index))
    out = torch.empty_like(x)
    code = lib.stencil(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel(), c, reps,
                       VARIANTS.index(variant), *plan,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "stencil")
    stencil.launches += 1
    return out


hbm_copy_flat.launches = stencil.launches = 0


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> float:
    """CUDA-event milliseconds per call of fn, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Tap weights: their sum is a channel's gain a round. Without the clamp
# (noepi) the sum stays within 0.9-1.1, so that 256 rounds stay finite and
# far from zero; under it, (0.05, 0.2) sums to 0.45-1.8.
W_RANGE = {"noepi": (0.1, 0.122)}
# The kernel contracts each product and sum into one FMA where the plain
# version rounds twice: the float32 variants agree within one bf16 step of
# the output (relative, no absolute term); the bf16 variant, every step
# rounded on both sides, bit for bit.
STENCIL_RTOL = 2 ** -7


def stencil_inputs(n: int, h: int, w: int, c: int, device, variant: str = "chain",
                   seed: int = 0):
    """x in [0, 1) and positive tap weights (W_RANGE), bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, h, w, c), generator=gen, device=device).to(torch.bfloat16)
    lo, hi = W_RANGE.get(variant, (0.05, 0.2))
    wt = (lo + (hi - lo) * torch.rand((3, 3, c), generator=gen, device=device))
    return x, wt.to(torch.bfloat16)


def check_stencil(variant: str, n: int, h: int, w: int, c: int, reps: int,
                  device) -> Dict[str, float]:
    """The stencil on seeded inputs against its plain version, at
    STENCIL_RTOL (bf16: equal); raises AssertionError where they disagree.
    Over many rounds the output forgets x: with the clamp every element
    tends to a value set by its channel's weights (127 where they sum above
    1), and const's gain of 9.04 a round reaches 127 by round 4. So at 2
    rounds (8 but for const) the check also requires that the plain output
    on a second seeded x differ beyond the tolerance in over half of the
    elements: a kernel that ignored x could not pass. Returns the max-abs
    and max relative difference and that share ("sees_x")."""
    x, wt = stencil_inputs(n, h, w, c, device, variant)
    x2 = stencil_inputs(n, h, w, c, device, variant, seed=1)[0]
    got, ref = stencil(x, wt, reps, variant), stencil_plain(x, wt, reps, variant)
    other = stencil_plain(x2, wt, reps, variant).float()
    got, ref = got.float(), ref.float()
    name = f"stencil {variant} {tuple(x.shape)} x {reps} rounds"
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - ref).abs()
    rtol = 0.0 if variant == "bf16" else STENCIL_RTOL
    if bool((diff > rtol * ref.abs()).any()):
        raise AssertionError(f"{name}: max-abs {float(diff.max()):.3e} beyond rtol {rtol}")
    sees_x = float(((other - ref).abs() > STENCIL_RTOL * ref.abs()).float().mean())
    if (reps <= 2 or (reps <= 8 and variant != "const")) and sees_x <= 0.5:
        raise AssertionError(f"{name}: the output depends on x in only {sees_x:.1%} of the "
                             "elements; the comparison would not see a kernel that ignores x")
    return {"max_abs": float(diff.max()),
            "max_rel": float((diff / ref.abs().clamp_min(1e-30)).max()), "sees_x": sees_x}


def graph_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """CUDA-event ms a call of fn, replayed from one CUDA graph of `reps`
    calls: the card's time for the calls with no host work between them (a
    wrapper's checks, ctypes call and allocation stay out of it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the build, the allocator's pool
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_inputs(shape) -> list:
    """bf16 batches of ones of `shape`, as many that copies reading them in
    turn find their source out of the L2: from one read of a batch to the
    next, the copies read and write at least twice the L2's bytes. At 7^2 x
    1024 (25.7 MB) one batch read again and again stays partly in the L2,
    and its copy times the cache, not HBM (3554 GB/s on the H100)."""
    return cold_copies(torch.ones(shape, dtype=torch.bfloat16, device="cuda"))


def cold_copies(x: torch.Tensor) -> list:
    """x and as many clones that together they hold at least the L2's bytes:
    a kernel that reads them in turn finds each out of the L2."""
    k = -(-L2_BYTES // max(1, x.numel() * x.element_size()))
    return [x] + [x.clone() for _ in range(k - 1)]


def _in_turn(fn: Callable, xs: list) -> Callable[[], object]:
    it = itertools.cycle(xs)
    return lambda: fn(next(it))


def copy_rates(shape, fns: Dict[str, Callable]) -> Dict[str, Tuple[float, float]]:
    """{name: (GB/s read + write, ms)} of each copy function on a bf16 batch
    (`cold_inputs`, in turn), by `graph_ms`: the rate is the copy's on the
    card, not that of a wrapper's host work."""
    xs = cold_inputs(shape)
    nbytes = 2 * xs[0].numel() * xs[0].element_size()
    out = {}
    for name, fn in fns.items():
        ms = graph_ms(_in_turn(fn, xs))
        out[name] = (nbytes / (ms * 1e-3) / 1e9, ms)
    return out


def copy_fns(parent=None) -> Dict[str, Callable]:
    """The copies that `copy_ab` and `measure` time: the probe (hbm_copy is
    the same kernel), the library copy (a yardstick the port never calls)
    and, given the floors module of a parent checkout, its two probes."""
    fns = {"hbm_copy_flat": hbm_copy_flat,
           "library_copy": lambda x: torch.empty_like(x).copy_(x)}
    if parent is not None:
        fns.update(parent_hbm_copy=parent.hbm_copy, parent_hbm_copy_flat=parent.hbm_copy_flat)
    return fns


def _med(v):
    return sorted(v)[len(v) // 2]


def copy_ab(rounds: int, fns: Dict[str, Callable]) -> Dict:
    """The copies `fns` (`copy_fns`) in `rounds` alternating runs (A B C,
    then C B A, ...). A run is one copy's ms summed over the five audit
    shapes, taken three ways at each shape: CUDA events over back-to-back
    calls ("runs", host work included where a call's is longer than its
    copy) and `graph_ms` ("graph_runs", the card's time alone), each on
    `cold_inputs` in turn, and `graph_ms` on the first of them read again
    ("hot_graph_runs": the method before `cold_inputs`, whose source the L2
    partly holds at 7^2 x 1024). Returns each copy's runs of each kind (runs,
    graph_runs, hot_graph_runs), their medians ("median", "graph_median",
    "hot_graph_median") and (min, max) ("spread", ...), and its median ms of
    each kind at each shape ("shape_median_ms", "shape_graph_median_ms",
    "shape_hot_graph_median_ms")."""
    xss = [cold_inputs(shape) for _, shape in AUDIT_SHAPES]
    kinds = {"": lambda fn, xs: cuda_ms(_in_turn(fn, xs)),
             "graph_": lambda fn, xs: graph_ms(_in_turn(fn, xs)),
             "hot_graph_": lambda fn, xs: graph_ms(lambda: fn(xs[0]))}
    runs = {k: {kind: [] for kind in kinds} for k in fns}
    shape_ms = {k: {kind: {label: [] for label, _ in AUDIT_SHAPES} for kind in kinds}
                for k in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            for kind, timer in kinds.items():
                ms = [timer(fns[name], xs) for xs in xss]
                runs[name][kind].append(sum(ms))
                for (label, _), m in zip(AUDIT_SHAPES, ms):
                    shape_ms[name][kind][label].append(m)
    out = {k: {} for k in fns}
    for k, by_kind in runs.items():
        for kind, v in by_kind.items():
            out[k].update({f"{kind}runs": v, f"{kind}median": _med(v),
                           f"{kind}spread": [min(v), max(v)],
                           f"shape_{kind}median_ms": {lb: _med(m) for lb, m
                                                      in shape_ms[k][kind].items()}})
    return out


def stencil_bound(elems: int, c: int, reps: int, variant: str) -> Tuple[float, float, float]:
    """(bound ms, bytes ms, operations ms) of a stencil run on the H100
    (PUBLISHED): its 9 FMAs (two operations each) and the epilogue's add
    and min a round at the CUDA cores' peak for the variant's type (bf16:
    133.8 TFLOP/s, else float32's 67), or its bf16 input and output and
    weights at 3.35 TB/s; the bound is the larger."""
    peak = PUBLISHED["cuda_core_bf16_tfmas" if variant == "bf16" else "cuda_core_tfmas"]
    ops_ms = reps * (9 * 2 + 2) * elems / (2 * peak * 1e12) * 1e3
    bytes_ms = (4 * elems + 18 * c) / (PUBLISHED["hbm_gbps"] * 1e9) * 1e3
    return max(ops_ms, bytes_ms), bytes_ms, ops_ms


def stencil_rate(variant: str, h: int, w: int, c: int, reps: int,
                 images: int) -> Tuple[float, float, float]:
    """(T-FMA/s, ms, events ms) of the stencil kernel: images x h x w x c
    elements, reps x 9 multiply-adds each; ms by `graph_ms` (the card's
    time), events ms by CUDA events over 5 back-to-back calls."""
    x, wt = stencil_inputs(images, h, w, c, "cuda", variant)
    ms = graph_ms(lambda: stencil(x, wt, reps, variant))
    events = cuda_ms(lambda: stencil(x, wt, reps, variant), reps=5, warmup=1)
    return reps * 9 * x.numel() / (ms * 1e-3) / 1e12, ms, events


def stencil_ab(rounds: int, parent=None) -> Dict:
    """Each STENCIL_RUNS entry by `graph_ms` in `rounds` runs, with the
    floors module of a parent checkout alternating with this one (change,
    parent, then parent, change, ...), on the same inputs. Returns, per
    entry and per side, the runs, median and (min, max) ms, T-FMA/s at the
    median and the share of `stencil_bound` (bound / median)."""
    fns = {"change": stencil}
    if parent is not None:
        fns["parent"] = parent.stencil
    out = {}
    for label, variant, h, w, c, reps, images in STENCIL_RUNS:
        x, wt = stencil_inputs(images, h, w, c, "cuda", variant)
        runs = {k: [] for k in fns}
        for r in range(rounds):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                runs[k].append(graph_ms(lambda f=fns[k]: f(x, wt, reps, variant)))
        b_ms = stencil_bound(x.numel(), c, reps, variant)[0]
        out[label] = {"bound_ms": b_ms, **{
            k: {"runs": v, "median": _med(v), "spread": [min(v), max(v)],
                "tfmas": reps * 9 * x.numel() / (_med(v) * 1e-3) / 1e12,
                "share_of_bound": b_ms / _med(v)} for k, v in runs.items()}}
        del x, wt
    return out


def implied_dw_rates() -> Dict[str, float]:
    """The port's depthwise kernel's implied multiply-add rate, 9 x outputs
    over its time (HBM and the bias + ReLU6 epilogue inside the window), at
    two V1 1.0-224 layers, batch 256, bf16: T-FMA/s."""
    from .ops.depthwise import depthwise

    out = {}
    for label, (n, h, c) in (("dw_14x512", (256, 14, 512)), ("dw_28x256", (256, 28, 256))):
        x = torch.ones((n, h, h, c), dtype=torch.bfloat16, device="cuda")
        w = torch.ones((3, 3, 1, c), dtype=torch.bfloat16, device="cuda")
        b = torch.ones((c,), dtype=torch.bfloat16, device="cuda")
        ms = cuda_ms(lambda: depthwise(x, w, 1, b, relu6=True))
        out[label] = 9 * n * h * h * c / (ms * 1e-3) / 1e12
    return out


def mxu_rate(m: int = 8192, k: int = 8192, n: int = 8192) -> Tuple[float, float]:
    """(TFLOP/s, ms) of one bf16 torch.matmul."""
    a = torch.ones((m, k), dtype=torch.bfloat16, device="cuda")
    b = torch.ones((k, n), dtype=torch.bfloat16, device="cuda")
    ms = cuda_ms(lambda: a @ b, reps=5)
    return 2 * m * k * n / (ms * 1e-3) / 1e12, ms


def measure() -> Dict:
    """Every probe once at the audit geometries."""
    if not torch.cuda.is_available():
        raise RuntimeError("the floor probes measure a CUDA card; torch.cuda.is_available() "
                           "is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "hbm_copy_gbps": {}, "hbm_formulations": {}, "hbm_ms": {},
           "stencil_formulations": {}, "stencil_ms": {}, "published": PUBLISHED,
           "method": "the best probe kernel per unit; the library copy is a yardstick "
                     "beside it, not a floor"}
    res["stencil_events_ms"] = {}
    fns = copy_fns()
    for label, shape in AUDIT_SHAPES:
        rates = copy_rates(shape, fns)
        res["hbm_formulations"][label] = {k: v[0] for k, v in rates.items()}
        res["hbm_ms"][label] = {k: v[1] for k, v in rates.items()}
        res["hbm_copy_gbps"][label] = rates["hbm_copy_flat"][0]
        torch.cuda.empty_cache()
    for label, variant, h, w, c, reps, images in STENCIL_RUNS:
        tfma, ms, events = stencil_rate(variant, h, w, c, reps, images)
        res["stencil_formulations"][label] = tfma
        res["stencil_ms"][label] = ms
        res["stencil_events_ms"][label] = events
    # the float32 CUDA-core rate the roofline divides by: the best float32 variant
    res["stencil_tfmas"] = max(res["stencil_formulations"][lb]
                               for lb, variant, *_ in STENCIL_RUNS if variant != "bf16")
    res["implied_dw_tfmas"] = implied_dw_rates()
    res["mxu_tflops"], res["mxu_ms"] = mxu_rate()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT), help="where the JSON goes")
    ab = ap.add_mutually_exclusive_group()
    ab.add_argument("--copy-ab", type=int, default=0, metavar="ROUNDS",
                    help="only the copy probes against Tensor.copy_, in alternating runs")
    ab.add_argument("--stencil-ab", type=int, default=0, metavar="ROUNDS",
                    help="only the stencil runs, in alternating runs")
    ap.add_argument("--parent", metavar="DIR",
                    help="with an A/B: also the probes of the checkout unpacked at DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mobilenet_tpu_torch.floors measures the card; "
                         "torch.cuda.is_available() is False")
    if args.copy_ab or args.stencil_ab:
        parent = None
        if args.parent:
            from .block_times import load_parent  # noqa: PLC0415

            parent = load_parent(args.parent, ("floors",))[0]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        res = (copy_ab(args.copy_ab, copy_fns(parent)) if args.copy_ab
               else stencil_ab(args.stencil_ab, parent))
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                          "parent": args.parent, **res}), flush=True)
        return 0
    res = measure()
    print(res["nvidia_smi"], flush=True)
    for label, forms in res["hbm_formulations"].items():
        print(f"copy {label}: " + ", ".join(f"{k} {v:.1f} GB/s" for k, v in forms.items()))
    for label, tfma in res["stencil_formulations"].items():
        print(f"stencil [{label}]: {tfma:.3f} T-FMA/s ({res['stencil_ms'][label]:.4f} ms; "
              f"events {res['stencil_events_ms'][label]:.4f} ms)")
    for label, tfma in res["implied_dw_tfmas"].items():
        print(f"implied [{label}] depthwise kernel: {tfma:.3f} T-FMA/s")
    print(f"bf16 matmul 8192^3: {res['mxu_tflops']:.1f} TFLOP/s")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
