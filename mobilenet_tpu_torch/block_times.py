"""Times of the fused block kernels and the chains on the card.

    python -m mobilenet_tpu_torch.block_times [--batch 256 1] [--yardsticks] \
        [--int8 | --v3 | --v3-int8 | --v2 | --v2-int8 | --stem | --head | --dw [--int8]]
        [--float32] [--parent DIR]
    python -m mobilenet_tpu_torch.block_times --float32 --yardsticks --parent DIR
    python -m mobilenet_tpu_torch.block_times --float32 --plans [--batch 256 2 1]

At each block shape of MobileNet-V1 1.0-224 (and V2 1.0-224's linear block
0 at batch 256), and at the V1 chain's five blocks at batch 1, times the
bf16 `separable_block` (`chain`): CUDA events a call at batch 256,
torch.profiler's device time a call at batch 1 (a launch there is shorter
than its host work). With --yardsticks also the plain versions and the
unfused library sequence (`separable_library`, which the port never
calls). With --int8, instead the int8 `separable_block_i8` at the same V1
shapes and V2's linear block 0 (batch 256), given the K-major weight copy
where the wrapper takes one (`pw_wt`), and with --yardsticks its plain
version. With --v3, instead the bf16 `v3_block` at every distinct block
shape of MobileNet-V3-Large and -Small 1.0-224 ("v3l b03 256": its first
block of that shape, with "count", the blocks of one forward that have it)
and the two chains (`v3_chain` over V3-Small b1-b10 and V3-Large b1-b14),
with --yardsticks also the plain versions and the unfused library sequence
`v3_library` (never called by the port); with --float32 the float32 block
and chains instead. With --v3-int8, instead the int8
`v3_block_i8` at every distinct block shape of MobileNet-V3-Large and -Small
1.0-224 (names and counts as --v3), with "passes": torch.profiler's device
ms a call of each kernel it launches (an SE block's pool pass, gate and
gated pass), and with --yardsticks its plain version. With --v2, instead the
bf16 `inverted_residual` at every distinct expanded block shape of
MobileNet-V2 1.0-224 (blocks 1-16), with "passes" (as --v3-int8), and with
--yardsticks also its plain version and `v3_library` (relu6, k 3, no SE);
with --float32 the float32 block instead of bf16. --v2 and --v3 at batch
256 also give torch.profiler's device ms a call ("device_ms", and
"parent_device_ms" and "library_device_ms" where those run). With --v2-int8, instead the int8
`inverted_residual_i8` at the same V2 shapes, with "passes" (as --v3-int8:
the device ms of each kernel a call launches, x's pad copy included) and
with --yardsticks its plain version. With --stem, instead V1's two stem
kernels in bf16 and float32 at 1.0-224, and float32 `stem_block0` at 1.0-160
too ("stem_conv bf16 224 256", "stem_block0 f32 160 1"), at batch 256, 2
and 1 unless --batch says otherwise: `stem_conv` (a normalized input -> 32
channels) and `stem_block0` (uint8 images -> block 0's 64 channels), each
call on an input out of the L2 (`floors.cold_copies`), with
torch.profiler's device ms at batch 256 ("device_ms"), the bound, and with
--yardsticks also their plain versions, cuDNN's stem (`ops/conv.conv2d_same`)
beside `stem_conv` and beside `stem_block0` the unfused sequence it replaces
(preprocess, `conv2d_same`, `separable_block` b00). With --head, instead the bf16
`fused_head` in each of its forms at 1.0-224 ("head v1 256", "head v3s 1":
V1's pool -> fc, V2's conv_last + ReLU6 -> pool -> fc, V3-Large's and
V3-Small's conv_last + hswish -> pool -> head + hswish -> fc) and V2 alpha
1.4's ("head v2a14 256"), at batch 256,
64, 8 and 1 unless --batch says otherwise: CUDA events a call at every
batch ("ms"), the host ms a call takes to return ("host_ms"),
torch.profiler's device ms a call ("device_ms") and of each kernel it
launches ("passes"), the bound ("bound_ms", "bound_by"), and with
--yardsticks its plain version and the library sequence `head_library`
(mean -> addmm; for V2 and V3 first matmul + act, and matmul + act between;
never called by the port), by events and by device ms
("library_device_ms"); with --float32 the float32 head instead. With --dw,
instead the standalone depthwise kernel
at each distinct depthwise layer shape of MobileNet-V1 1.0-224 ("b06 256",
with "count", the layers of one forward that have it), at batch 256 and 2
unless --batch says otherwise: bf16 `depthwise` (--float32: float32; --int8:
`depthwise_i8`, ReLU6 at six_q 127), with cuDNN's two calls beside the
float forms (`F.conv2d(groups=C)` on the channels-last view, then
`clamp_`: "library_ms", a yardstick the port never calls), the bound
("bound_ms", "bound_by"), and with --parent DIR the same wrapper of the
checkout unpacked at DIR (`git archive` of an earlier commit; its kernels
built there) timed in the same process ("parent_ms"); for the kernel (and
the parent) the host ms a call takes to return ("host_ms") and at batch 256
torch.profiler's device ms a call ("device_ms"; at batch 2 "ms" is that
already); a "sum <batch>" row adds each time over one forward's 13 layers. Prints one JSON line: the card
and {"b00 256": {"ms": ...}, ...}.
With --float32 and no kind, instead the float32 `separable_block` at V1
1.0-224's distinct block shapes ("b06 256", with "count"; "sum <batch>"
over the 13 blocks), V2's linear block 0 ("v2b00 <batch>") and the V1
chain's five blocks ("chain <batch>" where `chain_fits`: not at 256) at
batch 256, 2 and 1 unless --batch
says otherwise: events at batch 256 and torch.profiler's device ms at every
batch ("device_ms"), with --yardsticks the plain versions and
`separable_library` with TF32 off, and the bound (`block_bound`).
With --float32 --plans, instead every candidate plan that `f32_sep_plan`
weighs at those block shapes (not the chain), each by CUDA events over a
CUDA graph of its launches: per shape the plan's pick and the fastest
candidate, and the geometric mean and worst of their ratio ("fit"); this
mode launches the C entry with each plan.
With --float32, --v2, --v3, --stem and --head, --parent DIR likewise times
the wrappers of the checkout at DIR beside ("parent_ms"; --head and --stem
also "parent_device_ms", --head "parent_passes"). Every float32 library
sequence runs with cuDNN's and cuBLAS's TF32 off (`ops/conv.no_tf32`), IEEE
float32 as the kernels.
Else it calls only the kernels' public wrappers, so this file copied into an
archive of an earlier commit times that commit's kernels (PERF.md's A/B:
parent, change, change, parent in one card call). Refuses to run without a
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def separable_library(x, dw_w, dw_b, pw_w, pw_b, stride, relu6=True, pw_act=True):
    """The unfused library sequence of a separable block, a yardstick the
    port never calls: returns a function that runs cuDNN's grouped 3x3 conv
    on the channels-last view with TF-SAME padding (stride 2 on an even
    input: F.pad at the high end) + dw bias, clamp, then torch.matmul,
    + pw bias, clamp (none in the linear mode)."""
    import torch.nn.functional as F  # noqa: PLC0415

    c = x.shape[-1]
    wl = dw_w.reshape(3, 3, c).permute(2, 0, 1).unsqueeze(1).contiguous()
    hi = 6.0 if relu6 else None

    def run():
        xn = x.permute(0, 3, 1, 2)
        if stride == 2:
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), wl, dw_b, 2, 0, 1, c)
        else:
            y = F.conv2d(xn, wl, dw_b, 1, 1, 1, c)
        y = y.clamp_(0, hi).permute(0, 2, 3, 1).reshape(-1, c)
        z = torch.matmul(y, pw_w).add_(pw_b)
        return z.clamp_(0, hi) if pw_act else z

    return run


def v3_library(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, *, k, stride, act, se_w1=None,
               se_b1=None, se_w2=None, se_b2=None, residual=False):
    """The unfused library sequence of a V3 bottleneck, a yardstick the port
    never calls: returns a function that runs torch.matmul + bias + act for
    the expansion (none for the identity), cuDNN's grouped k x k conv on the
    channels-last view with TF-SAME padding (stride 2 on an even input:
    F.pad (k-2)//2 low and the rest high) + bias + act, the SE in torch ops
    (mean, matmul + bias, relu, matmul + bias, hardsigmoid, multiply), then
    torch.matmul + bias for the projection, + the residual."""
    import torch.nn.functional as F  # noqa: PLC0415

    acts = {"relu": F.relu_, "relu6": lambda t: t.clamp_(0, 6), "hswish": F.hardswish}
    fn = acts[act]
    n, h, w, cin = x.shape
    e = dw_w.shape[-1]
    wl = dw_w.reshape(k, k, e).permute(2, 0, 1).unsqueeze(1).contiguous()
    lo = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    hi = k - 1 - lo if stride == 1 else k - 2 - lo

    def run():
        z = x.reshape(-1, cin)
        if exp_w is not None:
            z = fn(torch.matmul(z, exp_w).add_(exp_b))
        z = z.reshape(n, h, w, e).permute(0, 3, 1, 2)
        y = fn(F.conv2d(F.pad(z, (lo, hi, lo, hi)), wl, dw_b, stride, 0, 1, e))
        if se_w1 is not None:
            g = F.relu_(torch.matmul(y.mean((2, 3)), se_w1).add_(se_b1))
            g = F.hardsigmoid(torch.matmul(g, se_w2).add_(se_b2))
            y = y * g[:, :, None, None]
        ho, wo = y.shape[2], y.shape[3]
        y = y.permute(0, 2, 3, 1).reshape(-1, e)
        out = torch.matmul(y, prj_w).add_(prj_b).reshape(n, ho, wo, -1)
        return out.add_(x) if residual else out

    return run


def head_library(x, conv, post):
    """The library sequence of a fused head, a yardstick the port never
    calls: returns a function that runs [torch.addmm + act for conv_last on
    the (N*H*W, C) view], the mean over H*W, then torch.addmm + act for each
    post matmul, all in x's dtype."""
    import torch.nn.functional as F  # noqa: PLC0415

    acts = {"linear": lambda t: t, "relu": F.relu_, "relu6": lambda t: t.clamp_(0, 6),
            "hswish": F.hardswish}
    n, h, w, c = x.shape

    def run():
        y = x.reshape(n, h * w, c)
        if conv is not None:
            y = acts[conv[2]](torch.addmm(conv[1], x.reshape(-1, c), conv[0]))
            y = y.reshape(n, h * w, -1)
        y = y.mean(1)
        for pw, pb, act in post:
            y = acts[act](torch.addmm(pb, y, pw))
        return y

    return run


def ieee(fn, x):
    """fn() with cuDNN's and cuBLAS's TF32 off while x is float32 (IEEE
    float32, as the port's float32 kernels compute), a yardstick of the same
    function."""
    from .ops.conv import no_tf32  # noqa: PLC0415

    def run():
        with no_tf32(x):
            return fn()

    return run


# The models' head forms at 1.0-224, and V2 alpha 1.4's (448 -> 1792), on 7 x 7
# features: C, conv_last (E, act) or None, post matmuls [(width, act)]. The
# tests and chip_smoke.py take them from here.
HEAD_FORMS = {
    "v1": (1024, None, [(1000, "linear")]),
    "v2": (320, (1280, "relu6"), [(1000, "linear")]),
    "v3l": (160, (960, "hswish"), [(1280, "hswish"), (1000, "linear")]),
    "v3s": (96, (576, "hswish"), [(1024, "hswish"), (1000, "linear")]),
    "v2a14": (448, (1792, "relu6"), [(1000, "linear")]),
}
HEAD_HW = 7


def head_bound(n, c, conv, posts, hw=HEAD_HW, kind="bf16"):
    """(bound_ms, bound_by) of one head call: the features, every weight and
    bias and the output moved once over 3.35 TB/s, or its multiply-adds (x 2)
    and the pool's adds over 989 TFLOP/s (bf16; float32: 67 TFLOP/s and 4
    bytes an element), the larger."""
    pix = n * hw * hw
    k = c if conv is None else conv[0]
    nbytes = pix * c + (0 if conv is None else c * k + k)
    ops = (0 if conv is None else 2 * pix * c * k) + pix * k
    for m, _ in posts:
        nbytes += k * m + m
        ops += 2 * n * k * m
        k = m
    item, rate = (4, 67e12) if kind == "f32" else (2, 989e12)
    t_b, t_o = (nbytes + n * k) * item / 3.35e12 * 1e3, ops / rate * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def head_operands(gen, n, c, conv, posts, dtype=torch.bfloat16, hw=HEAD_HW):
    """(x, conv, post) on the card: x in [0, 6) (a ReLU6 activation),
    weights k^-0.5, biases 0.1."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    x = (torch.rand(n, hw, hw, c, generator=gen, device="cuda") * 6).to(dtype)
    k, layer = c, None
    if conv is not None:
        layer = (r(c, conv[0], scale=c ** -0.5), r(conv[0], scale=0.1), conv[1])
        k = conv[0]
    post = []
    for m, act in posts:
        post.append((r(k, m, scale=k ** -0.5), r(m, scale=0.1), act))
        k = m
    return x, layer, post


def head_times(args, gen) -> dict:
    """The bf16 (--float32: float32) `fused_head` in each form at each
    batch, through the public wrapper only; with --parent also the parent
    checkout's wrapper ("parent_ms", "parent_device_ms", "parent_passes")."""
    from .floors import cuda_ms  # noqa: PLC0415
    from .ops.head import fused_head, fused_head_plain  # noqa: PLC0415

    dtype = torch.float32 if args.float32 else torch.bfloat16
    parent = load_parent(args.parent, ("ops.head",))[0] if args.parent else None
    out = {}
    for form, (c, conv, posts) in HEAD_FORMS.items():
        for batch in args.batch:
            a = head_operands(gen, batch, c, conv, posts, dtype)
            calls = {"ms": lambda a=a: fused_head(*a)}
            if parent:
                calls["parent_ms"] = lambda a=a: parent.fused_head(*a)
            if args.yardsticks:
                calls["plain_ms"] = lambda a=a: fused_head_plain(*a)
                calls["library_ms"] = ieee(head_library(*a), a[0])
            row = {k: cuda_ms(f, reps=50, warmup=5) for k, f in calls.items()}
            row["host_ms"] = host_ms(calls["ms"])
            for k in [k for k in ("ms", "parent_ms", "library_ms") if k in calls]:
                pre = {"ms": "", "parent_ms": "parent_", "library_ms": "library_"}[k]
                row[f"{pre}device_ms"] = device_ms(calls[k])
                if k != "library_ms":
                    row[f"{pre}passes"] = kernel_ms(calls[k])
            row["bound_ms"], row["bound_by"] = head_bound(batch, c, conv, posts,
                                                          kind="f32" if args.float32 else "bf16")
            out[f"head {form} {batch}"] = row
            del a, calls
            torch.cuda.empty_cache()
    return out


def host_ms(fn, reps: int = 50) -> float:
    """Host ms a call of fn spends before it returns (the wrapper's checks
    and launches), with the card's queue far from full."""
    import time  # noqa: PLC0415

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def kernel_ms(fn, reps: int = 30, tries: int = 3) -> dict:
    """torch.profiler's device ms a call of fn, by kernel (the name up to
    its arguments), after warm-up. The profiler can lose some of a session's
    kernel records (on the H100 a few sessions in a hundred: a sum then reads
    low): a session in which a kernel's count is not a whole multiple of
    `reps`, or that recorded none, is run again, at most `tries` times."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, whole = {}, True
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                whole = whole and e.count % reps == 0
                name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
                name = name.split("(")[0].strip()
                out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
        if whole and out:
            return out
    raise RuntimeError(f"torch.profiler lost kernel records in {tries} sessions of {reps} calls")


def device_ms(fn, reps: int = 30) -> float:
    """torch.profiler's device ms a call of fn (all its kernels), after
    warm-up."""
    return sum(kernel_ms(fn, reps).values())


def dw_bound(n, h, c, stride, kind):
    """(bound_ms, bound_by) of one depthwise call on (n, h, h, c): the input,
    the weights (+ int32 biases and float32 multipliers in int8) and the
    output moved once over 3.35 TB/s, or its 9 multiply-adds an output (x 2)
    over the CUDA cores' 67 TFLOP/s float32 rate (int8: the data sheet's
    1,979 TOP/s), the larger."""
    ho = -(-h // stride)
    act, wbytes = {"int8": (1, 9 + 8), "bf16": (2, 20), "f32": (4, 40)}[kind]
    nbytes = (n * h * h + n * ho * ho) * c * act + c * wbytes
    t_b = nbytes / 3.35e12 * 1e3
    t_o = 18 * n * ho * ho * c / (1979e12 if kind == "int8" else 67e12) * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def load_parent(root: str, mods=("ops.depthwise", "ops.depthwise_i8")):
    """The modules `mods` (default `ops.depthwise` and `ops.depthwise_i8`)
    of the checkout at `root`, imported as the package
    `parent_mobilenet_tpu_torch` beside this one (its relative imports stay
    inside it; its kernels build under root/build)."""
    import importlib  # noqa: PLC0415
    import importlib.util  # noqa: PLC0415
    import sys  # noqa: PLC0415
    from pathlib import Path  # noqa: PLC0415

    pkg = Path(root).resolve() / "mobilenet_tpu_torch"
    name = "parent_mobilenet_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.{m}") for m in mods)


def dw_times(cfg, args, gen, times) -> dict:
    """The standalone depthwise kernel (bf16, float32 or int8) at V1's
    distinct depthwise layer shapes, through the public wrappers only."""
    import torch.nn.functional as F  # noqa: PLC0415

    from .ops.conv import no_tf32  # noqa: PLC0415
    from .ops.depthwise import depthwise, depthwise_plain  # noqa: PLC0415
    from .ops.depthwise_i8 import depthwise_i8, depthwise_i8_plain  # noqa: PLC0415

    parent = load_parent(args.parent) if args.parent else None
    kind = "int8" if args.int8 else "f32" if args.float32 else "bf16"
    dtype = torch.float32 if args.float32 else torch.bfloat16
    shapes = {}  # (h, c, stride) -> [name, count]
    h, cin = cfg.resolution // 2, cfg.stem_channels
    for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
        shapes.setdefault((h, cin, stride), [f"b{i:02d}", 0])[1] += 1
        h, cin = -(-h // stride), cout
    out = {}
    for batch in args.batch:
        total = {}
        for (h, c, stride), (name, count) in shapes.items():
            if kind == "int8":
                def ints(lo, hi, *shape, dtype=torch.int8):
                    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                                         dtype=dtype)

                m = (torch.rand(c, generator=gen, device="cuda") * 1.3 + 0.2) * 4e-3
                a = (ints(0, 128, batch, h, h, c), ints(-127, 128, 3, 3, 1, c),
                     ints(-5000, 5000, c, dtype=torch.int32), m, 127.0, stride, True)
                calls = {"ms": lambda a=a: depthwise_i8(*a)}
                if parent:
                    calls["parent_ms"] = lambda a=a: parent[1].depthwise_i8(*a)
                if args.yardsticks:
                    calls["plain_ms"] = lambda a=a: depthwise_i8_plain(*a)
            else:
                x = (torch.rand(batch, h, h, c, generator=gen, device="cuda") * 4 - 2)
                w = torch.randn(3, 3, 1, c, generator=gen, device="cuda") * 0.5
                b = torch.randn(c, generator=gen, device="cuda") * 0.2
                a = (x.to(dtype), w.to(dtype), stride, b.to(dtype), True)
                xn = a[0].permute(0, 3, 1, 2)  # NCHW view of the NHWC data: channels-last
                wl = a[1].reshape(3, 3, c).permute(2, 0, 1).unsqueeze(1).contiguous()

                def library(xn=xn, wl=wl, b=a[3], stride=stride, c=c):
                    with no_tf32(xn):
                        return F.conv2d(xn, wl, b, stride, 1, 1, c).clamp_(0, 6)

                calls = {"ms": lambda a=a: depthwise(*a)}
                if parent:
                    calls["parent_ms"] = lambda a=a: parent[0].depthwise(*a)
                calls["library_ms"] = library
                if args.yardsticks:
                    calls["plain_ms"] = lambda a=a: depthwise_plain(*a)
            row = times(batch, calls)
            for k in [k for k in ("ms", "parent_ms") if k in calls]:
                pre = k[:-2]
                row[f"{pre}host_ms"] = host_ms(calls[k])
                if batch == 256:
                    row[f"{pre}device_ms"] = device_ms(calls[k])
            row["bound_ms"], row["bound_by"] = dw_bound(batch, h, c, stride, kind)
            row["count"] = count
            out[f"{name} {batch}"] = row
            for k, v in row.items():
                if k.endswith("_ms") or k == "ms":
                    total[k] = total.get(k, 0.0) + count * v
            del a, calls
            torch.cuda.empty_cache()
        out[f"sum {batch}"] = total
    return out


def int8_times(cfg, args, gen, times) -> dict:
    """`separable_block_i8` (ReLU6) at V1's block shapes and, at batch 256,
    in the linear mode at V2 1.0-224's block 0 (112^2 x 32 -> 16): random
    int8 operands (x in [0, 127], biases within 5000, multipliers that
    spread the requantized values), through the public wrapper only."""
    import inspect  # noqa: PLC0415

    from .ops.separable_block_i8 import (  # noqa: PLC0415
        separable_block_i8, separable_block_i8_plain,
    )

    takes_wt = "pw_wt" in inspect.signature(separable_block_i8).parameters

    def operands(n, h, cin, cout):
        def ints(lo, hi, *shape, dtype=torch.int8):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)

        def mult(c, scale):
            return (torch.rand(c, generator=gen, device="cuda") * 1.3 + 0.2) * scale

        pw_w = ints(-127, 128, cin, cout)
        return ((ints(0, 128, n, h, h, cin), ints(-127, 128, 3, 3, 1, cin),
                 ints(-5000, 5000, cin, dtype=torch.int32), mult(cin, 4e-3), pw_w,
                 ints(-5000, 5000, cout, dtype=torch.int32), mult(cout, 2 / 60 / cin ** 0.5)),
                {"pw_wt": pw_w.t().contiguous()} if takes_wt else {})

    def calls(a, kw, stride, linear):
        six = (127.0, 0.0) if linear else (127.0, 127.0)
        out = {"ms": lambda: separable_block_i8(*a, stride, *six, True, linear, **kw)}
        if args.yardsticks:
            out["plain_ms"] = lambda: separable_block_i8_plain(*a, stride, *six, True, linear)
        return out

    out = {}
    for batch in args.batch:
        h, cin = cfg.resolution // 2, cfg.stem_channels
        for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
            a, kw = operands(batch, h, cin, cout)
            out[f"b{i:02d} {batch}"] = times(batch, calls(a, kw, stride, False))
            h, cin = -(-h // stride), cout
    if 256 in args.batch:
        a, kw = operands(256, 112, 32, 16)
        out["v2b00 256"] = times(256, calls(a, kw, 1, True))
    return out


def bf16_times(cfg, args, gen, times) -> dict:
    """The bf16 `separable_block` at V1's block shapes, V2's linear block 0
    (batch 256), and the V1 chain's five blocks (batch 1)."""
    from .ops.chain import chain, chain_plain  # noqa: PLC0415
    from .ops.separable_block import separable_block, separable_block_plain  # noqa: PLC0415

    def operands(n, h, cin, cout, k=None):
        def r(*shape, scale=1.0):
            t = torch.randn(*shape, generator=gen, device="cuda") * scale
            return t.bfloat16().contiguous()

        x = (torch.rand(n, h, h, cin, generator=gen, device="cuda") * 2 - 1).bfloat16()
        if k:
            return (x, r(k, 3, 3, cin, scale=0.5), r(k, cin, scale=0.2),
                    r(k, cin, cin, scale=cin ** -0.5), r(k, cin, scale=0.2))
        return (x, r(3, 3, 1, cin, scale=0.5), r(cin, scale=0.2),
                r(cin, cout, scale=cin ** -0.5), r(cout, scale=0.2))

    out = {}
    for batch in args.batch:
        h, cin = cfg.resolution // 2, cfg.stem_channels
        for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
            a = operands(batch, h, cin, cout)
            calls = {"ms": lambda a=a, s=stride: separable_block(*a, s, True)}
            if args.yardsticks:
                calls["plain_ms"] = lambda a=a, s=stride: separable_block_plain(*a, s, True)
                calls["library_ms"] = separable_library(*a, stride, True)
            out[f"b{i:02d} {batch}"] = times(batch, calls)
            h, cin = -(-h // stride), cout
    if 256 in args.batch:
        a = operands(256, 112, 32, 16)
        calls = {"ms": lambda: separable_block(*a, 1, True, pw_act=False)}
        if args.yardsticks:
            calls["plain_ms"] = lambda: separable_block_plain(*a, 1, True, pw_act=False)
            calls["library_ms"] = separable_library(*a, 1, True, pw_act=False)
        out["v2b00 256"] = times(256, calls)
    if 1 in args.batch:
        a = operands(1, 14, 512, 512, k=5)
        calls = {"ms": lambda: chain(*a, True)}
        if args.yardsticks:
            calls["plain_ms"] = lambda: chain_plain(*a, True)
        out["chain 1"] = times(1, calls)
    return out


def block_bound(n, h, cin, cout, stride, k=1):
    """(bound_ms, bound_by) of k float32 separable blocks on (n, h, h, cin):
    the input, the weights and the output moved once over 3.35 TB/s, or the
    blocks' multiply-adds (9 a depthwise output and Cin a pointwise output,
    x 2) over the CUDA cores' 67 TFLOP/s, the larger (chip_smoke.py's
    `block_work` in float32)."""
    ho = -(-h // stride)
    pix_out = n * ho * ho
    nbytes = 4 * (n * h * h * cin + k * (10 * cin + cin * cout + cout) + pix_out * cout)
    ops = k * (2 * 9 * pix_out * cin + 2 * pix_out * cin * cout)
    t_b, t_o = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def f32_operands(gen, n, h, cin, cout, k=None):
    """Seeded float32 operands of a separable block (x, dw_w, dw_b, pw_w, pw_b)
    on the card, or with k those of a k-block chain of C -> C blocks."""
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).contiguous()

    x = (torch.rand(n, h, h, cin, generator=gen, device="cuda") * 2 - 1).contiguous()
    if k:
        return (x, r(k, 3, 3, cin, scale=0.5), r(k, cin, scale=0.2),
                r(k, cin, cin, scale=cin ** -0.5), r(k, cin, scale=0.2))
    return (x, r(3, 3, 1, cin, scale=0.5), r(cin, scale=0.2),
            r(cin, cout, scale=cin ** -0.5), r(cout, scale=0.2))


def f32_blocks(cfg) -> list:
    """(name, count, h, cin, cout, stride, pw_act) of V1's distinct block
    shapes ("b06" the first block of its shape, count the blocks of one
    forward that have it), then V2 1.0-224's linear block 0 (count 0)."""
    shapes = {}  # (h, cin, cout, stride) -> [name, count]
    h, cin = cfg.resolution // 2, cfg.stem_channels
    for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
        shapes.setdefault((h, cin, cout, stride), [f"b{i:02d}", 0])[1] += 1
        h, cin = -(-h // stride), cout
    return ([(name, count, h, ci, co, s, True) for (h, ci, co, s), (name, count)
             in shapes.items()] + [("v2b00", 0, 112, 32, 16, 1, False)])


def f32_plan_times(cfg, args, gen) -> dict:
    """With --float32 --plans: every candidate plan that `f32_sep_plan` weighs
    (`f32_sep_candidates`) at V1 1.0-224's distinct block shapes and V2's
    linear block 0, at each batch, each by `floors.graph_ms` (CUDA events over
    a CUDA graph of 10 launches: the card's time). Per shape ("b06 2"):
    the plan's pick and its ms, the fastest candidate and its ms, their
    ratio and the candidates' count; then each batch's and all shapes'
    geometric mean and worst of the ratios ("fit <batch>", "fit")."""
    import math  # noqa: PLC0415

    from .floors import graph_ms  # noqa: PLC0415
    from .ops import _build  # noqa: PLC0415
    from .ops.separable_block import f32_sep_candidates, f32_sep_plan  # noqa: PLC0415

    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, ratios = {}, {}
    for batch in args.batch:
        for name, _, h, ci, co, stride, act in f32_blocks(cfg):
            a = f32_operands(gen, batch, h, ci, co)
            y = torch.empty((batch, -(-h // stride), -(-h // stride), co), device="cuda")
            head = [t.data_ptr() for t in a] + [y.data_ptr(), batch, h, h, ci, co, stride, 1,
                                                int(act)]

            def launch(plan, head=head):
                code = lib.separable_block_f32(*head, *plan,
                                               torch.cuda.current_stream().cuda_stream)
                _build.check(lib, code, "separable_block_f32")

            plans = list(dict.fromkeys(  # a tile two pixel budgets reach is timed once
                plan for _, plan in f32_sep_candidates(batch, h, h, ci, co, stride, sms)))
            ms = {plan: graph_ms(lambda plan=plan: launch(plan), reps=10) for plan in plans}
            pick = f32_sep_plan(batch, h, h, ci, co, stride, sms)
            best = min(ms, key=ms.get)
            ratios.setdefault(batch, []).append(ms[pick] / ms[best])
            out[f"{name} {batch}"] = {"pick": list(pick), "pick_ms": ms[pick],
                                      "best": list(best), "best_ms": ms[best],
                                      "ratio": ms[pick] / ms[best], "candidates": len(plans)}
            del a, y
            torch.cuda.empty_cache()

    def fit(rs):
        return {"geomean": math.exp(sum(map(math.log, rs)) / len(rs)), "worst": max(rs)}

    for batch, rs in ratios.items():
        out[f"fit {batch}"] = fit(rs)
    out["fit"] = fit([r for rs in ratios.values() for r in rs])
    return out


def f32_times(cfg, args, gen, times) -> dict:
    """The float32 `separable_block` at V1 1.0-224's distinct block shapes
    ("b06 256", with "count", the blocks of one forward that have it; a "sum
    <batch>" row over the 13 blocks), V2 1.0-224's linear block 0 ("v2b00
    <batch>") and the V1 chain's five blocks ("chain <batch>", at the
    batches where one launch takes them: `chain_fits`), at each batch: CUDA
    events ("ms" at batch 256) and torch.profiler's device ms a call
    ("device_ms"; at other batches "ms" is that already), with --parent
    the same wrappers of the checkout at DIR ("parent_ms", "parent_device_ms"),
    with --yardsticks the plain versions and the library sequence
    `separable_library` with TF32 off ("library_ms", "library_device_ms"),
    and the bound."""
    from .ops.chain import chain, chain_fits, chain_plain  # noqa: PLC0415
    from .ops.separable_block import separable_block, separable_block_plain  # noqa: PLC0415

    parent = (load_parent(args.parent, ("ops.separable_block", "ops.chain"))
              if args.parent else None)

    def row(batch, calls, bound):
        got = times(batch, calls)
        for k in [k for k in ("ms", "parent_ms", "library_ms") if k in calls]:
            got[f"{k[:-2]}device_ms"] = (got[k] if batch != 256
                                         else device_ms(calls[k], reps=10))
        got["bound_ms"], got["bound_by"] = bound
        return got

    out = {}
    for batch in args.batch:
        total = {}
        for name, count, h, ci, co, stride, act in f32_blocks(cfg):
            a = f32_operands(gen, batch, h, ci, co)
            kw = dict(pw_act=act)
            calls = {"ms": lambda a=a, s=stride, kw=kw: separable_block(*a, s, True, **kw)}
            if parent:
                calls["parent_ms"] = lambda a=a, s=stride, kw=kw: (
                    parent[0].separable_block(*a, s, True, **kw))
            if args.yardsticks:
                calls["plain_ms"] = lambda a=a, s=stride, kw=kw: (
                    separable_block_plain(*a, s, True, **kw))
                calls["library_ms"] = ieee(separable_library(*a, stride, True, **kw), a[0])
            got = {**row(batch, calls, block_bound(batch, h, ci, co, stride)), "count": count}
            out[f"{name} {batch}"] = got
            for k, v in got.items():
                if count and (k.endswith("_ms") or k == "ms"):
                    total[k] = total.get(k, 0.0) + count * v
            del a, calls
            torch.cuda.empty_cache()
        out[f"sum {batch}"] = total
        if not chain_fits(batch, 14, 14, 512, 5, 4):
            continue  # the route runs per-block kernels there (batch 256)
        a = f32_operands(gen, batch, 14, 512, 512, k=5)
        calls = {"ms": lambda a=a: chain(*a, True)}
        if parent:
            calls["parent_ms"] = lambda a=a: parent[1].chain(*a, True)
        if args.yardsticks:
            calls["plain_ms"] = lambda a=a: chain_plain(*a, True)
        out[f"chain {batch}"] = row(batch, calls, block_bound(batch, 14, 512, 512, 1, k=5))
        del a, calls
        torch.cuda.empty_cache()
    return out


def stem_work(n, h, cout, kind, block0=True):
    """(bytes, ops_ms) of the fused stem kernel (block0=True: uint8 images
    (n, h, h, 3) in, block 0's output out) or the stem alone (a float input
    in, the stem output out): the input and output once, the weights once.
    The fused kernel's stem and depthwise multiply-adds count at the CUDA
    cores' float32 rate (67 TFLOP/s; it runs both there, the stem as exact
    multiply-add chains), its pointwise at its dtype's rate. The stem alone
    runs on the tensor cores in bf16 (an im2col product, K = 27 taps padded
    to 32): its multiply-adds count at the bf16 rate there (989 TFLOP/s), at
    the float32 rate in float32."""
    act = 2 if kind == "bf16" else 4
    peak = 989e12 if kind == "bf16" else 67e12
    hs = h // 2
    pix = n * hs * hs
    c1 = 32 if block0 else cout
    stem_ops = 2 * 27 * pix * c1
    if not block0:
        nbytes = n * h * h * 3 * act + (27 * cout + cout) * act + pix * cout * act
        return nbytes, stem_ops / peak * 1e3
    weights = (27 * c1 + c1 + 9 * c1 + c1 + c1 * cout + cout) * act
    nbytes = n * h * h * 3 + weights + pix * cout * act
    return nbytes, ((stem_ops + 2 * 9 * pix * c1) / 67e12 + 2 * pix * c1 * cout / peak) * 1e3


def stem_bound(n, h, cout, kind, block0):
    """(bound_ms, bound_by) of a stem kernel call: `stem_work`'s bytes over
    3.35 TB/s or its operations' time, the larger."""
    nbytes, t_o = stem_work(n, h, cout, kind, block0)
    t_b = nbytes / 3.35e12 * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def stem_times(cfg, args, gen, times) -> dict:
    """`stem_conv` and `stem_block0` at V1 1.0-224 in bf16 and float32, and
    float32 `stem_block0` at 1.0-160 (the largest size the float32 route
    fuses), through their public wrappers only: random seeded weights scaled
    so that part of each ReLU6 saturates, the last input row and column at
    their largest value (beside the TF-SAME pad). Each call reads its input
    from `floors.cold_copies`, in turn, so a small batch's input is not read
    from the L2. "ms" as `times`; "device_ms": torch.profiler's device ms a
    call (`kernel_ms`, all kernels) at batch 256 ("ms" itself at the other
    batches, as `times` reads it); with --parent the parent checkout's
    wrapper beside ("parent_ms", "parent_device_ms"); with --yardsticks the
    plain version, cuDNN's stem (`ops/conv.conv2d_same`, TF32 off) beside
    `stem_conv` and beside `stem_block0` the unfused sequence it replaces
    (preprocess, `conv2d_same`, `separable_block` b00), the yardstick's
    device ms too; the bound (`stem_bound`)."""
    from .floors import cold_copies  # noqa: PLC0415
    from .ops.conv import conv2d_same  # noqa: PLC0415
    from .ops.preprocess import preprocess  # noqa: PLC0415
    from .ops.separable_block import separable_block  # noqa: PLC0415
    from .ops.stem import (  # noqa: PLC0415
        stem_block0, stem_block0_plain, stem_conv, stem_conv_plain,
    )

    parent = load_parent(args.parent, ("ops.stem",))[0] if args.parent else None
    c1, cout = cfg.stem_channels, cfg.block_channels[0]

    def r(dt, *shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)

    def in_turn(fn, xs):
        i = [0]

        def call():
            i[0] = (i[0] + 1) % len(xs)
            return fn(xs[i[0]])
        return call

    def measure(batch, calls, bound):
        got = times(batch, calls)
        for k in ("ms", "parent_ms", "library_ms", "unfused_ms"):
            if k in calls and batch == 256:  # else "ms" is the device time already
                got[f"{k[:-2]}device_ms"] = device_ms(calls[k], reps=30)
        got["bound_ms"], got["bound_by"] = bound
        return got

    def conv(batch, res, tag, dt):
        x = (torch.rand(batch, res, res, 3, generator=gen, device="cuda") * 2 - 1).to(dt)
        x[:, -1] = 1
        x[:, :, -1] = 1
        xs = cold_copies(x)
        ws, bs = r(dt, 3, 3, 3, c1, scale=0.8), r(dt, c1, scale=0.2)
        calls = {"ms": in_turn(lambda v: stem_conv(v, ws, bs, True), xs)}
        if parent:
            calls["parent_ms"] = in_turn(lambda v: parent.stem_conv(v, ws, bs, True), xs)
        if args.yardsticks:
            calls["plain_ms"] = lambda: stem_conv_plain(x, ws, bs, True)
            calls["library_ms"] = in_turn(
                lambda v: conv2d_same(v, ws, 2, bias=bs, relu6=True), xs)
        return measure(batch, calls, stem_bound(batch, res, c1, tag, False))

    def block0(batch, res, tag, dt):
        imgs = torch.randint(0, 256, (batch, res, res, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)
        imgs[:, -1] = 255
        imgs[:, :, -1] = 255
        xs = cold_copies(imgs)
        w = (r(dt, 3, 3, 3, c1, scale=0.4), r(dt, c1, scale=0.2), r(dt, 3, 3, 1, c1, scale=0.5),
             r(dt, c1, scale=0.2), r(dt, c1, cout, scale=3 * c1 ** -0.5), r(dt, cout, scale=0.2))

        def unfused(v):
            y = conv2d_same(preprocess(v, res, dt), w[0], 2, bias=w[1], relu6=True)
            return separable_block(y, w[2], w[3], w[4], w[5], 1, True)

        calls = {"ms": in_turn(lambda v: stem_block0(v, *w, True), xs)}
        if parent:
            calls["parent_ms"] = in_turn(lambda v: parent.stem_block0(v, *w, True), xs)
        if args.yardsticks:
            calls["plain_ms"] = lambda: stem_block0_plain(imgs, *w, True)
            calls["unfused_ms"] = in_turn(unfused, xs)
        return measure(batch, calls, stem_bound(batch, res, cout, tag, True))

    out = {}
    for batch in args.batch:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            out[f"stem_conv {tag} 224 {batch}"] = conv(batch, 224, tag, dt)
            torch.cuda.empty_cache()
            for res in (224, 160) if tag == "f32" else (224,):
                out[f"stem_block0 {tag} {res} {batch}"] = block0(batch, res, tag, dt)
                torch.cuda.empty_cache()
    return out


def v3_times(args, gen, times) -> dict:
    """The bf16 (--float32: float32) `v3_block` at each distinct block shape
    of V3-Large and V3-Small 1.0-224 and `v3_chain` over V3-Small b1-b10 and
    V3-Large b1-b14, through the public wrappers only: x in [-2, 2), weights
    scaled so that the activations stay O(1), SE biases non-zero; with
    --parent also the parent checkout's wrappers ("parent_ms")."""
    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415
    from .ops.v3_block import v3_block, v3_block_plain  # noqa: PLC0415
    from .ops.v3_chain import v3_chain, v3_chain_plain  # noqa: PLC0415

    dtype = torch.float32 if args.float32 else torch.bfloat16
    parent = load_parent(args.parent, ("ops.v3_block", "ops.v3_chain")) if args.parent else None

    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def weights(bd):
        e, k, se = bd.cexp, bd.kernel, bd.se_mid
        kw = dict(exp_w=r(bd.cin, e, scale=1.5 / bd.cin ** 0.5) if bd.has_expand else None,
                  exp_b=r(e, scale=0.3) if bd.has_expand else None,
                  dw_w=r(k, k, 1, e, scale=0.3), dw_b=r(e, scale=0.2),
                  prj_w=r(e, bd.cout, scale=e ** -0.5), prj_b=r(bd.cout, scale=0.2),
                  k=k, stride=bd.stride, act=bd.act, residual=bd.has_res)
        if se:
            kw.update(se_w1=r(e, se, scale=e ** -0.5), se_b1=r(se, scale=0.3),
                      se_w2=r(se, e, scale=se ** -0.5), se_b2=r(e, scale=0.3))
        return kw

    def inputs(n, h, c):
        return (torch.rand(n, h, h, c, generator=gen, device="cuda") * 4 - 2).to(dtype)

    out = {}
    for tag, variant in (("v3l", "large"), ("v3s", "small")):
        cfg = V3Config(variant, 1.0, 224)
        for batch in args.batch:
            shapes, h = {}, cfg.resolution // 2
            for i, bd in enumerate(cfg.block_defs):
                key = (h, bd)
                if key in shapes:
                    out[shapes[key]]["count"] += 1
                else:
                    name = shapes[key] = f"{tag} b{i:02d} {batch}"
                    x, kw = inputs(batch, h, bd.cin), weights(bd)
                    calls = {"ms": lambda x=x, kw=kw: v3_block(x, **kw)}
                    if parent:
                        calls["parent_ms"] = lambda x=x, kw=kw: parent[0].v3_block(x, **kw)
                    if args.yardsticks:
                        calls["plain_ms"] = lambda x=x, kw=kw: v3_block_plain(x, **kw)
                        calls["library_ms"] = ieee(v3_library(x, **kw), x)
                    out[name] = {**times(batch, calls), "count": 1, **devices(batch, calls)}
                    del x, kw, calls
                    torch.cuda.empty_cache()
                h = -(-h // bd.stride)
            stop = len(cfg.block_defs)
            blocks = [weights(bd) for bd in cfg.block_defs[1:stop]]
            x = inputs(batch, cfg.resolution // 2 // cfg.block_defs[0].stride,
                       cfg.block_defs[1].cin)
            calls = {"ms": lambda x=x, b=blocks: v3_chain(x, b)}
            if parent:
                calls["parent_ms"] = lambda x=x, b=blocks: parent[1].v3_chain(x, b)
            if args.yardsticks:
                calls["plain_ms"] = lambda x=x, b=blocks: v3_chain_plain(x, b)
            out[f"{tag} chain b01-b{stop - 1:02d} {batch}"] = {**times(batch, calls),
                                                              **devices(batch, calls)}
            del x, blocks, calls
            torch.cuda.empty_cache()
    return out


def v3_int8_times(args, rng_seed, times) -> dict:
    """The int8 `v3_block_i8` at each distinct block shape of V3-Large and
    V3-Small 1.0-224, through the public wrapper only: layers quantized from
    random float weights by quant/v3's `_quant_named` with non-zero biases
    (SE included), given the kernel's weight forms where the module makes
    them (`v3_i8_kernel_weights`), x uniform in [-128, 127]."""
    import numpy as np  # noqa: PLC0415

    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415
    from .ops import v3_block_i8 as mod  # noqa: PLC0415
    from .quant.v3 import _quant_named, device_layer_v3  # noqa: PLC0415

    rng = np.random.default_rng(rng_seed)

    def layers(bd):
        e, k, se, ident = bd.cexp, bd.kernel, bd.se_mid, not bd.has_expand

        def lay(shape, axis, s_in, s_out, scale, b_scale, **kw):
            w = rng.normal(0, scale, shape).astype(np.float32)
            b = rng.normal(0, b_scale, (shape[axis],)).astype(np.float32)
            return device_layer_v3(_quant_named(w, b, axis, s_in, s_out, **kw), "cuda")

        blk = {"dw": lay((k, k, 1, e), 3, 0.05 if ident else 0.06, 0.06, 0.3, 0.2,
                         k_taps=k * k),
               "prj": lay((e, bd.cout), 1, 0.06, 0.05, e ** -0.5, 0.2)}
        if not ident:
            blk["exp"] = lay((bd.cin, e), 1, 0.05, 0.06, 1.5 * bd.cin ** -0.5, 0.3)
        if se:
            blk["se1"] = lay((e, se), 1, 0.06, 0.03, e ** -0.5, 0.3)
            blk["se2"] = lay((se, e), 1, 0.03, 1.0, se ** -0.5, 0.3)
        if hasattr(mod, "v3_i8_kernel_weights"):
            mod.v3_i8_kernel_weights(blk)
        return dict(exp=blk.get("exp"), dw=blk["dw"], prj=blk["prj"], se1=blk.get("se1"),
                    se2=blk.get("se2"), k=k, stride=bd.stride, act=bd.act,
                    residual=bd.has_res)

    out = {}
    for tag, variant in (("v3l", "large"), ("v3s", "small")):
        cfg = V3Config(variant, 1.0, 224)
        for batch in args.batch:
            shapes, h = {}, cfg.resolution // 2
            for i, bd in enumerate(cfg.block_defs):
                key = (h, bd)
                if key in shapes:
                    out[shapes[key]]["count"] += 1
                else:
                    name = shapes[key] = f"{tag} b{i:02d} {batch}"
                    x = torch.from_numpy(rng.integers(-128, 128, (batch, h, h, bd.cin))
                                         .astype(np.int8)).cuda()
                    kw = layers(bd)
                    calls = {"ms": lambda x=x, kw=kw: mod.v3_block_i8(x, **kw)}
                    if args.yardsticks:
                        calls["plain_ms"] = lambda x=x, kw=kw: mod.v3_block_i8_plain(x, **kw)
                    out[name] = {**times(batch, calls), "count": 1,
                                 "passes": kernel_ms(calls["ms"])}
                    del x, kw, calls
                    torch.cuda.empty_cache()
                h = -(-h // bd.stride)
    return out


def v2_shapes(batch):
    """(name, N, H, Cin, E, Cout, stride, residual) of each distinct expanded
    block shape of V2 1.0-224 (blocks 1-16) at `batch`, and the blocks of one
    forward that have it ({name: count})."""
    from .models.mobilenet_v2 import V2Config  # noqa: PLC0415

    shapes, counts, h = {}, {}, 112
    for i, (t, cin, cout, stride) in enumerate(V2Config(1.0, 224).block_defs):
        key = (h, t, cin, cout, stride)
        if t > 1 and key in shapes:
            counts[shapes[key][0]] += 1
        elif t > 1:
            name = f"v2 b{i:02d} {batch}"
            shapes[key] = (name, batch, h, cin, t * cin, cout, stride,
                           stride == 1 and cin == cout)
            counts[name] = 1
        h = -(-h // stride)
    return list(shapes.values()), counts


def v2_times(args, gen, times) -> dict:
    """The bf16 (--float32: float32) `inverted_residual` at each distinct
    expanded block shape of V2 1.0-224 (blocks 1-16), and with --yardsticks
    its plain version and the unfused library sequence `v3_library` (relu6,
    k 3, no SE), through the public wrappers only."""
    from .ops.inverted_residual import (  # noqa: PLC0415
        inverted_residual, inverted_residual_plain,
    )

    dtype = torch.float32 if args.float32 else torch.bfloat16
    parent = load_parent(args.parent, ("ops.inverted_residual",))[0] if args.parent else None

    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {}
    for batch in args.batch:
        shapes, counts = v2_shapes(batch)
        for name, n, h, cin, e, cout, stride, res in shapes:
            x = (torch.rand(n, h, h, cin, generator=gen, device="cuda") * 4 - 2).to(dtype)
            w = dict(exp_w=r(cin, e, scale=1.5 / cin ** 0.5), exp_b=r(e, scale=0.3),
                     dw_w=r(3, 3, 1, e, scale=0.3), dw_b=r(e, scale=0.2),
                     prj_w=r(e, cout, scale=e ** -0.5), prj_b=r(cout, scale=0.2))
            calls = {"ms": lambda x=x, w=w, s=stride, rs=res: inverted_residual(
                x, *w.values(), s, rs)}
            if parent:
                calls["parent_ms"] = lambda x=x, w=w, s=stride, rs=res: (
                    parent.inverted_residual(x, *w.values(), s, rs))
            if args.yardsticks:
                calls["plain_ms"] = lambda x=x, w=w, s=stride, rs=res: (
                    inverted_residual_plain(x, *w.values(), s, rs))
                calls["library_ms"] = ieee(v3_library(x, **w, k=3, stride=stride, act="relu6",
                                                      residual=res), x)
            out[name] = {**times(batch, calls), "count": counts[name],
                         "passes": kernel_ms(calls["ms"]), **devices(batch, calls)}
            del x, w, calls
            torch.cuda.empty_cache()
    return out


def devices(batch, calls) -> dict:
    """At batch 256 (where `times` reads CUDA events), torch.profiler's
    device ms a call of the kernel, the parent and the library sequence
    ("device_ms", "parent_device_ms", "library_device_ms") where given."""
    if batch != 256:
        return {}
    return {f"{k[:-2]}device_ms": device_ms(calls[k], reps=10)
            for k in ("ms", "parent_ms", "library_ms") if k in calls}


def v2_int8_times(args, rng_seed, times) -> dict:
    """The int8 `inverted_residual_i8` at each distinct expanded block shape
    of V2 1.0-224, through the public wrapper only: layers quantized from
    random float weights by quant/quantize's `_quant_layer` (the expansion and
    depthwise at the fixed 6/127 scale: six_q 127; the projection into a
    bottleneck scale of 0.05), given the kernel's weight forms (`wt`) where
    the wrapper takes them, x uniform in [-128, 127]."""
    import inspect  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415

    from .ops import inverted_residual_i8 as mod  # noqa: PLC0415
    from .ops.v3_block_i8 import kernel_weights  # noqa: PLC0415
    from .quant.quantize import ACT_HIDDEN_SCALE, _quant_layer  # noqa: PLC0415

    rng = np.random.default_rng(rng_seed)
    takes_wt = "wt" in inspect.signature(mod.inverted_residual_i8).parameters

    def layer(shape, axis, s_in, s_out, scale, **kw):
        q = _quant_layer(rng.normal(0, scale, shape).astype(np.float32),
                         rng.normal(0, 0.1, (shape[axis],)).astype(np.float32), axis, s_in,
                         s_out, **kw)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
        return t(q.w_i8), t(q.bias_i32), t(q.m), float(q.six_q)

    out = {}
    for batch in args.batch:
        shapes, counts = v2_shapes(batch)
        for name, n, h, cin, e, cout, stride, res in shapes:
            s_x = np.float32(0.05)
            ew, eb, em, es = layer((cin, e), 1, s_x, ACT_HIDDEN_SCALE, cin ** -0.5)
            dw, db, dm, ds = layer((3, 3, 1, e), 3, ACT_HIDDEN_SCALE, ACT_HIDDEN_SCALE, 0.3,
                                   dw_bias_bound=True)
            pw, pb, pm, _ = layer((e, cout), 1, ACT_HIDDEN_SCALE, s_x, e ** -0.5)
            x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, cin)).astype(
                np.int8)).cuda()
            a = (x, ew, eb, em, es, dw, db, dm, ds, pw, pb, pm, stride, res)
            kw = {"wt": kernel_weights({"w": ew}, {"w": dw}, {"w": pw})} if takes_wt else {}
            calls = {"ms": lambda a=a, kw=kw: mod.inverted_residual_i8(*a, **kw)}
            if args.yardsticks:
                calls["plain_ms"] = lambda a=a: mod.inverted_residual_i8_plain(*a)
            out[name] = {**times(batch, calls), "count": counts[name],
                         "passes": kernel_ms(calls["ms"])}
            del x, a, kw, calls
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=None)
    p.add_argument("--yardsticks", action="store_true",
                   help="also the plain versions and the library sequence")
    kind = p.add_mutually_exclusive_group()
    p.add_argument("--int8", action="store_true",
                   help="the int8 separable block instead of the bf16 one and the chain "
                        "(with --dw: the int8 depthwise)")
    kind.add_argument("--v3", action="store_true",
                      help="the bf16 (--float32: float32) V3 bottleneck and the V3 chains "
                           "instead")
    kind.add_argument("--v3-int8", action="store_true",
                      help="the int8 V3 bottleneck instead, with each launch's device time")
    kind.add_argument("--v2", action="store_true",
                      help="the bf16 V2 inverted-residual block instead")
    kind.add_argument("--v2-int8", action="store_true",
                      help="the int8 V2 inverted-residual block instead, with each launch's "
                           "device time")
    kind.add_argument("--stem", action="store_true",
                      help="V1's stem kernels (stem_conv, stem_block0) in bf16 and float32 "
                           "instead")
    kind.add_argument("--head", action="store_true",
                      help="the bf16 (--float32: float32) fused head in its forms instead "
                           "(default batches 256 64 8 1)")
    kind.add_argument("--dw", action="store_true",
                      help="the standalone depthwise kernel at V1's depthwise layers instead "
                           "(bf16; default batches 256 2)")
    p.add_argument("--float32", action="store_true",
                   help="the float32 kernel instead of the bf16 one (alone: the float32 "
                        "separable block and chain, default batches 256 2 1)")
    p.add_argument("--plans", action="store_true",
                   help="with --float32 alone: every candidate plan of the float32 separable "
                        "block at V1's shapes and V2 b00, the plan's pick against the fastest")
    p.add_argument("--parent", default=None,
                   help="with --float32, --v2, --v3, --head, --stem or --dw: the root of an "
                        "earlier checkout to time beside")
    args = p.parse_args(argv)
    if args.batch is None:
        args.batch = ([256, 64, 8, 1] if args.head else [256, 2] if args.dw
                      else [256, 2, 1] if args.float32 or args.stem else [256, 1])
    if args.int8 and (args.float32 or any(
            (args.v3, args.v3_int8, args.v2, args.v2_int8, args.stem, args.head))):
        p.error("--int8 goes alone or with --dw, and not with --float32")
    if args.plans and (not args.float32 or args.int8 or args.parent or any(
            (args.v3, args.v3_int8, args.v2, args.v2_int8, args.stem, args.head, args.dw))):
        p.error("--plans goes with --float32 alone")
    if not torch.cuda.is_available():
        raise SystemExit("block_times: needs a CUDA card")
    from .config import ModelConfig  # noqa: PLC0415
    from .floors import cuda_ms  # noqa: PLC0415

    def times(batch, calls):
        timer = (lambda f: cuda_ms(f, reps=20, warmup=3)) if batch == 256 else device_ms
        return {k: timer(f) for k, f in calls.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.v3:
        out = v3_times(args, gen, times)
    elif args.v3_int8:
        out = v3_int8_times(args, 0, times)
    elif args.v2:
        out = v2_times(args, gen, times)
    elif args.v2_int8:
        out = v2_int8_times(args, 0, times)
    elif args.stem:
        out = stem_times(ModelConfig(1.0, 224), args, gen, times)
    elif args.head:
        out = head_times(args, gen)
    elif args.dw:
        out = dw_times(ModelConfig(1.0, 224), args, gen, times)
    elif args.plans:
        out = f32_plan_times(ModelConfig(1.0, 224), args, gen)
    else:
        run = int8_times if args.int8 else f32_times if args.float32 else bf16_times
        out = run(ModelConfig(1.0, 224), args, gen, times)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **out}),
          flush=True)


if __name__ == "__main__":
    main()
