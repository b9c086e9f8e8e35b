"""MobileNet-V3 (Large, Small, minimalistic) forward pass in PyTorch, with
per-block kernel routing.

The configuration (`V3_LARGE_ROWS`, `V3_SMALL_ROWS`, `SE_RATIO`,
`V3BlockDef`, `V3Config`), the layer schedule, the squeeze-excite gate, the
routing and the tap names follow the JAX package's `models/mobilenet_v3.py`
(keras applications/mobilenet_v3.py: stacks :421-452 Small, :488-519
Large). Backends per block:
  "plain" - plain PyTorch expand / depthwise k x k / SE / projection ops and
            a residual add in the compute dtype (the JAX package's "xla"
            route, the reference);
  "fused" - one launch of the V3 bottleneck kernel (ops/v3_block.py) per
            block: expansion (the identity with no activation for block 0),
            depthwise k = 3 or 5 at stride 1 or 2, the squeeze-excite gate
            inside the kernel, the projection and the residual.
Under a fused last block, conv_last -> pool -> head -> fc run as one
fused_head kernel (ops/head.py). The stem convolution, normalize and softmax
are plain ops on every route. With the variant's chain knob on (`CHAIN_V3`,
`CHAIN_V3_SMALL`; both off by default), runs of consecutive fused blocks go
to the chain kernel (ops/v3_chain.py), one launch a run, bit-equal to the
per-block kernel.

The TPU's lane-packed layouts are not ported: the lane-packed block-0 and
stride-2 expand routes, `packed_expand` and the lane-packed SE kernel
(`se_block_packed`, V3-Small's blocks 2 and 4-7 in the JAX package) run on
the V3 kernel, and the `v3_fits` XLA fallback is not needed. The Hopper
kernel takes the checkpoint's own widths on every block of Large and Small
(V3-Small's block 0, which the JAX package runs on XLA ops, included); a
block it cannot plan raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import conv as ops
from ..ops.head import fused_head
from ..ops.preprocess import preprocess
from ..ops.v3_block import v3_block
from ..ops.v3_chain import v3_chain, v3_chain_fits
from .mobilenet_v2 import make_divisible

# Per-block rows: (exp_ratio, cout_base, kernel, stride, se, act) where kernel
# "k" is the config-dependent late kernel (5, or 3 when minimalistic) and act
# "hs" degrades to "relu" when minimalistic. keras mobilenet_v3.py:488-519
# (Large) / :421-452 (Small).
V3_LARGE_ROWS: Tuple[Tuple[float, int, str, int, bool, str], ...] = (
    (1.0, 16, "3", 1, False, "relu"),
    (4.0, 24, "3", 2, False, "relu"),
    (3.0, 24, "3", 1, False, "relu"),
    (3.0, 40, "k", 2, True, "relu"),
    (3.0, 40, "k", 1, True, "relu"),
    (3.0, 40, "k", 1, True, "relu"),
    (6.0, 80, "3", 2, False, "hs"),
    (2.5, 80, "3", 1, False, "hs"),
    (2.3, 80, "3", 1, False, "hs"),
    (2.3, 80, "3", 1, False, "hs"),
    (6.0, 112, "3", 1, True, "hs"),
    (6.0, 112, "3", 1, True, "hs"),
    (6.0, 160, "k", 2, True, "hs"),
    (6.0, 160, "k", 1, True, "hs"),
    (6.0, 160, "k", 1, True, "hs"),
)
V3_SMALL_ROWS: Tuple[Tuple[float, int, str, int, bool, str], ...] = (
    (1.0, 16, "3", 2, True, "relu"),
    (72.0 / 16, 24, "3", 2, False, "relu"),
    (88.0 / 24, 24, "3", 1, False, "relu"),
    (4.0, 40, "k", 2, True, "hs"),
    (6.0, 40, "k", 1, True, "hs"),
    (6.0, 40, "k", 1, True, "hs"),
    (3.0, 48, "k", 1, True, "hs"),
    (3.0, 48, "k", 1, True, "hs"),
    (6.0, 96, "k", 2, True, "hs"),
    (6.0, 96, "k", 1, True, "hs"),
    (6.0, 96, "k", 1, True, "hs"),
)

SE_RATIO = 0.25  # keras mobilenet_v3.py:311

DW_BACKENDS = ("plain", "fused")

# The chain kernel (ops/v3_chain.py): runs of consecutive fused bottlenecks
# in one launch, bit-equal to the per-block kernel. The values mean what the
# JAX package's CHAIN_V3 / CHAIN_V3_SMALL mean (models/mobilenet_v3.py):
# True = greedy maximal runs; False = off; a collection of (start, stop)
# block ranges = exactly those runs (each still subject to v3_chain_fits).
# Large: False, the JAX value. Small: False, where the JAX package has True:
# there PACKED_SE_SMALL = True ends its chain at every block, so the JAX
# package's shipped V3-Small route never forms one, and False keeps the
# port's default V3-Small route equal to what it runs. Turning either knob on
# by default is a benchmark decision. The JAX package's CHAIN_V3_BN, a TPU
# VMEM batch tile, is not ported: each stage's tile comes from v3_plan.
CHAIN_V3 = False
CHAIN_V3_SMALL = False


@dataclasses.dataclass(frozen=True)
class V3BlockDef:
    """Fully resolved static block shape (all channels alpha-scaled)."""

    cin: int
    cexp: int          # expansion channels: _depth(cin * exp_ratio)
    cout: int
    kernel: int        # 3 or 5
    stride: int
    se_mid: int        # 0 = no SE; else _depth(cexp * 0.25)
    act: str           # "relu" | "hswish"
    has_expand: bool   # block 0 has no expand conv (keras :602 `if block_id`)

    @property
    def has_res(self) -> bool:
        return self.stride == 1 and self.cin == self.cout


@dataclasses.dataclass(frozen=True)
class V3Config:
    """Static description of one MobileNet-V3 variant."""

    variant: str = "large"          # "large" | "small"
    alpha: float = 1.0
    resolution: int = 224
    minimalistic: bool = False      # kernel 3 / relu / no SE (keras :305-311)
    num_classes: int = 1000
    bn_eps: float = 1e-3
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.variant not in ("large", "small"):
            raise ValueError(f"variant must be large|small, got {self.variant}")
        if self.resolution % 32 != 0:
            raise ValueError(
                f"resolution must be divisible by 32, got {self.resolution} "
                "(guarantees even inputs at every stride-2 point, where "
                "keras's explicit padding equals SAME)")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be positive, got {self.alpha}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def stem_channels(self) -> int:
        return 16  # fixed, NOT alpha-scaled (keras :316 Conv2D(16, ...))

    @property
    def block_defs(self) -> Tuple[V3BlockDef, ...]:
        rows = V3_LARGE_ROWS if self.variant == "large" else V3_SMALL_ROWS
        late_k = 3 if self.minimalistic else 5
        out = []
        cin = self.stem_channels
        for i, (t, c_base, k, stride, se, act) in enumerate(rows):
            cexp = make_divisible(cin * t)
            cout = make_divisible(c_base * self.alpha)
            se_on = se and not self.minimalistic
            out.append(V3BlockDef(
                cin=cin,
                cexp=cexp,
                cout=cout,
                kernel=late_k if k == "k" else 3,
                stride=stride,
                se_mid=make_divisible(cexp * SE_RATIO) if se_on else 0,
                act="relu" if (act == "relu" or self.minimalistic) else "hswish",
                has_expand=i > 0,
            ))
            cin = cout
        return tuple(out)

    @property
    def last_conv_channels(self) -> int:
        # _depth(last_block_out * 6), keras :330
        return make_divisible(self.block_defs[-1].cout * 6)

    @property
    def last_point_channels(self) -> int:
        base = 1280 if self.variant == "large" else 1024
        if self.alpha > 1.0:  # keras :335-336
            return make_divisible(base * self.alpha)
        return base

    @property
    def head_act(self) -> str:
        return "relu" if self.minimalistic else "hswish"

    @property
    def final_spatial(self) -> int:
        return self.resolution // 32

    def variant_name(self) -> str:
        mini = "min_" if self.minimalistic else ""
        return f"mobilenet_v3_{self.variant}_{mini}{self.alpha:g}_{self.resolution}"


@ops.ieee_f32
def se_apply(z: torch.Tensor, se: Dict[str, Any]) -> torch.Tensor:
    """Squeeze-excite gate (keras _se_block :571-590), the JAX package's
    plain route: the float32 mean over H, W rounded to z's dtype -> 1x1
    conv + bias + relu -> 1x1 conv + bias + hard sigmoid (products in
    float32, each result rounded to z's dtype) -> z * gate in z's dtype."""
    pooled = z.float().mean(dim=(1, 2)).to(z.dtype)
    g = pooled.float() @ se["w1"].to(z.dtype).float() + se["b1"].float()
    g = g.clamp_min(0)
    g = g.to(z.dtype).float() @ se["w2"].to(z.dtype).float() + se["b2"].float()
    g = ops.apply_act_named(g, "hsigmoid").to(z.dtype)
    return z * g[:, None, None, :]


@ops.ieee_f32
def head_matmul(pooled: torch.Tensor, head: Dict[str, Any], act: str) -> torch.Tensor:
    """The post-pool head conv (keras :345-356) on (N, C): float32 product
    and bias, the activation in float32, then pooled's dtype."""
    h = pooled.float() @ head["w"].to(pooled.dtype).float() + head["b"].float()
    return ops.apply_act_named(h, act).to(pooled.dtype)


def mixed_b1_routing(config: V3Config) -> Tuple[str, ...]:
    """The "mixed" tuple: plain ops for the high-resolution head blocks (two
    on Large, four on Small), the fused kernel after them (the JAX
    package's measured v5e batch-1 choice; on the card it is an option that
    chip_smoke.py times against "auto", not a default)."""
    n = len(config.block_defs)
    nx = 4 if config.variant == "small" else 2
    return ("plain",) * nx + ("fused",) * (n - nx)


def _routing_v3(config: V3Config, dw_backend, batch: int) -> Tuple[str, ...]:
    """Resolve the per-block backend tuple.

    None -> "plain". "auto" -> "fused" at every batch, on Large and Small:
    the v5e batch-1 crossover does not carry over, and no H100 crossover
    has been adopted. "mixed" -> `mixed_b1_routing`. A tuple names each
    block's backend."""
    n = len(config.block_defs)
    if dw_backend is None:
        dw_backend = "plain"
    if dw_backend == "auto":
        dw_backend = "fused"
    if dw_backend == "mixed":
        return mixed_b1_routing(config)
    if isinstance(dw_backend, str):
        if dw_backend not in DW_BACKENDS:
            raise ValueError(f"dw_backend {dw_backend!r} not in {DW_BACKENDS}, "
                             "'auto' or 'mixed'")
        return (dw_backend,) * n
    if len(dw_backend) != n or any(b not in DW_BACKENDS for b in dw_backend):
        raise ValueError(f"per-block dw_backend must be {n} names from "
                         f"{DW_BACKENDS}, got {dw_backend!r}")
    return tuple(dw_backend)


def forward_v3(params: Dict[str, Any], x: torch.Tensor, config: V3Config, *,
               dw_backend=None, collect: bool = False) -> Any:
    """Run MobileNet-V3 on a folded-BN device tree (checkpoints.v3).

    x: (N, H, W, 3) preprocessed NHWC images in [-1, 1], in the compute
    dtype. collect=True runs every block on plain ops and also returns the
    per-layer taps: conv1, block{i:02d}_exp/_dw/_se/_prj/_out, conv_last,
    pool, head, logits.

    Returns logits (N, classes), or (logits, {name: activation}) if collect.
    """
    acts: Dict[str, torch.Tensor] = {}
    routing = _routing_v3(config, dw_backend, int(x.shape[0]))

    y = ops.conv2d_same(x, params["conv1"]["w"], 2, bias=params["conv1"]["b"],
                        act=config.head_act)
    if collect:
        acts["conv1"] = y
    y = run_blocks_v3(params, y, config, routing, acts if collect else None)

    if not collect:
        return head_v3(params, y, config, routing)
    y = ops.pointwise_conv(y, params["conv_last"]["w"], bias=params["conv_last"]["b"],
                           act=config.head_act)
    acts["conv_last"] = y
    pooled = ops.global_avg_pool(y)
    acts["pool"] = pooled
    h = head_matmul(pooled, params["head"], config.head_act)
    acts["head"] = h
    logits = ops.fc(h, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def head_v3(params, y, config: V3Config, routing) -> torch.Tensor:
    """conv_last, pool, the head matmul and fc on the last block's output:
    the fused head kernel when the last block is "fused", else the plain
    ops."""
    if routing[-1] == "fused":
        conv = (params["conv_last"]["w"], params["conv_last"]["b"], config.head_act)
        post = [(params["head"]["w"], params["head"]["b"], config.head_act),
                (params["fc"]["w"], params["fc"]["b"], "linear")]
        return fused_head(y, conv, post)
    y = ops.pointwise_conv(y, params["conv_last"]["w"], bias=params["conv_last"]["b"],
                           act=config.head_act)
    h = head_matmul(ops.global_avg_pool(y), params["head"], config.head_act)
    return ops.fc(h, params["fc"]["w"], params["fc"]["b"])


def _chain_stop(i: int, knob):
    """None (greedy from i), a stop index (the explicit range starting at
    i), or -1 (no chain starts at i) under a chain knob's value (the JAX
    package's _chain_ranges)."""
    if knob is True:
        return None
    if knob is False:
        return -1
    for start, stop in knob:
        if start == i:
            return stop
    return -1


def chain_runs(config: V3Config, routing, n: int, h: int, w: int,
               itemsize: int, start: int = 0, stop: Optional[int] = None) -> Dict[int, int]:
    """{start: stop} of the block runs that the variant's chain knob forms
    on an (n, h, w) input to block `start` over blocks [start, stop), from
    the shapes alone (a run never crosses `stop`: a pipeline stage's
    bound, as the JAX package's min(rng_stop, stop)). At each block
    outside a run: the longest eligible run from it (up to the knob's stop
    for an explicit range), shortened from its end until v3_chain_fits takes
    it; fewer than two blocks is no run. Eligible, as in the JAX package's
    _try_chain_v3: routing "fused", an expansion, k 3 or 5, stride 1 or 2,
    an even input at stride 2. Its two breaks for the lane-packed routes are
    left out: those are TPU layouts that the port runs on v3_block. Kept
    per (config, routing, shape, knob), since every forward asks."""
    knob = CHAIN_V3_SMALL if config.variant == "small" else CHAIN_V3
    if knob is False:
        return {}
    if knob is not True:
        knob = tuple((int(start), int(stop)) for start, stop in knob)
    stop = len(config.block_defs) if stop is None else stop
    return dict(_chain_runs(config, tuple(routing), n, h, w, itemsize, knob, start, stop))


@functools.lru_cache(maxsize=256)
def _chain_runs(config: V3Config, routing: Tuple[str, ...], n: int, h: int, w: int,
                itemsize: int, knob, start: int, stop: int) -> Dict[int, int]:
    defs = config.block_defs
    sizes = {}
    for k in range(start, stop):
        sizes[k] = (h, w)
        h, w = -(-h // defs[k].stride), -(-w // defs[k].stride)
    runs, i = {}, start
    while i < stop:
        rng = _chain_stop(i, knob)
        run = []
        for j in range(i, stop if rng is None else min(rng, stop)):
            bd, (hh, ww) = defs[j], sizes[j]
            if (routing[j] != "fused" or not bd.has_expand or bd.kernel not in (3, 5)
                    or bd.stride not in (1, 2) or (bd.stride == 2 and (hh % 2 or ww % 2))):
                break
            run.append((bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid))
        while len(run) >= 2 and not v3_chain_fits(n, *sizes[i], run, itemsize):
            run.pop()
        if len(run) >= 2:
            runs[i] = i + len(run)
            i += len(run)
        else:
            i += 1
    return runs


def _kernel_block(bd: V3BlockDef, blk: Dict[str, Any]) -> Dict[str, Any]:
    """One block's tensors and options as v3_block / v3_chain take them."""
    se = blk.get("se", {})
    return dict(exp_w=blk["exp"]["w"] if bd.has_expand else None,
                exp_b=blk["exp"]["b"] if bd.has_expand else None,
                dw_w=blk["dw"]["w"], dw_b=blk["dw"]["b"], prj_w=blk["prj"]["w"],
                prj_b=blk["prj"]["b"], se_w1=se.get("w1"), se_b1=se.get("b1"),
                se_w2=se.get("w2"), se_b2=se.get("b2"), k=bd.kernel, stride=bd.stride,
                act=bd.act, residual=bd.has_res)


def run_blocks_v3(params, y, config: V3Config, routing,
                  acts: Optional[Dict[str, Any]] = None, *, start: int = 0,
                  stop: Optional[int] = None) -> torch.Tensor:
    """The bottlenecks [start, stop) (y enters block `start`), per-block
    backend routing; runs that the chain knob forms (`chain_runs`, within
    [start, stop); never under collect) go to one chain launch each. A
    fused block whose shape the kernel cannot plan raises; nothing falls
    back to plain ops."""
    collect = acts is not None
    stop = len(config.block_defs) if stop is None else stop
    runs = {} if collect else chain_runs(config, routing, int(y.shape[0]), int(y.shape[1]),
                                         int(y.shape[2]), y.element_size(), start, stop)
    skip_until = start
    for i in range(start, stop):
        bd, blk = config.block_defs[i], params["blocks"][i]
        if i < skip_until:
            continue
        if i in runs:
            skip_until = runs[i]
            y = v3_chain(y, [_kernel_block(d, b) for d, b in zip(
                config.block_defs[i:skip_until], params["blocks"][i:skip_until])])
            continue
        if routing[i] == "fused" and not collect:
            y = v3_block(y, **_kernel_block(bd, blk))
            continue
        z = y
        if bd.has_expand:
            z = ops.pointwise_conv(z, blk["exp"]["w"], bias=blk["exp"]["b"], act=bd.act)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        z = ops.depthwise_conv(z, blk["dw"]["w"], bd.stride, bias=blk["dw"]["b"], act=bd.act)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = se_apply(z, blk["se"])
            if collect:
                acts[f"block{i:02d}_se"] = z
        out = ops.pointwise_conv(z, blk["prj"]["w"], bias=blk["prj"]["b"])
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = out + y  # the residual, in the compute dtype
            if collect:
                acts[f"block{i:02d}_out"] = out
        y = out
    return y


def predict_probs_v3(params, x, config: V3Config, **kw) -> torch.Tensor:
    """logits -> float32 softmax probabilities."""
    return ops.softmax(forward_v3(params, x, config, **kw))


def predict_probs_v3_u8(params, images_u8, config: V3Config, *,
                        dtype=torch.float32, **kw) -> torch.Tensor:
    """uint8 NHWC at any size -> float32 probabilities (resize, normalize,
    forward, softmax)."""
    x = preprocess(images_u8, config.resolution, dtype)
    return predict_probs_v3(params, x, config, **kw)
