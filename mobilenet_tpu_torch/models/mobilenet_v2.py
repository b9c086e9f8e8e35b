"""MobileNet-V2 forward pass in PyTorch, with per-block kernel routing.

The configuration (`V2_T_C_N_S`, `V2_ALPHAS`, `make_divisible`,
`V2Config`), the layer schedule, the routing and the tap names follow the
JAX package's `models/mobilenet_v2.py`. Backends per block:
  "plain" - plain PyTorch expand / depthwise / projection ops and a residual
            add in the compute dtype (the JAX package's "xla" route, the
            reference);
  "fused" - one kernel per block: the inverted-residual kernel
            (ops/inverted_residual.py) for every block with an expansion
            conv, at stride 1 or 2, residual added in the kernel; the
            separable-block kernel in its linear-projection mode
            (ops/separable_block.py, pw_act=False) for the t == 1 block 0.
Under a fused last block, conv_last -> pool -> fc run as one fused_head
kernel (ops/head.py). The stem convolution, normalize and softmax are plain
ops on every route.

The TPU's lane-packing detours (the packed block-0 route with its
`pad_block0_v2` channel padding, the packed stride-2 expand block and the
zero-channel ripple behind them) are not ported: the Hopper kernels take
any channel count that is a multiple of 8, so every block runs one of the
two kernels above on the checkpoint's own shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import conv as ops
from ..ops.head import fused_head
from ..ops.inverted_residual import inverted_residual
from ..ops.preprocess import preprocess
from ..ops.separable_block import separable_block

# (expansion t, base channels c, repeats n, first stride s): keras
# applications/mobilenet_v2.py:96-110, the paper's Table 2.
V2_T_C_N_S: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

V2_ALPHAS = (0.35, 0.5, 0.75, 1.0, 1.3, 1.4)  # the keras pretrained grid

DW_BACKENDS = ("plain", "fused")


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Channel rounding, bit for bit the keras/TF `_make_divisible`."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class V2Config:
    """Static description of one MobileNet-V2 variant."""

    alpha: float = 1.0
    resolution: int = 224
    num_classes: int = 1000
    bn_eps: float = 1e-3
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.alpha not in V2_ALPHAS:
            raise ValueError(f"alpha must be one of {V2_ALPHAS}, got {self.alpha}")
        if self.resolution % 32 != 0:
            raise ValueError(f"resolution must be divisible by 32, got {self.resolution}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def relu6(self) -> bool:  # V2 always uses ReLU6 (paper section 3.2)
        return True

    @property
    def stem_channels(self) -> int:
        return make_divisible(32 * self.alpha)

    @property
    def block_defs(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """Expanded per-block (t, cin, cout, stride), len == 17."""
        out = []
        cin = self.stem_channels
        for t, c, n, s in V2_T_C_N_S:
            cout = make_divisible(c * self.alpha)
            for j in range(n):
                out.append((t, cin, cout, s if j == 0 else 1))
                cin = cout
        return tuple(out)

    @property
    def last_channels(self) -> int:
        # keras: alpha scales the last conv only upward (alpha > 1.0)
        if self.alpha > 1.0:
            return make_divisible(1280 * self.alpha)
        return 1280

    @property
    def final_spatial(self) -> int:
        return self.resolution // 32

    def variant_name(self) -> str:
        return f"mobilenet_v2_{self.alpha:g}_{self.resolution}"


def mixed_b1_routing_v2(config: V2Config) -> Tuple[str, ...]:
    """The "mixed" tuple: plain ops for the two 112-squared blocks, the
    fused kernels from block 2 on (the JAX package's measured v5e batch-1
    choice; on the card it is an option that chip_smoke.py times against
    "auto", not a default)."""
    n = len(config.block_defs)
    return ("plain",) * 2 + ("fused",) * (n - 2)


def _routing_v2(config: V2Config, dw_backend, batch: int) -> Tuple[str, ...]:
    """Resolve the per-block backend tuple (len == 17).

    None -> "plain". "auto" -> "fused" at every batch: the v5e batch-1
    crossover does not carry over, and no H100 crossover has been adopted.
    "mixed" -> `mixed_b1_routing_v2`. A tuple names each block's backend."""
    n = len(config.block_defs)
    if dw_backend is None:
        dw_backend = "plain"
    if dw_backend == "auto":
        dw_backend = "fused"
    if dw_backend == "mixed":
        return mixed_b1_routing_v2(config)
    if isinstance(dw_backend, str):
        if dw_backend not in DW_BACKENDS:
            raise ValueError(f"dw_backend {dw_backend!r} not in {DW_BACKENDS}, "
                             "'auto' or 'mixed'")
        return (dw_backend,) * n
    if len(dw_backend) != n or any(b not in DW_BACKENDS for b in dw_backend):
        raise ValueError(f"per-block dw_backend must be {n} names from "
                         f"{DW_BACKENDS}, got {dw_backend!r}")
    return tuple(dw_backend)


def forward_v2(params: Dict[str, Any], x: torch.Tensor, config: V2Config, *,
               dw_backend=None, collect: bool = False) -> Any:
    """Run MobileNet-V2 on a folded-BN device tree (checkpoints.v2).

    x: (N, H, W, 3) preprocessed NHWC images in [-1, 1], in the compute
    dtype. collect=True runs every block on plain ops and also returns the
    per-layer taps: conv1, block{i:02d}_exp (blocks with an expansion),
    _dw, _prj, _out (residual blocks), conv_last, pool, logits.

    Returns logits (N, classes), or (logits, {name: activation}) if collect.
    """
    acts: Dict[str, torch.Tensor] = {}
    routing = _routing_v2(config, dw_backend, int(x.shape[0]))

    y = ops.conv2d_same(x, params["conv1"]["w"], 2, bias=params["conv1"]["b"],
                        relu6=True)
    if collect:
        acts["conv1"] = y
    y = run_blocks_v2(params, y, config, routing, acts if collect else None)

    if not collect and routing[-1] == "fused":
        return fused_head(y, (params["conv_last"]["w"], params["conv_last"]["b"], "relu6"),
                          [(params["fc"]["w"], params["fc"]["b"], "linear")])
    y = ops.pointwise_conv(y, params["conv_last"]["w"], bias=params["conv_last"]["b"],
                           relu6=True)
    if collect:
        acts["conv_last"] = y
    pooled = ops.global_avg_pool(y)
    if collect:
        acts["pool"] = pooled
    logits = ops.fc(pooled, params["fc"]["w"], params["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def run_blocks_v2(params, y, config: V2Config, routing,
                  acts: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """The 17 inverted-residual blocks, per-block backend routing. A fused
    block whose shape no kernel takes raises (the kernels' fits checks);
    nothing falls back to plain ops."""
    collect = acts is not None
    for i, ((_t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, params["blocks"])):
        has_res = stride == 1 and cin == cout
        if routing[i] == "fused" and not collect:
            if "exp" in blk:
                y = inverted_residual(y, blk["exp"]["w"], blk["exp"]["b"], blk["dw"]["w"],
                                      blk["dw"]["b"], blk["prj"]["w"], blk["prj"]["b"],
                                      stride, has_res)
            else:  # t == 1: block 0, never a residual block
                y = separable_block(y, blk["dw"]["w"], blk["dw"]["b"], blk["prj"]["w"],
                                    blk["prj"]["b"], stride, relu6=True, pw_act=False)
            continue
        z = y
        if "exp" in blk:  # t == 1 blocks have no expansion conv (keras :432)
            z = ops.pointwise_conv(z, blk["exp"]["w"], bias=blk["exp"]["b"], relu6=True)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        z = ops.depthwise_conv(z, blk["dw"]["w"], stride, bias=blk["dw"]["b"], relu6=True)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        out = ops.pointwise_conv(z, blk["prj"]["w"], bias=blk["prj"]["b"], relu6=None)
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if has_res:
            out = out + y  # the inverted residual, in the compute dtype
            if collect:
                acts[f"block{i:02d}_out"] = out
        y = out
    return y


def predict_probs_v2(params, x, config: V2Config, **kw) -> torch.Tensor:
    """logits -> float32 softmax probabilities."""
    return ops.softmax(forward_v2(params, x, config, **kw))


def predict_probs_v2_u8(params, images_u8, config: V2Config, *,
                        dtype=torch.float32, **kw) -> torch.Tensor:
    """uint8 NHWC at any size -> float32 probabilities (resize, normalize,
    forward, softmax)."""
    x = preprocess(images_u8, config.resolution, dtype)
    return predict_probs_v2(params, x, config, **kw)
