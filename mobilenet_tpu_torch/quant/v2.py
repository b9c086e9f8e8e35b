"""INT8 MobileNet-V2: calibration and quantization, the exact NumPy oracle,
the int8 forward and `Int8PipelineV2`; the port of the JAX package's
`quant/v2.py`.

The scheme is V1's (`quantize.py`) with one extension. Every ReLU6
activation (conv1, expansion, depthwise, conv_last) keeps the fixed 6/127
scale. The linear bottleneck outputs get one calibrated symmetric scale per
scale group (a residual-connected run of blocks: the producer block and
every block whose residual adds onto it), absmax/127 over the group's
projection and post-add taps of the float32 NumPy oracle on the seeded
structured images of `runtime.eval.synth_images`. One scale per group makes
the residual a saturating int8 add. Projections requantize linearly:
clamp(rint(float32(acc) * m), -128, 127), no ReLU. All scale arithmetic is
host-side float32, so a folded tree quantizes to the same integers and
multipliers in both packages, and every route is held to the oracle by exact
equality, layer by layer.

Calibration runs the NumPy oracle (`oracle/numpy_ref.py`, copied verbatim
from the JAX package), not the port's torch ops: a reordered float32 sum can
move an absmax in its last bit, and with it every multiplier of a group.

Routes per block (`forward_v2_i8`): "plain" runs the plain int8 ops (the
reference route; the JAX package's default XLA route); "fused" runs one
kernel per block: the int8 inverted-residual block
(ops/inverted_residual_i8.py, on the int8 bottleneck's Hopper tile with the
ReLU6 requant) on blocks 1-16 at either stride, and the int8
separable block in its linear mode (ops/separable_block_i8.py,
pw_linear=True) on the t == 1 block 0. The JAX package's `use_fused=True`
is "fused". The stem, input quantization, conv_last, pool, fc and softmax
are plain ops on every route (XLA ops in the JAX package).

Not ported, because each is a TPU layout or a TPU workaround:
- the bf16 integer carriage between blocks (`CARRY_MIN_H_V2`,
  `_carry_accepts_v2`, `_out_dt`, `_pointwise_i8_carrier`): activations stay
  int8 between blocks;
- `_bias_ok_i8`: it guards f32-carried integer dots; the port's integer
  products are int32 (kernels) or float64 (plain ops), exact at any bias;
- the `FUSED_EXPAND_S2_I8*` knobs and the named-act kernels behind them
  (block 1 and the block-13 bridge run the one int8 inverted-residual
  block here; `_six_ok` with them: the tile's ReLU6 bound takes any six_q);
- block 0's Cout padding 16 -> 32 and the widened-input padding of the next
  block (lane packing).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..checkpoints import fold_bn_v2, init_params_v2
from ..models.mobilenet_v2 import V2Config
from ..ops.inverted_residual_i8 import inverted_residual_i8
from ..ops.separable_block_i8 import separable_block_i8
from ..ops.v3_block_i8 import v3_i8_kernel_weights
from ..oracle import numpy_ref
from . import ops as qops
from . import oracle as qoracle
from .model import Int8Pipeline, device_fc, device_layer, device_pw_layer, resolve_i8_routing
from .quantize import ACT_HIDDEN_SCALE, ACT_IN_SCALE, QuantLayer, _quant_layer, _quant_weight

# ---------------------------------------------------------------------------
# calibration + quantization (host side)
# ---------------------------------------------------------------------------

def scale_groups(config: V2Config) -> List[int]:
    """Group id per block OUTPUT (len 17). Block i joins block i-1's group
    when its residual adds onto it (stride 1, Cin == Cout); otherwise it
    starts a new group. Scales are shared within a group so the residual
    add needs no rescale."""
    gids: List[int] = []
    for i, (t, cin, cout, stride) in enumerate(config.block_defs):
        if i > 0 and stride == 1 and cin == cout:
            gids.append(gids[-1])
        else:
            gids.append(gids[-1] + 1 if gids else 0)
    return gids


def calibrate_v2(folded: Dict[str, Any], config: V2Config, *,
                 n_images: int = 32, seed: int = 1234) -> List[np.float32]:
    """Per-block bottleneck output scales from the fp32 oracle's taps on
    structured synthetic images. Returns s_blk (len 17), group-shared."""
    from ..runtime.eval import synth_images  # noqa: PLC0415

    imgs = synth_images(config, n_images, seed)
    x = (np.stack(imgs).astype(np.float32) / 127.5) - 1.0
    _, acts = numpy_ref.forward_all_v2(folded, x, config)
    gids = scale_groups(config)
    absmax = {g: 0.0 for g in gids}
    for i, g in enumerate(gids):
        for tap in (f"block{i:02d}_prj", f"block{i:02d}_out"):
            if tap in acts:
                absmax[g] = max(absmax[g], float(np.abs(acts[tap]).max()))
    return [np.float32(max(absmax[g], 1e-6) / 127.0) for g in gids]


@dataclasses.dataclass
class V2QuantizedParams:
    """Full quantized V2 model (weights + scales), host-side numpy."""

    conv1: QuantLayer
    blocks: List[Dict[str, QuantLayer]]
    conv_last: QuantLayer
    fc_w_i8: np.ndarray
    fc_s_w: np.ndarray
    fc_b_f32: np.ndarray
    s_blk: List[np.float32]  # bottleneck scale per block output
    config: Any = None


def quantize_v2(folded: Dict[str, Any], config: V2Config, *,
                n_calib: int = 32, seed: int = 1234) -> V2QuantizedParams:
    """Fold-BN fp32 V2 tree -> int8 model with per-layer requant constants.
    The projection layers' `m` maps the int32 accumulator to the calibrated
    group scale; their `six_q` is unused (linear)."""
    s_blk = calibrate_v2(folded, config, n_images=n_calib, seed=seed)
    conv1 = _quant_layer(folded["conv1"]["w"], folded["conv1"]["b"],
                         out_axis=3, s_in=ACT_IN_SCALE, s_out=ACT_HIDDEN_SCALE)
    blocks: List[Dict[str, QuantLayer]] = []
    s_in_blk = ACT_HIDDEN_SCALE  # block 0's dw consumes conv1's output
    for i, blk in enumerate(folded["blocks"]):
        qblk: Dict[str, QuantLayer] = {}
        if "exp" in blk:
            qblk["exp"] = _quant_layer(blk["exp"]["w"], blk["exp"]["b"], out_axis=1,
                                       s_in=s_in_blk, s_out=ACT_HIDDEN_SCALE)
        qblk["dw"] = _quant_layer(blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                                  s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE,
                                  dw_bias_bound=True)
        qblk["prj"] = _quant_layer(blk["prj"]["w"], blk["prj"]["b"], out_axis=1,
                                   s_in=ACT_HIDDEN_SCALE, s_out=s_blk[i])
        blocks.append(qblk)
        s_in_blk = s_blk[i]
    conv_last = _quant_layer(folded["conv_last"]["w"], folded["conv_last"]["b"],
                             out_axis=1, s_in=s_in_blk, s_out=ACT_HIDDEN_SCALE)
    fc_w_i8, fc_s_w = _quant_weight(np.asarray(folded["fc"]["w"], np.float32), out_axis=1)
    return V2QuantizedParams(
        conv1=conv1, blocks=blocks, conv_last=conv_last, fc_w_i8=fc_w_i8, fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded["fc"]["b"], np.float32), s_blk=s_blk, config=config,
    )


# ---------------------------------------------------------------------------
# NumPy golden twin (exact)
# ---------------------------------------------------------------------------

def _requant_linear(acc_i32: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Signed linear requant: no ReLU, round-half-even, clamp [-128, 127]."""
    v = acc_i32.astype(np.float32) * m.astype(np.float32)
    return np.clip(np.rint(v), -128, 127).astype(np.int8)


def _res_add(prj_i8: np.ndarray, y_i8: np.ndarray) -> np.ndarray:
    """Saturating int8 residual add (operands share one group scale)."""
    return np.clip(prj_i8.astype(np.int32) + y_i8.astype(np.int32),
                   -128, 127).astype(np.int8)


def pw_i8_linear(x, w, bias_i32, m):
    acc = x.astype(np.int64) @ w.astype(np.int64)
    return _requant_linear(acc.astype(np.int32) + bias_i32, m)


def forward_all_v2_i8(q: V2QuantizedParams, x_i8: np.ndarray, config: V2Config):
    """Full int8 golden V2 forward -> (logits, {tap: array}); tap names match
    the device route's collect mode."""
    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = qoracle.conv3x3_i8(x_i8, c1.w_i8, c1.bias_i32, c1.m, c1.six_q, 2, relu6)
    acts["conv1"] = y
    for i, ((t, cin, cout, stride), blk) in enumerate(zip(config.block_defs, q.blocks)):
        z = y
        if "exp" in blk:
            e = blk["exp"]
            z = qoracle.pw_i8(z, e.w_i8, e.bias_i32, e.m, e.six_q, relu6)
            acts[f"block{i:02d}_exp"] = z
        d = blk["dw"]
        z = qoracle.dw3x3_i8(z, d.w_i8, d.bias_i32, d.m, d.six_q, stride, relu6)
        acts[f"block{i:02d}_dw"] = z
        p = blk["prj"]
        out = pw_i8_linear(z, p.w_i8, p.bias_i32, p.m)
        acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            out = _res_add(out, y)
            acts[f"block{i:02d}_out"] = out
        y = out
    cl = q.conv_last
    y = qoracle.pw_i8(y, cl.w_i8, cl.bias_i32, cl.m, cl.six_q, relu6)
    acts["conv_last"] = y
    pooled = qoracle.avgpool_i8(y)
    acts["pool"] = pooled
    logits = qoracle.fc_i8_logits(pooled, q.fc_w_i8, ACT_HIDDEN_SCALE, q.fc_s_w, q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# device path
# ---------------------------------------------------------------------------

def to_device_i8_v2(q, device) -> Dict[str, Any]:
    """Quantized constants onto `device`, once (`quant.model.device_layer`;
    the projection of block 0, which the fused separable block runs, with its
    K-major copy, `device_pw_layer`; the layers of blocks 1-16 with the int8
    bottleneck tile's weight forms as "wt", `v3_i8_kernel_weights`). `q` is a
    V2QuantizedParams of this package or of the JAX package (both hold only
    numpy fields)."""
    def block(blk):
        if "exp" in blk:
            return v3_i8_kernel_weights({k: device_layer(v, device) for k, v in blk.items()})
        # t == 1: the separable block's projection
        return {k: (device_pw_layer if k == "prj" else device_layer)(v, device)
                for k, v in blk.items()}

    return {
        "conv1": device_layer(q.conv1, device),
        "blocks": [block(blk) for blk in q.blocks],
        "conv_last": device_layer(q.conv_last, device),
        "fc": device_fc(q, device),
    }


def _routing_v2_i8(config: V2Config, dw_backend, batch: int) -> Tuple[str, ...]:
    """Resolve the per-block backend tuple (len == 17), as
    quant.model._routing_i8 (`resolve_i8_routing`): "auto" is "fused" at
    every batch (the JAX package's V2 "auto" is fused at batch 1 too; its
    use_fused=True is "fused")."""
    return resolve_i8_routing(len(config.block_defs), dw_backend)


def forward_v2_i8(dev: Dict[str, Any], x_i8: torch.Tensor, config: V2Config, *,
                  dw_backend=None, collect: bool = False):
    """x_i8: (N, H, W, 3) quantized input at s_in = 1/127 (int8).

    collect=True runs every block on the plain route and also returns each
    layer's output by tap name (conv1, blockNN_exp, blockNN_dw, blockNN_prj,
    blockNN_out on residual blocks, conv_last, pool, logits). Every route
    is the same integer program: its logits equal forward_all_v2_i8's.
    Returns float32 logits (N, classes), or (logits, {tap: tensor})."""
    acts: Dict[str, torch.Tensor] = {}
    relu6 = config.relu6
    routing = _routing_v2_i8(config, dw_backend, int(x_i8.shape[0]))

    c1 = dev["conv1"]
    y = qops.conv1_i8(x_i8, c1["w"], c1["b"], c1["m"], c1["six_q"], relu6)
    if collect:
        acts["conv1"] = y
    for i, ((_t, cin, cout, stride), blk) in enumerate(zip(config.block_defs, dev["blocks"])):
        res = stride == 1 and cin == cout
        d, p = blk["dw"], blk["prj"]
        if routing[i] == "fused" and not collect:
            if "exp" in blk:
                e = blk["exp"]
                y = inverted_residual_i8(y, e["w"], e["b"], e["m"], e["six_q"], d["w"], d["b"],
                                         d["m"], d["six_q"], p["w"], p["b"], p["m"], stride, res,
                                         wt={"exp": e["wt"], "dw": d["wt"], "prj": p["wt"]})
            else:  # t == 1: block 0, never a residual block
                y = separable_block_i8(y, d["w"], d["b"], d["m"], p["w"], p["b"], p["m"],
                                       stride, d["six_q"], 0.0, relu6, pw_linear=True,
                                       pw_wt=p["wt"])
            continue
        z = y
        if "exp" in blk:
            e = blk["exp"]
            z = qops.pointwise_i8(z, e["w"], e["b"], e["m"], e["six_q"], relu6)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        z = qops.depthwise_i8(z, d["w"], d["b"], d["m"], d["six_q"], stride, relu6)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        out = qops.pointwise_i8_linear(z, p["w"], p["b"], p["m"])
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if res:
            out = qops.residual_add_i8(out, y)
            if collect:
                acts[f"block{i:02d}_out"] = out
        y = out

    cl = dev["conv_last"]
    y = qops.pointwise_i8(y, cl["w"], cl["b"], cl["m"], cl["six_q"], relu6)
    if collect:
        acts["conv_last"] = y
    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    fc = dev["fc"]
    logits = qops.fc_i8_logits(pooled, fc["w"], ACT_HIDDEN_SCALE, fc["s_w"], fc["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


class Int8PipelineV2(Int8Pipeline):
    """Device-resident int8 V2 constants and the uint8 -> probabilities
    entry: the `.config` / `run_batch` surface MicroBatchServer needs, plus
    classify and benchmark() (Int8Pipeline's, on forward_v2_i8)."""

    _forward = staticmethod(forward_v2_i8)

    def __init__(self, config: V2Config, params=None, *, device="cuda", seed: int = 0,
                 dw_backend: Any = "auto", quantized=None, mesh=None):
        """`params`: a folded host tree (numpy leaves); None draws the seeded
        weight set; it is calibrated and quantized here (`quantize_v2`).
        `quantized`: a V2QuantizedParams of either package instead, used as
        it is. `device`: "cuda" (default), "cuda:N" or "cpu". `dw_backend`:
        "auto" (the kernels), "plain", "fused", or a per-block tuple
        (_routing_v2_i8). `mesh`: data-parallel over a parallel.mesh.Mesh
        (runtime/pipeline.py); `device` is then unused."""
        self.config = config
        self.device = self._init_mesh(mesh, device)
        self.dw_backend = dw_backend
        if quantized is None:
            folded = params if params is not None else fold_bn_v2(
                init_params_v2(config, seed=seed), eps=config.bn_eps)
            quantized = quantize_v2(folded, config)
        self.q = quantized
        self.dev = to_device_i8_v2(quantized, self.device)
        self._replicate()
