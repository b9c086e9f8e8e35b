"""INT8 MobileNet-V3: calibration and quantization, the exact NumPy oracle,
the int8 forward and `Int8PipelineV3`; the port of the JAX package's
`quant/v3.py`.

The scheme calibrates every activation scale: s_tap = absmax/127 over the
float32 NumPy oracle's taps (`oracle/numpy_ref.forward_all_v3`, copied
verbatim from the JAX package) on the seeded structured images of
`runtime.eval.synth_images`. Residual-connected runs share one scale group
(V2's rule), so the residual stays a saturating int8 add. Each layer maps
its int32 accumulator to real units with a per-channel float32 `a` = s_in x
s_w and quantizes with inv_s = 1/s_out, in the folded order
(`FOLDED_REQUANT = True` in the JAX package; quant/ops.requantize_named):
  relu / linear: q = clamp(rint(float32(acc) * m), 0 or -128, 127),
                 m = float32(a) * float32(inv_s);
  hswish:        v = float32(acc) * a; t = clip(v + 3, 0, 6);
                 q = clamp(rint((v * t) * m6), -128, 127),
                 m6 = float32(inv_s) * float32(1/6).
The squeeze-excite gate is quantized: the pooled mean rides the depthwise
scale (exact int sum, one float32 multiply, rint), both SE convs are int8
with int32 sums, its mid activation has its own calibrated scale (g1,
computed on the host from the depthwise tap), and only the hard sigmoid and
the gate multiply are float32 elementwise. All scale arithmetic is host-side
float32, so a folded tree quantizes to the same integers and constants in
both packages, and every route is held to the oracle by exact equality.

Routes per block (`forward_v3_i8`): "plain" runs the plain int8 ops (the
reference route; the JAX package's XLA route); "fused" runs one int8 V3
bottleneck kernel per block (ops/v3_block_i8.py): on MobileNet-V3-Large,
block 0 with the identity expansion, block 1 with its expansion at stride
2, blocks 2-14 as they are; on MobileNet-V3-Small, all 11 blocks, block 0
with the identity expansion at stride 2 and the quantized SE (the JAX
package's `packed_block_i8_named_s2_se`). "auto" is "fused" at every batch
(the JAX package resolves V3-Small's "auto" to fused at batch 1 too). The
stem, input quantization, conv_last, pool, head, fc and softmax are plain
ops on every route (XLA ops in the JAX package).

Not ported:
- the two-multiply requant order (`FOLDED_REQUANT = False`), the JAX
  package's raced option: the port runs the folded order only;
- the TPU layouts and their guards: the bf16 integer carriage
  (`CARRY_MIN_H`, `_fused_plan_v3`, `_pw_acc_carrier_dev`, `_xla_block_v3_i8`
  as a fallback), the lane `pack`/`unpack`, the 128-column projection
  padding and the widened-input padding of the next block, the
  `_dot_bias_ok`/`_packed_bias_ok` bounds (the port's integer products are
  int32 in the kernel and float64 in the plain ops, exact at any bias), and
  the knobs `FUSED_EXPAND_S2_I8`, `PACKED_EXPAND_S2_I8`, `PRJ_BF16_DOT`.
Activations stay int8 between blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..checkpoints import fold_bn_v3, init_params_v3
from ..models.mobilenet_v3 import V3Config
from ..ops.v3_block_i8 import v3_block_i8, v3_i8_kernel_weights
from ..oracle import numpy_ref
from . import ops as qops
from . import oracle as qoracle
from .model import Int8Pipeline, _put, device_fc, resolve_i8_routing
from .quantize import ACT_IN_SCALE, _quant_weight

# ---------------------------------------------------------------------------
# host-side quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QLayerN:
    """One named-activation quantized layer: int8 weights + constants.
    `a` maps the int32 accumulator to real float32 units; `inv_s` quantizes
    the activated value into the consumer's scale."""

    w_i8: np.ndarray
    bias_i32: np.ndarray
    a: np.ndarray          # (Cout,) f32 = s_in * s_w
    inv_s: np.float32      # 1 / s_out
    s_out: np.float32


def _quant_named(w, b, out_axis, s_in, s_out, *, k_taps: int = 0) -> QLayerN:
    """One layer's int8 weights, int32 bias and constants. With k_taps (a
    depthwise of k*k taps), the bias must stay within the JAX package's
    exact-f32-integer accumulation bound, 2^24 - 2 x k_taps x 127^2: the
    port sums in int32 and would be exact past it, but a checkpoint valid
    for one package stays valid for both."""
    w_i8, s_w = _quant_weight(np.asarray(w, np.float32), out_axis)
    a = (np.float32(s_in) * s_w).astype(np.float32)
    bias_i32 = np.clip(np.rint(np.asarray(b, np.float32) / a),
                       -(2 ** 31) + 1, 2 ** 31 - 1).astype(np.int32)
    if k_taps and np.abs(bias_i32).max(initial=0) > 2 ** 24 - 2 * k_taps * 127 * 127:
        raise ValueError(
            "quantized dw bias exceeds the exact-f32-integer accumulation "
            f"bound for k_taps={k_taps} (|bias_i32|_max = {np.abs(bias_i32).max()})")
    return QLayerN(w_i8=w_i8, bias_i32=bias_i32, a=a,
                   inv_s=np.float32(1.0 / np.float32(s_out)), s_out=np.float32(s_out))


def scale_groups_v3(config: V3Config) -> List[int]:
    """Group id per block output (V2's rule): block i joins block i-1's
    group when its residual adds onto it; scales are shared per group so
    the residual add needs no rescale."""
    gids: List[int] = []
    for i, bd in enumerate(config.block_defs):
        if i > 0 and bd.has_res:
            gids.append(gids[-1])
        else:
            gids.append(gids[-1] + 1 if gids else 0)
    return gids


def _scale_of(arr: np.ndarray) -> np.float32:
    return np.float32(max(float(np.abs(arr).max()), 1e-6) / 127.0)


def calibrate_v3(folded: Dict[str, Any], config: V3Config, *,
                 n_images: int = 32, seed: int = 1234) -> Dict[str, Any]:
    """Activation scales from the float32 oracle's taps on structured
    synthetic images: {conv1, blocks: [{exp?, dw, g1?}], s_blk, conv_last,
    head}. SE's mid activation (g1) is derived on the host from the dw tap,
    in numpy, as the JAX package does."""
    from ..runtime.eval import synth_images  # noqa: PLC0415

    imgs = synth_images(config, n_images, seed)
    x = (np.stack(imgs).astype(np.float32) / 127.5) - 1.0
    _, acts = numpy_ref.forward_all_v3(folded, x, config)

    gids = scale_groups_v3(config)
    absmax = {g: 0.0 for g in gids}
    blocks: List[Dict[str, np.float32]] = []
    for i, (bd, blk) in enumerate(zip(config.block_defs, folded["blocks"])):
        ent: Dict[str, np.float32] = {}
        if bd.has_expand:
            ent["exp"] = _scale_of(acts[f"block{i:02d}_exp"])
        dw_tap = acts[f"block{i:02d}_dw"]
        ent["dw"] = _scale_of(dw_tap)
        if bd.se_mid:
            pooled = dw_tap.astype(np.float32).mean(axis=(1, 2))
            g1 = np.maximum(
                pooled @ np.asarray(blk["se"]["w1"], np.float32)
                + np.asarray(blk["se"]["b1"], np.float32), 0.0)
            ent["g1"] = _scale_of(g1)
        blocks.append(ent)
        g = gids[i]
        for tap in (f"block{i:02d}_prj", f"block{i:02d}_out"):
            if tap in acts:
                absmax[g] = max(absmax[g], float(np.abs(acts[tap]).max()))
    s_blk = [np.float32(max(absmax[g], 1e-6) / 127.0) for g in gids]
    return {
        "conv1": _scale_of(acts["conv1"]),
        "blocks": blocks,
        "s_blk": s_blk,
        "conv_last": _scale_of(acts["conv_last"]),
        "head": _scale_of(acts["head"]),
    }


@dataclasses.dataclass
class V3QuantizedParams:
    """Full quantized V3 model (weights + scales), host-side numpy."""

    conv1: QLayerN
    blocks: List[Dict[str, Any]]
    conv_last: QLayerN
    head: QLayerN
    fc_w_i8: np.ndarray
    fc_s_w: np.ndarray
    fc_b_f32: np.ndarray
    s_head: np.float32
    config: Any = None


def quantize_v3(folded: Dict[str, Any], config: V3Config, *,
                n_calib: int = 32, seed: int = 1234) -> V3QuantizedParams:
    """Fold-BN float32 V3 tree -> int8 model with calibrated constants."""
    cal = calibrate_v3(folded, config, n_images=n_calib, seed=seed)
    conv1 = _quant_named(folded["conv1"]["w"], folded["conv1"]["b"],
                         out_axis=3, s_in=ACT_IN_SCALE, s_out=cal["conv1"])
    blocks: List[Dict[str, Any]] = []
    s_in_blk = cal["conv1"]
    for i, (bd, blk) in enumerate(zip(config.block_defs, folded["blocks"])):
        ent: Dict[str, Any] = {}
        c = cal["blocks"][i]
        s = s_in_blk
        if bd.has_expand:
            ent["exp"] = _quant_named(blk["exp"]["w"], blk["exp"]["b"],
                                      out_axis=1, s_in=s, s_out=c["exp"])
            s = c["exp"]
        ent["dw"] = _quant_named(blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                                 s_in=s, s_out=c["dw"], k_taps=bd.kernel * bd.kernel)
        if bd.se_mid:
            # pooled rides the dw scale; w2's output lands in real units
            # (the hard sigmoid needs them), so its "s_out" is 1.0
            ent["se1"] = _quant_named(blk["se"]["w1"], blk["se"]["b1"],
                                      out_axis=1, s_in=c["dw"], s_out=c["g1"])
            ent["se2"] = _quant_named(blk["se"]["w2"], blk["se"]["b2"],
                                      out_axis=1, s_in=c["g1"], s_out=1.0)
        ent["prj"] = _quant_named(blk["prj"]["w"], blk["prj"]["b"],
                                  out_axis=1, s_in=c["dw"], s_out=cal["s_blk"][i])
        blocks.append(ent)
        s_in_blk = cal["s_blk"][i]
    conv_last = _quant_named(folded["conv_last"]["w"], folded["conv_last"]["b"],
                             out_axis=1, s_in=s_in_blk, s_out=cal["conv_last"])
    head = _quant_named(folded["head"]["w"], folded["head"]["b"],
                        out_axis=1, s_in=cal["conv_last"], s_out=cal["head"])
    fc_w_i8, fc_s_w = _quant_weight(np.asarray(folded["fc"]["w"], np.float32), out_axis=1)
    return V3QuantizedParams(
        conv1=conv1, blocks=blocks, conv_last=conv_last, head=head,
        fc_w_i8=fc_w_i8, fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded["fc"]["b"], np.float32),
        s_head=cal["head"], config=config)


# ---------------------------------------------------------------------------
# NumPy golden twin (exact), the folded requant order
# ---------------------------------------------------------------------------


def _requant_named_np(acc_i32, a, inv_s, act):
    if act == "hswish":
        v = acc_i32.astype(np.float32) * np.asarray(a, np.float32)
        t = np.clip(v + np.float32(3.0), 0.0, 6.0)
        q = np.rint((v * t) * (np.float32(inv_s) * np.float32(1.0 / 6.0)))
        return np.clip(q, -128, 127).astype(np.int8)
    assert act in ("relu", "linear"), act
    m = np.asarray(a, np.float32) * np.float32(inv_s)
    q = np.rint(acc_i32.astype(np.float32) * m)
    lo = 0 if act == "relu" else -128
    return np.clip(q, lo, 127).astype(np.int8)


def _dwk_acc_np(x_i8, w_i8, stride, k):
    lo_h, hi_h = numpy_ref.same_pad(x_i8.shape[1], stride, k)
    lo_w, hi_w = numpy_ref.same_pad(x_i8.shape[2], stride, k)
    h_out = -(-x_i8.shape[1] // stride)
    w_out = -(-x_i8.shape[2] // stride)
    xp = np.pad(x_i8.astype(np.int32), ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = np.zeros((x_i8.shape[0], h_out, w_out, x_i8.shape[3]), np.int32)
    wi = w_i8.astype(np.int32)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, dy:dy + h_out * stride:stride, dx:dx + w_out * stride:stride, :] \
                * wi[dy, dx, 0]
    return acc


def _conv3x3_acc_np(x_i8, w_i8, stride):
    lo_h, hi_h = numpy_ref.same_pad(x_i8.shape[1], stride, 3)
    lo_w, hi_w = numpy_ref.same_pad(x_i8.shape[2], stride, 3)
    h_out = -(-x_i8.shape[1] // stride)
    w_out = -(-x_i8.shape[2] // stride)
    xp = np.pad(x_i8.astype(np.int64), ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = np.zeros((x_i8.shape[0], h_out, w_out, w_i8.shape[3]), np.int64)
    wi = w_i8.astype(np.int64)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy:dy + h_out * stride:stride, dx:dx + w_out * stride:stride, :]
            acc += patch @ wi[dy, dx]
    return acc.astype(np.int32)


def _pw_acc_np(x_i8, w_i8):
    return (x_i8.astype(np.int64) @ w_i8.astype(np.int64)).astype(np.int32)


def _se_i8_np(z_i8, se1: QLayerN, se2: QLayerN):
    """Quantized SE gate: int sums and products, float32 only elementwise."""
    hw = z_i8.shape[1] * z_i8.shape[2]
    sum32 = z_i8.astype(np.int32).sum(axis=(1, 2))
    pooled = np.clip(np.rint(sum32.astype(np.float32) * np.float32(1.0 / hw)),
                     -128, 127).astype(np.int8)
    g1 = _requant_named_np(_pw_acc_np(pooled, se1.w_i8) + se1.bias_i32,
                           se1.a, se1.inv_s, "relu")
    acc2 = _pw_acc_np(g1, se2.w_i8) + se2.bias_i32
    v = acc2.astype(np.float32) * se2.a.astype(np.float32)  # real units
    gate = np.clip(v + np.float32(3.0), 0.0, 6.0) * np.float32(1.0 / 6.0)
    out = np.rint(z_i8.astype(np.float32) * gate[:, None, None, :])
    return np.clip(out, -128, 127).astype(np.int8)


def forward_all_v3_i8(q: V3QuantizedParams, x_i8: np.ndarray, config: V3Config):
    """Full int8 golden V3 forward -> (logits, {tap: array}); tap names match
    the device route's collect mode."""
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = _requant_named_np(_conv3x3_acc_np(x_i8, c1.w_i8, 2) + c1.bias_i32,
                          c1.a, c1.inv_s, config.head_act)
    acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, q.blocks)):
        z = y
        if bd.has_expand:
            e = blk["exp"]
            z = _requant_named_np(_pw_acc_np(z, e.w_i8) + e.bias_i32, e.a, e.inv_s, bd.act)
            acts[f"block{i:02d}_exp"] = z
        d = blk["dw"]
        z = _requant_named_np(_dwk_acc_np(z, d.w_i8, bd.stride, bd.kernel) + d.bias_i32,
                              d.a, d.inv_s, bd.act)
        acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = _se_i8_np(z, blk["se1"], blk["se2"])
            acts[f"block{i:02d}_se"] = z
        p = blk["prj"]
        out = _requant_named_np(_pw_acc_np(z, p.w_i8) + p.bias_i32, p.a, p.inv_s, "linear")
        acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = np.clip(out.astype(np.int32) + y.astype(np.int32), -128, 127).astype(np.int8)
            acts[f"block{i:02d}_out"] = out
        y = out
    cl = q.conv_last
    y = _requant_named_np(_pw_acc_np(y, cl.w_i8) + cl.bias_i32, cl.a, cl.inv_s,
                          config.head_act)
    acts["conv_last"] = y
    pooled = qoracle.avgpool_i8(y)
    acts["pool"] = pooled
    hd = q.head
    h = _requant_named_np(_pw_acc_np(pooled, hd.w_i8) + hd.bias_i32, hd.a, hd.inv_s,
                          config.head_act)
    acts["head"] = h
    logits = qoracle.fc_i8_logits(h, q.fc_w_i8, q.s_head, q.fc_s_w, q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# device path
# ---------------------------------------------------------------------------


def device_layer_v3(layer, device) -> Dict[str, Any]:
    """One QLayerN on `device`: int8 "w", int32 "b", float32 "a", and the
    requant constants computed here in numpy float32, once: "m" =
    float32(a) * float32(inv_s) (relu and linear) and "m6" =
    float32(inv_s) * float32(1/6) (hswish), as a Python float."""
    a = np.asarray(layer.a, np.float32)
    inv_s = np.float32(layer.inv_s)
    return {"w": _put(layer.w_i8, device), "b": _put(layer.bias_i32, device),
            "a": _put(a, device), "m": _put(a * inv_s, device),
            "m6": float(inv_s * np.float32(1.0 / 6.0)), "inv_s": float(inv_s)}


def to_device_i8_v3(q, device) -> Dict[str, Any]:
    """Quantized constants onto `device`, once. `q` is a V3QuantizedParams
    of this package or of the JAX package (both hold only numpy fields). The
    blocks' layers also hold the int8 V3 kernel's weight forms ("wt",
    ops/v3_block_i8.v3_i8_kernel_weights)."""
    return {
        "conv1": device_layer_v3(q.conv1, device),
        "blocks": [v3_i8_kernel_weights({k: device_layer_v3(v, device) for k, v in blk.items()})
                   for blk in q.blocks],
        "conv_last": device_layer_v3(q.conv_last, device),
        "head": device_layer_v3(q.head, device),
        "fc": device_fc(q, device),
        "s_head": float(q.s_head),
    }


def _routing_v3_i8(config: V3Config, dw_backend, batch: int) -> Tuple[str, ...]:
    """Resolve the per-block backend tuple (`resolve_i8_routing`: None ->
    "plain", "auto" -> "fused" at every batch, a name, or one name per
    block), for V3-Large and V3-Small alike."""
    return resolve_i8_routing(len(config.block_defs), dw_backend)


def forward_v3_i8(dev: Dict[str, Any], x_i8: torch.Tensor, config: V3Config, *,
                  dw_backend=None, collect: bool = False):
    """x_i8: (N, H, W, 3) quantized input at s_in = 1/127 (int8).

    collect=True runs every block on the plain route and also returns each
    layer's output by tap name (conv1, blockNN_exp/_dw/_se/_prj, blockNN_out
    on residual blocks, conv_last, pool, head, logits). Every route is the
    same integer program: its logits equal forward_all_v3_i8's.
    Returns float32 logits (N, classes), or (logits, {tap: tensor})."""
    acts: Dict[str, torch.Tensor] = {}
    routing = _routing_v3_i8(config, dw_backend, int(x_i8.shape[0]))

    c1 = dev["conv1"]
    y = qops.requantize_named(qops.conv1_acc_i8(x_i8, c1["w"]) + c1["b"], c1, config.head_act)
    if collect:
        acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, dev["blocks"])):
        if routing[i] == "fused" and not collect:
            y = v3_block_i8(y, blk.get("exp"), blk["dw"], blk["prj"], k=bd.kernel,
                            stride=bd.stride, act=bd.act, se1=blk.get("se1"),
                            se2=blk.get("se2"), residual=bd.has_res)
            continue
        z = y
        if bd.has_expand:
            z = qops.pointwise_i8_named(z, blk["exp"], bd.act)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        d = blk["dw"]
        z = qops.requantize_named(qops.depthwise_acc_i8(z, d["w"], bd.stride) + d["b"], d,
                                  bd.act)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = qops.se_i8(z, blk["se1"], blk["se2"])
            if collect:
                acts[f"block{i:02d}_se"] = z
        out = qops.pointwise_i8_named(z, blk["prj"], "linear")
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = qops.residual_add_i8(out, y)
            if collect:
                acts[f"block{i:02d}_out"] = out
        y = out

    y = qops.pointwise_i8_named(y, dev["conv_last"], config.head_act)
    if collect:
        acts["conv_last"] = y
    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    h = qops.pointwise_i8_named(pooled, dev["head"], config.head_act)
    if collect:
        acts["head"] = h
    fc = dev["fc"]
    logits = qops.fc_i8_logits(h, fc["w"], dev["s_head"], fc["s_w"], fc["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


class Int8PipelineV3(Int8Pipeline):
    """Device-resident int8 V3 constants and the uint8 -> probabilities
    entry: the `.config` / `run_batch` surface MicroBatchServer needs, plus
    classify and benchmark() (Int8Pipeline's, on forward_v3_i8)."""

    _forward = staticmethod(forward_v3_i8)

    def __init__(self, config: V3Config, params=None, *, device="cuda", seed: int = 0,
                 dw_backend: Any = "auto", quantized=None, mesh=None):
        """`params`: a folded host tree (numpy leaves); None draws the seeded
        weight set; it is calibrated and quantized here (`quantize_v3`).
        `quantized`: a V3QuantizedParams of either package instead, used as
        it is. `device`: "cuda" (default), "cuda:N" or "cpu". `dw_backend`:
        "auto" (the kernel), "plain", "fused", or a per-block tuple
        (_routing_v3_i8), for V3-Large and V3-Small. `mesh`: data-parallel
        over a parallel.mesh.Mesh (runtime/pipeline.py); `device` is then
        unused."""
        _routing_v3_i8(config, dw_backend, 1)
        self.config = config
        self.device = self._init_mesh(mesh, device)
        self.dw_backend = dw_backend
        if quantized is None:
            folded = params if params is not None else fold_bn_v3(
                init_params_v3(config, seed=seed), eps=config.bn_eps)
            quantized = quantize_v3(folded, config)
        self.q = quantized
        self.dev = to_device_i8_v3(quantized, self.device)
        self._replicate()
