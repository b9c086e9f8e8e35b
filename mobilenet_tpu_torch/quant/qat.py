"""Quantization-aware training (QAT) for the int8 fixed-point scheme: the
port of the JAX package's `quant/qat.py`, function for function.

The forward carries the QUANTIZED integers themselves in float32, so its
activations equal the int8 oracles' bit for bit (`quant/oracle.forward_all`,
`quant/v2.forward_all_v2_i8`, `quant/v3.forward_all_v3_i8`), while
straight-through shadows carry real-unit gradients:

  value path (exact ints in float32)      gradient shadow
  q_x  = clip(rint(x/s_in), +-127)        x / s_in
  w_q  = clip(rint(w/s_w[oc]), +-127)     w / s_w[oc]         (s_w detached)
  b_q  = rint(b / (s_in*s_w[oc]))         b / (s_in*s_w[oc])
  acc  = conv(q_x, w_q) + b_q             exact while |values| < 2^24
  q_y  = rint(clamp(acc*m, 0, six_q))     acc*m               (m detached)

Every scale constant is detached, so the gradients are those of real-units
STE QAT, while the forward value is the deployed int8 network.

Exactness on the card and on the CPU:
- every product is <= 127*127 and the worst sum, V1's pointwise at alpha
  1.0 (Cin 1024), is 1024*16129 < 2^24, so a float32 sum of them is exact
  in any order; V2's and V3's fc over 1280 inputs pass that worst-case
  bound, as in the JAX package, which gates it on seeded runs;
- the stem is an im2col product of its 27 taps and the depthwise its k*k
  shifted-slice FMAs (`ops.conv.dw_taps_f32`, dy then dx from zero): no
  cuDNN convolution, whose Winograd or FFT algorithms would round; the
  products run under `ops.conv.no_tf32`;
- every scale is a float32 device tensor, combined in the JAX package's
  order of operations (`s_in * s_w / s_h`, `float32(s) * s_w`,
  float32(1 / s_out) from the Python double): PyTorch's CUDA division by a
  CPU scalar multiplies by its reciprocal, and a Python double must not
  change a rounding;
- `torch.round` rounds half to even, as `jnp.round`;
- the shadows' clips are `torch.maximum`/`torch.minimum`, whose gradient
  splits at a tie as `jnp.clip`'s and `jnp.maximum`'s do (an integer-valued
  accumulator meets a bound exactly).
MobileNet-V3's named requant runs the folded order only (quant/v3.py;
FOLDED_REQUANT in the JAX package).

Always the differentiable plain route: a training graph; the kernels are
inference-only. Logits are real-unit floats, as the int8 heads' are.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.train import sgd_trainer
from ..ops.conv import dw_taps_f32, no_tf32, same_pads
from .quantize import ACT_HIDDEN_SCALE, ACT_IN_SCALE

# six_q for the fixed 6/127 hidden activation scale: 6 / (6/127) = 127.
_HIDDEN_SIX_Q = 127.0


def _f32(value, device) -> torch.Tensor:
    """np.float32(value) as a 0-dim float32 tensor on `device`, filled on
    the device (no host-to-device copy, which would wait for the stream)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): maximum, then minimum, ties split in the
    gradient."""
    return torch.minimum(torch.maximum(x, _f32(lo, x.device)), _f32(hi, x.device))


def _ste(shadow: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Value of `value`, gradient of `shadow` (straight-through)."""
    return shadow + (value - shadow).detach()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 (M, K) @ (K, N), IEEE on the card (Precision.HIGHEST)."""
    with no_tf32(a):
        return a @ b


def fq_input(x: torch.Tensor, s_in: float = float(ACT_IN_SCALE)) -> torch.Tensor:
    """[-1,1] floats -> integer-domain input (twin of quantize.quantize_input)."""
    v = x.float() / _f32(s_in, x.device)
    return _ste(v, torch.round(v).clamp(-127, 127))


def fq_weight(w: torch.Tensor, out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel integer weights (twin of quantize._quant_weight).

    Returns (w_q carrying exact ints in float32, s_w broadcast-shaped,
    detached)."""
    wf = w.float()
    red = tuple(i for i in range(wf.ndim) if i != out_axis)
    absmax = wf.detach().abs().amax(dim=red).clamp_min(1e-12)
    shape = [1] * wf.ndim
    shape[out_axis] = -1
    s_w = (absmax / _f32(127.0, w.device)).reshape(shape)
    v = wf / s_w
    return _ste(v, torch.round(v).clamp(-127, 127)), s_w


def fq_bias(b: torch.Tensor, acc_scale: torch.Tensor) -> torch.Tensor:
    """Accumulator-unit bias (twin of quantize's bias_i32), STE'd."""
    v = b.float() / acc_scale.reshape(-1).float().detach()
    return _ste(v, torch.round(v))


def fq_requant(acc: torch.Tensor, m: torch.Tensor, six_q: float = _HIDDEN_SIX_Q,
               relu6: bool = True) -> torch.Tensor:
    """Integer accumulator -> next layer's integers (twin of qops.requantize)."""
    v = acc * m.reshape(-1).float().detach()
    v = torch.maximum(v, _f32(0.0, v.device))
    if relu6:
        v = torch.minimum(v, _f32(six_q, v.device))
    return _ste(v, torch.round(v))


def fq_requant_linear(acc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Signed linear requant (twin of quant/v2._requant_linear): no ReLU,
    round half to even FIRST, then clamp to [-128, 127] (clamp-then-round
    would round 127.5 to 128). The shadow is the clamped pre-round value
    (clipped STE)."""
    v = acc * m.reshape(-1).float().detach()
    return _ste(_clip(v, -128.0, 127.0), torch.round(v).clamp(-128, 127))


def _dw3x3_taps(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise 3x3 as 9 shifted-slice FMAs: exact integers and
    differentiable."""
    return _dwk_taps(x, w, stride, 3)


def _dwk_taps(x: torch.Tensor, w: torch.Tensor, stride: int, k: int) -> torch.Tensor:
    """Depthwise k x k (k 3 or 5) shifted-slice FMAs in dy-then-dx order
    from zero (`ops.conv.dw_taps_f32`)."""
    if int(w.shape[0]) != k:
        raise ValueError(f"depthwise weight {tuple(w.shape)} is not {k}x{k}")
    return dw_taps_f32(x, w, stride)


def _stem_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3x3 stride-2 TF-SAME stem as an im2col product: the 9 shifted
    slices of x side by side in (dy, dx, c) order against the HWIO weight
    as (27, Cout). Integer-valued operands give exact sums (no cuDNN
    algorithm choice)."""
    n, h, wd, c = x.shape
    (ph0, ph1), (pw0, pw1) = same_pads(h, 2), same_pads(wd, 2)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    ho, wo = -(-h // 2), -(-wd // 2)
    cols = torch.cat([xp[:, dy:dy + 2 * (ho - 1) + 1:2, dx:dx + 2 * (wo - 1) + 1:2, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    return _dot(cols.reshape(n * ho * wo, 9 * c), w.reshape(9 * c, -1)).reshape(n, ho, wo, -1)


def _fq_pw_acc(q: torch.Tensor, w_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    n, hh, ww, ci = q.shape
    return (_dot(q.reshape(n * hh * ww, ci), w_q) + b_q).reshape(n, hh, ww, -1)


def _fq_pool_sat(q: torch.Tensor) -> torch.Tensor:
    """Integer-domain global pool: exact sum, float32 mean, rint, clip."""
    n, hh, ww, c = q.shape
    v = q.sum(dim=(1, 2)) * _f32(1.0 / (hh * ww), q.device)
    return _ste(v, torch.round(v).clamp(-128, 127))


def _fc_logits(pooled: torch.Tensor, fc: Dict[str, Any], s_in: torch.Tensor) -> torch.Tensor:
    """Classifier: integer product, float logits (twin of qops.fc_i8_logits)."""
    w_q, s_w = fq_weight(fc["w"], out_axis=1)
    acc = _dot(pooled, w_q)
    scale = s_in * s_w.reshape(-1)
    return acc * scale[None, :] + fc["b"].float()[None, :]


def qat_forward(params: Dict[str, Any], x: torch.Tensor, config: ModelConfig, *,
                collect: bool = False) -> Any:
    """MobileNet-V1 forward with the deployment quantizer in the graph.

    Mirrors quant/oracle.forward_all layer for layer; with collect=True the
    taps use the oracle's layer names and hold the same integers (as
    float32). Returns logits, or (logits, {name: tensor}) with collect."""
    if not config.relu6:
        raise ValueError("the int8 fixed-point scheme requires ReLU6 bounds")
    acts: Dict[str, torch.Tensor] = {}
    dev = x.device
    s_in, s_h = _f32(ACT_IN_SCALE, dev), _f32(ACT_HIDDEN_SCALE, dev)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], s_in * s_w)
    acc = _stem_taps(q, w_q) + b_q
    q = fq_requant(acc, s_in * s_w / s_h)
    if collect:
        acts["conv1"] = q

    for i, stride in enumerate(config.block_strides):
        blk = params["blocks"][i]
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], s_h * s_w)
        acc = _dw3x3_taps(q, w_q, stride) + b_q
        q = fq_requant(acc, s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_dw"] = q
        w_q, s_w = fq_weight(blk["pw"]["w"], out_axis=1)
        b_q = fq_bias(blk["pw"]["b"], s_h * s_w)
        q = fq_requant(_fq_pw_acc(q, w_q, b_q), s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_pw"] = q

    pooled = _fq_pool_sat(q)
    if collect:
        acts["pool"] = pooled
    logits = _fc_logits(pooled, params["fc"], s_h)
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def qat_forward_v2(params: Dict[str, Any], x: torch.Tensor, config, s_blk, *,
                   collect: bool = False) -> Any:
    """MobileNet-V2 QAT forward (twin of quant/v2.forward_all_v2_i8).

    `s_blk`: the frozen per-block bottleneck scales of quant.v2.calibrate_v2
    (calibrate, then freeze). Residual adds are saturating integer adds on
    one shared group scale, as on the deployed path."""
    if not config.relu6:
        raise ValueError("the int8 fixed-point scheme requires ReLU6 bounds")
    acts: Dict[str, torch.Tensor] = {}
    dev = x.device
    s_in, s_h = _f32(ACT_IN_SCALE, dev), _f32(ACT_HIDDEN_SCALE, dev)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], s_in * s_w)
    acc = _stem_taps(q, w_q) + b_q
    q = fq_requant(acc, s_in * s_w / s_h)
    if collect:
        acts["conv1"] = q

    s_prev = s_h  # scale of the activation entering the next block
    for i, ((_t, cin, cout, stride), blk) in enumerate(zip(config.block_defs, params["blocks"])):
        z = q
        if "exp" in blk:
            w_q, s_w = fq_weight(blk["exp"]["w"], out_axis=1)
            b_q = fq_bias(blk["exp"]["b"], s_prev * s_w)
            z = fq_requant(_fq_pw_acc(z, w_q, b_q), s_prev * s_w / s_h)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], s_h * s_w)
        acc = _dw3x3_taps(z, w_q, stride) + b_q
        z = fq_requant(acc, s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        s_out = _f32(s_blk[i], dev)
        w_q, s_w = fq_weight(blk["prj"]["w"], out_axis=1)
        b_q = fq_bias(blk["prj"]["b"], s_h * s_w)
        out = fq_requant_linear(_fq_pw_acc(z, w_q, b_q), s_h * s_w / s_out)
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            # saturating int8 residual add on the shared group scale
            out = _clip(out + q, -128.0, 127.0)
            if collect:
                acts[f"block{i:02d}_out"] = out
        q = out
        s_prev = s_out

    w_q, s_w = fq_weight(params["conv_last"]["w"], out_axis=1)
    b_q = fq_bias(params["conv_last"]["b"], s_prev * s_w)
    q = fq_requant(_fq_pw_acc(q, w_q, b_q), s_prev * s_w / s_h)
    if collect:
        acts["conv_last"] = q

    pooled = _fq_pool_sat(q)
    if collect:
        acts["pool"] = pooled
    logits = _fc_logits(pooled, params["fc"], s_h)
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def fq_requant_named(acc: torch.Tensor, a: torch.Tensor, inv_s: float,
                     act: str) -> torch.Tensor:
    """Named-activation requant (twin of quant/v3._requant_named_np, the
    folded order): accumulator -> real units via `a` -> activation ->
    quantize at float32(inv_s). The shadow is the clamped pre-round value
    (clipped STE; for relu the clip's lower bound 0 is the relu)."""
    av = a.reshape(-1).float().detach()
    dev = acc.device
    if act == "hswish":
        v = acc * av
        t = _clip(v + _f32(3.0, dev), 0.0, 6.0)
        w = (v * t) * _f32(np.float32(inv_s) * np.float32(1.0 / 6.0), dev)
        return _ste(_clip(w, -128.0, 127.0), torch.round(w).clamp(-128, 127))
    if act not in ("relu", "linear"):
        raise ValueError(f"named requant: unknown activation {act!r}")
    w = acc * (av * _f32(inv_s, dev))
    lo = 0.0 if act == "relu" else -128.0
    return _ste(_clip(w, lo, 127.0), torch.round(w).clamp(lo, 127))


def _fq_se(z: torch.Tensor, se: Dict[str, Any], s_dw: float, s_g1: float) -> torch.Tensor:
    """Quantized squeeze-excite gate (twin of quant/v3._se_i8_np): integer
    matmuls, float32 only elementwise; gradients reach both SE weight pairs
    and z (through the product and the pooled path)."""
    dev = z.device
    pooled = _fq_pool_sat(z)
    w1_q, s_w1 = fq_weight(se["w1"], out_axis=1)
    b1_q = fq_bias(se["b1"], _f32(s_dw, dev) * s_w1)
    acc1 = _dot(pooled, w1_q) + b1_q
    g1 = fq_requant_named(acc1, _f32(s_dw, dev) * s_w1, 1.0 / s_g1, "relu")
    w2_q, s_w2 = fq_weight(se["w2"], out_axis=1)
    b2_q = fq_bias(se["b2"], _f32(s_g1, dev) * s_w2)
    acc2 = _dot(g1, w2_q) + b2_q
    v = acc2 * (_f32(s_g1, dev) * s_w2).reshape(-1).detach()  # real units (s_out = 1)
    gate = _clip(v + _f32(3.0, dev), 0.0, 6.0) * _f32(1.0 / 6.0, dev)
    out = z * gate[:, None, None, :]
    return _ste(out, torch.round(out).clamp(-128, 127))


def qat_forward_v3(params: Dict[str, Any], x: torch.Tensor, config, cal: Dict[str, Any], *,
                   collect: bool = False) -> Any:
    """MobileNet-V3 QAT forward (twin of quant/v3.forward_all_v3_i8).

    `cal`: the frozen calibration of quant.v3.calibrate_v3 (an activation
    scale per named tap). Weight scales stay live, activation scales are
    pinned, so exporting with quantize_v3 at the same calibration seed
    reproduces the deployed constants. Hard-swish and the SE gate take the
    oracle's float32 real-units detour, bit for bit."""
    acts: Dict[str, torch.Tensor] = {}
    dev = x.device
    s_in = float(ACT_IN_SCALE)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], _f32(s_in, dev) * s_w)
    acc = _stem_taps(q, w_q) + b_q
    s_c1 = float(cal["conv1"])
    q = fq_requant_named(acc, _f32(s_in, dev) * s_w, 1.0 / s_c1, config.head_act)
    if collect:
        acts["conv1"] = q

    s_prev = s_c1
    for i, (bd, blk) in enumerate(zip(config.block_defs, params["blocks"])):
        c = cal["blocks"][i]
        z, s = q, s_prev
        if bd.has_expand:
            w_q, s_w = fq_weight(blk["exp"]["w"], out_axis=1)
            b_q = fq_bias(blk["exp"]["b"], _f32(s, dev) * s_w)
            z = fq_requant_named(_fq_pw_acc(z, w_q, b_q), _f32(s, dev) * s_w,
                                 1.0 / float(c["exp"]), bd.act)
            s = float(c["exp"])
            if collect:
                acts[f"block{i:02d}_exp"] = z
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], _f32(s, dev) * s_w)
        acc = _dwk_taps(z, w_q, bd.stride, bd.kernel) + b_q
        s_dw = float(c["dw"])
        z = fq_requant_named(acc, _f32(s, dev) * s_w, 1.0 / s_dw, bd.act)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = _fq_se(z, blk["se"], s_dw, float(c["g1"]))
            if collect:
                acts[f"block{i:02d}_se"] = z
        s_out = float(cal["s_blk"][i])
        w_q, s_w = fq_weight(blk["prj"]["w"], out_axis=1)
        b_q = fq_bias(blk["prj"]["b"], _f32(s_dw, dev) * s_w)
        out = fq_requant_named(_fq_pw_acc(z, w_q, b_q), _f32(s_dw, dev) * s_w,
                               1.0 / s_out, "linear")
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = _clip(out + q, -128.0, 127.0)
            if collect:
                acts[f"block{i:02d}_out"] = out
        q = out
        s_prev = s_out

    w_q, s_w = fq_weight(params["conv_last"]["w"], out_axis=1)
    b_q = fq_bias(params["conv_last"]["b"], _f32(s_prev, dev) * s_w)
    s_cl = float(cal["conv_last"])
    q = fq_requant_named(_fq_pw_acc(q, w_q, b_q), _f32(s_prev, dev) * s_w, 1.0 / s_cl,
                         config.head_act)
    if collect:
        acts["conv_last"] = q

    pooled = _fq_pool_sat(q)
    if collect:
        acts["pool"] = pooled
    w_q, s_w = fq_weight(params["head"]["w"], out_axis=1)
    b_q = fq_bias(params["head"]["b"], _f32(s_cl, dev) * s_w)
    acc = _dot(pooled, w_q) + b_q
    s_head = float(cal["head"])
    h = fq_requant_named(acc, _f32(s_cl, dev) * s_w, 1.0 / s_head, config.head_act)
    if collect:
        acts["head"] = h
    logits = _fc_logits(h, params["fc"], _f32(s_head, dev))
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def make_qat_trainer(config: ModelConfig, params: Dict[str, Any], lr: float = 1e-2,
                     momentum: float = 0.9, weight_decay: float = 4e-5):
    """SGD-momentum QAT trainer over the folded parameterization
    (models.train.make_trainer's optimizer; the loss runs qat_forward, so
    the gradients flow through the STE quantizers). `params`: a float32
    device tree, trained in place; it exports with quantize() unchanged.
    Returns step(images, labels) -> (loss, top1)."""
    return sgd_trainer(lambda p, x: qat_forward(p, x, config), params, lr, momentum,
                       weight_decay)


def make_qat_trainer_v2(config, folded_init: Dict[str, Any], params: Dict[str, Any],
                        lr: float = 1e-2, momentum: float = 0.9,
                        weight_decay: float = 4e-5, n_calib: int = 32,
                        calib_seed: int = 1234):
    """V2 QAT trainer: calibrates the bottleneck group scales once from the
    initial folded tree (calibrate, then freeze), then trains `params`
    against them. Returns (step, s_blk)."""
    from .v2 import calibrate_v2  # noqa: PLC0415

    s_blk = tuple(float(s) for s in
                  calibrate_v2(folded_init, config, n_images=n_calib, seed=calib_seed))
    step = sgd_trainer(lambda p, x: qat_forward_v2(p, x, config, s_blk), params, lr,
                       momentum, weight_decay)
    return step, s_blk


def make_qat_trainer_v3(config, folded_init: Dict[str, Any], params: Dict[str, Any],
                        lr: float = 1e-2, momentum: float = 0.9,
                        weight_decay: float = 4e-5, n_calib: int = 32,
                        calib_seed: int = 1234):
    """V3 QAT trainer: calibrate-then-freeze the named-activation scales from
    the initial folded tree, then train `params` against them. Returns
    (step, cal)."""
    from .v3 import calibrate_v3  # noqa: PLC0415

    cal = calibrate_v3(folded_init, config, n_images=n_calib, seed=calib_seed)
    step = sgd_trainer(lambda p, x: qat_forward_v3(p, x, config, cal), params, lr,
                       momentum, weight_decay)
    return step, cal
