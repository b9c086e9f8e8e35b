"""INT8 fixed-point quantization pass (host side, numpy only).

The port's copy of the JAX package's `quant/quantize.py`, with the same
constants and the same float32 arithmetic, so one folded tree quantizes to
the same integers and multipliers in both packages:
  - symmetric int8 everywhere, zero-point 0;
  - activations: ReLU6 bounds every hidden activation to [0, 6], so hidden
    scales are fixed at s = 6/127; the preprocessed input in [-1, 1] has
    s_in = 1/127;
  - weights: per-output-channel symmetric, s_w[oc] = max|w[..,oc]| / 127;
  - bias: int32 in accumulator units, b_i32 = rint(b_f32 / (s_in * s_w[oc]));
  - requantization: out_i8 = clamp(rint(acc_i32 * m[oc])), m[oc] =
    s_in * s_w[oc] / s_out, ReLU6 in the quantized domain as a clip at
    six_q = 6 / s_out (float32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..config import ModelConfig

ACT_IN_SCALE = np.float32(1.0 / 127.0)  # preprocessed input in [-1, 1]
ACT_HIDDEN_SCALE = np.float32(6.0 / 127.0)  # every ReLU6 output

# The int32 bound on a quantized depthwise bias: the fused TPU kernels add it
# into an f32 tap accumulator, exact only while every partial sum stays below
# 2^24 (tap sums <= 9*127*127). The port's kernels add it in int32, but keep
# the bound so that a checkpoint valid for one package is valid for both.
DW_BIAS_BOUND = 2**24 - 2 * 9 * 127 * 127


@dataclasses.dataclass
class QuantLayer:
    """One quantized conv layer: int8 weights + requant constants."""

    w_i8: np.ndarray  # same layout as the fp32 weight
    bias_i32: np.ndarray  # (Cout,) accumulator-unit bias
    m: np.ndarray  # (Cout,) float32 requant multiplier
    s_in: np.float32
    s_out: np.float32
    six_q: np.float32  # 6/s_out, the in-domain ReLU6 clip


def _quant_weight(w: np.ndarray, out_axis: int):
    red = tuple(i for i in range(w.ndim) if i != out_axis)
    absmax = np.maximum(np.abs(w).max(axis=red), 1e-12).astype(np.float32)
    s_w = (absmax / np.float32(127.0)).astype(np.float32)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    w_i8 = np.clip(np.rint(w / s_w.reshape(shape)), -127, 127).astype(np.int8)
    return w_i8, s_w


def _quant_layer(w, b, out_axis, s_in, s_out, dw_bias_bound=False) -> QuantLayer:
    w_i8, s_w = _quant_weight(np.asarray(w, np.float32), out_axis)
    acc_scale = (np.float32(s_in) * s_w).astype(np.float32)
    bias_i32 = np.clip(
        np.rint(np.asarray(b, np.float32) / acc_scale), -(2**31) + 1, 2**31 - 1
    ).astype(np.int32)
    if dw_bias_bound and np.abs(bias_i32).max(initial=0) > DW_BIAS_BOUND:
        raise ValueError(
            "quantized dw bias exceeds the exact-f32-integer accumulation "
            f"bound (|bias_i32|_max = {np.abs(bias_i32).max()}); this "
            "checkpoint's weight scale is degenerate for the int8 fixed-point path"
        )
    m = (acc_scale / np.float32(s_out)).astype(np.float32)
    six_q = np.float32(6.0) / np.float32(s_out)
    return QuantLayer(
        w_i8=w_i8, bias_i32=bias_i32, m=m,
        s_in=np.float32(s_in), s_out=np.float32(s_out), six_q=six_q,
    )


@dataclasses.dataclass
class QuantizedParams:
    """Full quantized model (weights + scales), host-side numpy."""

    conv1: QuantLayer
    blocks: List[Dict[str, QuantLayer]]
    fc_w_i8: np.ndarray  # (C, classes)
    fc_s_w: np.ndarray  # (classes,) per-column weight scale
    fc_b_f32: np.ndarray  # (classes,) float bias (logits stay float)
    config: Any = None


def quantize(folded_params: Dict[str, Any], config: ModelConfig) -> QuantizedParams:
    """Folded-BN fp32 tree -> int8 model with per-layer requant constants."""
    conv1 = _quant_layer(
        folded_params["conv1"]["w"], folded_params["conv1"]["b"],
        out_axis=3, s_in=ACT_IN_SCALE, s_out=ACT_HIDDEN_SCALE,
    )
    blocks = []
    for blk in folded_params["blocks"]:
        blocks.append({
            "dw": _quant_layer(blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                               s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE,
                               dw_bias_bound=True),
            "pw": _quant_layer(blk["pw"]["w"], blk["pw"]["b"], out_axis=1,
                               s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE),
        })
    fc_w_i8, fc_s_w = _quant_weight(
        np.asarray(folded_params["fc"]["w"], np.float32), out_axis=1)
    return QuantizedParams(
        conv1=conv1, blocks=blocks, fc_w_i8=fc_w_i8, fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded_params["fc"]["b"], np.float32), config=config,
    )


def quantize_input(x_f32: np.ndarray) -> np.ndarray:
    """Preprocessed [-1,1] float input -> int8 at s_in (host twin of
    quant.ops.quantize_input_dev)."""
    return np.clip(np.rint(np.asarray(x_f32, np.float32) / ACT_IN_SCALE),
                   -127, 127).astype(np.int8)
