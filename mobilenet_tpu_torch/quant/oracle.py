"""NumPy INT8 golden twin (exact), the port's copy of the JAX package's
`quant/oracle.py`: the same requant semantics as `quant/ops.py`. Every op
is exact integer/float32 arithmetic with round-half-to-even (np.rint), so a
device route and this oracle compare by exact equality.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import ModelConfig
from ..ops.conv import same_pads
from .quantize import ACT_HIDDEN_SCALE, QuantizedParams


def _requant(acc_i32: np.ndarray, m: np.ndarray, six_q: np.float32,
             relu6: bool = True) -> np.ndarray:
    v = acc_i32.astype(np.float32) * m.astype(np.float32)
    v = np.maximum(v, np.float32(0))
    if relu6:
        v = np.minimum(v, np.float32(six_q))
    return np.clip(np.rint(v), -128, 127).astype(np.int8)


def _pad(x, stride):
    lo_h, hi_h = same_pads(x.shape[1], stride)
    lo_w, hi_w = same_pads(x.shape[2], stride)
    return np.pad(x, ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))


def _taps(x, stride):
    """The 9 TF-SAME input patches in dy-dx order, int32."""
    xp = _pad(x.astype(np.int32), stride)
    h_out, w_out = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + h_out * stride:stride,
                             dx:dx + w_out * stride:stride, :]


def conv3x3_i8(x, w, bias_i32, m, six_q, stride, relu6=True):
    acc = 0
    wi = w.astype(np.int64)
    for dy, dx, patch in _taps(x, stride):
        acc = acc + np.einsum("nhwc,co->nhwo", patch, wi[dy, dx], dtype=np.int64)
    return _requant(acc.astype(np.int32) + bias_i32, m, six_q, relu6)


def dw3x3_i8(x, w, bias_i32, m, six_q, stride, relu6=True):
    acc = 0
    wi = w.astype(np.int32)
    for dy, dx, patch in _taps(x, stride):
        acc = acc + patch * wi[dy, dx, 0]
    return _requant(acc + bias_i32, m, six_q, relu6)


def pw_i8(x, w, bias_i32, m, six_q, relu6=True):
    acc = x.astype(np.int64) @ w.astype(np.int64)
    return _requant(acc.astype(np.int32) + bias_i32, m, six_q, relu6)


def avgpool_i8(x):
    acc = x.astype(np.int32).sum(axis=(1, 2))
    v = acc.astype(np.float32) * np.float32(1.0 / (x.shape[1] * x.shape[2]))
    return np.clip(np.rint(v), -128, 127).astype(np.int8)


def fc_i8_logits(x, w, s_in, s_w, b_f32):
    acc = x.astype(np.int64) @ w.astype(np.int64)
    scale = np.float32(s_in) * s_w.astype(np.float32)
    return acc.astype(np.int32).astype(np.float32) * scale[None, :] + b_f32[None, :]


def forward_all(q: QuantizedParams, x_i8: np.ndarray, config: ModelConfig):
    """Full int8 golden forward -> (logits, {tap: array}); tap names match
    the device route's collect mode."""
    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = conv3x3_i8(x_i8, c1.w_i8, c1.bias_i32, c1.m, c1.six_q, 2, relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(q.blocks, config.block_strides)):
        d, p = blk["dw"], blk["pw"]
        y = dw3x3_i8(y, d.w_i8, d.bias_i32, d.m, d.six_q, stride, relu6)
        acts[f"block{i:02d}_dw"] = y
        y = pw_i8(y, p.w_i8, p.bias_i32, p.m, p.six_q, relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = avgpool_i8(y)
    acts["pool"] = pooled
    logits = fc_i8_logits(pooled, q.fc_w_i8, ACT_HIDDEN_SCALE, q.fc_s_w, q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts
