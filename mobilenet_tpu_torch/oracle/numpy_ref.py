"""Pure-NumPy float32 golden reference of MobileNet-V1's, -V2's and -V3's
layers: the port's copy of the JAX package's `oracle/numpy_ref.py`,
verbatim: the oracle of the float verify gates (`runtime/eval.py`) and of
the V2 and V3 int8 calibrations. It adds the host's reference of the
device's preprocessing (`resize_bilinear_ref`, `preprocess_batch_ref`),
the oracle's input in `cli eval`.

The calibration takes absmax over these taps; a reordered float32 sum could
move an absmax in its last bit and with it every requant multiplier of a
scale group, so the port calibrates on the same NumPy code as the JAX
package and not on its own torch ops.

Padding matches TF/XLA 'SAME': pad_total = max((ceil(in/s)-1)*s + k - in, 0),
lo = pad_total // 2, hi = rest. For k=3: s=1 -> (1,1); s=2, even in -> (0,1).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..config import PREPROCESS_OFFSET, PREPROCESS_SCALE


def same_pad(in_size: int, stride: int, k: int = 3):
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: np.ndarray, stride: int, k: int = 3) -> np.ndarray:
    lo_h, hi_h = same_pad(x.shape[1], stride, k)
    lo_w, hi_w = same_pad(x.shape[2], stride, k)
    return np.pad(x, ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))


def _act(y: np.ndarray, relu6: bool) -> np.ndarray:
    y = np.maximum(y, np.float32(0))
    if relu6:
        y = np.minimum(y, np.float32(6))
    return y


def conv2d_ref(x, w, stride, bias=None, relu6=None):
    """Standard 3x3 conv; x (N,H,W,Cin) f32, w (3,3,Cin,Cout) HWIO.

    Accumulation: float32, tap-major (dy, dx, cin).
    """
    x = np.asarray(x, np.float32)
    xp = _pad_nhwc(x, stride)
    n, _, _, cin = x.shape
    h_out = -(-x.shape[1] // stride)
    w_out = -(-x.shape[2] // stride)
    cout = w.shape[3]
    acc = np.zeros((n, h_out, w_out, cout), np.float32)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy : dy + h_out * stride : stride, dx : dx + w_out * stride : stride, :]
            for ci in range(cin):
                acc += patch[..., ci : ci + 1] * w[dy, dx, ci]
    if bias is not None:
        acc += np.asarray(bias, np.float32)
    if relu6 is not None:
        acc = _act(acc, relu6)
    return acc


def depthwise_ref(x, w, stride, bias=None, relu6=None):
    """Depthwise 3x3; w (3,3,1,C). Tap-major float32 accumulation."""
    x = np.asarray(x, np.float32)
    xp = _pad_nhwc(x, stride)
    h_out = -(-x.shape[1] // stride)
    w_out = -(-x.shape[2] // stride)
    acc = np.zeros((x.shape[0], h_out, w_out, x.shape[3]), np.float32)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy : dy + h_out * stride : stride, dx : dx + w_out * stride : stride, :]
            acc += patch * w[dy, dx, 0]
    if bias is not None:
        acc += np.asarray(bias, np.float32)
    if relu6 is not None:
        acc = _act(acc, relu6)
    return acc


def pointwise_ref(x, w, bias=None, relu6=None):
    """Pointwise 1x1; x (N,H,W,Cin), w (Cin,Cout); float32 dot."""
    y = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
    if bias is not None:
        y = y + np.asarray(bias, np.float32)
    if relu6 is not None:
        y = _act(y, relu6)
    return y.astype(np.float32)


def forward_all(params: Dict[str, Any], x: np.ndarray, config):
    """Golden per-layer forward. Returns (logits, {layer_name: activation}),
    matching models.mobilenet_v1.forward(collect=True) layer names exactly."""
    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    y = conv2d_ref(x, params["conv1"]["w"], 2, params["conv1"]["b"], relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(params["blocks"], config.block_strides)):
        y = depthwise_ref(y, blk["dw"]["w"], stride, blk["dw"]["b"], relu6)
        acts[f"block{i:02d}_dw"] = y
        y = pointwise_ref(y, blk["pw"]["w"], blk["pw"]["b"], relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = y.astype(np.float32).mean(axis=(1, 2))
    acts["pool"] = pooled
    logits = pooled @ params["fc"]["w"] + params["fc"]["b"]
    acts["logits"] = logits
    return logits, acts


def preprocess_ref(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 in [-1, 1] (TF mode; keras mobilenet.py:418-422)."""
    return (img_u8.astype(np.float32) / np.float32(127.5)) + np.float32(-1.0)


def resize_bilinear_ref(x: np.ndarray, resolution: int) -> np.ndarray:
    """float NHWC -> float64 (N, resolution, resolution, C): bilinear, half-pixel
    centres, no antialiasing, each source coordinate clamped to the image
    (as `jax.image.resize(..., "bilinear", antialias=False)` and
    `F.interpolate(align_corners=False)`), weights and sums in float64.
    The identity at model size."""
    n, h, w, c = x.shape
    x = x.astype(np.float64)
    if h == resolution and w == resolution:
        return x

    def taps(size):
        src = np.clip((np.arange(resolution) + 0.5) * (size / resolution) - 0.5, 0, size - 1)
        lo = np.floor(src).astype(np.int64)
        return lo, np.minimum(lo + 1, size - 1), src - lo

    y0, y1, fy = taps(h)
    x0, x1, fx = taps(w)
    fy, fx = fy[None, :, None, None], fx[None, None, :, None]
    rows = x[:, y0] * (1 - fy) + x[:, y1] * fy
    return rows[:, :, x0] * (1 - fx) + rows[:, :, x1] * fx


def preprocess_batch_ref(images_u8: np.ndarray, resolution: int) -> np.ndarray:
    """uint8 NHWC of any size -> float32 NHWC at model resolution in [-1, 1]:
    `resize_bilinear_ref`, then the device path's normalization (x * scale +
    offset in float32). The host's reference for the device's preprocessing."""
    x = resize_bilinear_ref(images_u8, resolution).astype(np.float32)
    return x * np.float32(PREPROCESS_SCALE) + np.float32(PREPROCESS_OFFSET)


def forward_all_v2(params: Dict[str, Any], x: np.ndarray, config):
    """Golden per-layer MobileNet-V2 forward (NumPy twin of
    models.mobilenet_v2.forward_v2(collect=True); config is a V2Config).

    Same fixed-order float32 accumulation as the V1 oracle; the projection
    is LINEAR (bias, no activation) and residual adds are plain f32 sums.
    """
    acts: Dict[str, np.ndarray] = {}
    y = conv2d_ref(x, params["conv1"]["w"], 2, params["conv1"]["b"], True)
    acts["conv1"] = y
    for i, ((t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, params["blocks"])):
        z = y
        if "exp" in blk:
            z = pointwise_ref(z, blk["exp"]["w"], blk["exp"]["b"], True)
            acts[f"block{i:02d}_exp"] = z
        z = depthwise_ref(z, blk["dw"]["w"], stride, blk["dw"]["b"], True)
        acts[f"block{i:02d}_dw"] = z
        out = pointwise_ref(z, blk["prj"]["w"], blk["prj"]["b"], None)
        acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            out = out + y
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pointwise_ref(y, params["conv_last"]["w"], params["conv_last"]["b"], True)
    acts["conv_last"] = y
    pooled = y.astype(np.float32).mean(axis=(1, 2))
    acts["pool"] = pooled
    logits = pooled @ params["fc"]["w"] + params["fc"]["b"]
    acts["logits"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# MobileNet-V3 oracle (named activations, k in {3,5} depthwise, SE gates)
# ---------------------------------------------------------------------------


def act_named_ref(y: np.ndarray, act) -> np.ndarray:
    """Named activations, float32, same formula order as the device twin
    (ops.conv.apply_act_named): hsigmoid = clip(y+3, 0, 6) * (1/6);
    hswish = y * hsigmoid(y)."""
    if act is None:
        return y
    y = np.asarray(y, np.float32)
    if act == "relu":
        return np.maximum(y, np.float32(0))
    if act == "relu6":
        return np.clip(y, np.float32(0), np.float32(6))
    if act == "hsigmoid":
        return (np.clip(y + np.float32(3), np.float32(0), np.float32(6))
                * np.float32(1.0 / 6.0))
    if act == "hswish":
        return y * (np.clip(y + np.float32(3), np.float32(0), np.float32(6))
                    * np.float32(1.0 / 6.0))
    raise ValueError(act)


def depthwise_ref_any(x, w, stride, bias=None, act=None):
    """Depthwise kxk (k from w.shape, {3,5}); tap-major f32 accumulation."""
    x = np.asarray(x, np.float32)
    k = int(w.shape[0])
    xp = _pad_nhwc(x, stride, k)
    h_out = -(-x.shape[1] // stride)
    w_out = -(-x.shape[2] // stride)
    acc = np.zeros((x.shape[0], h_out, w_out, x.shape[3]), np.float32)
    for dy in range(k):
        for dx in range(k):
            patch = xp[:, dy : dy + h_out * stride : stride,
                       dx : dx + w_out * stride : stride, :]
            acc += patch * w[dy, dx, 0]
    if bias is not None:
        acc += np.asarray(bias, np.float32)
    return act_named_ref(acc, act)


def pointwise_ref_any(x, w, bias=None, act=None):
    y = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
    if bias is not None:
        y = y + np.asarray(bias, np.float32)
    return act_named_ref(y, act).astype(np.float32)


def se_ref(z: np.ndarray, se: Dict[str, np.ndarray]) -> np.ndarray:
    """Squeeze-excite gate twin of models.mobilenet_v3.se_apply."""
    pooled = np.asarray(z, np.float32).mean(axis=(1, 2))
    g = pooled @ np.asarray(se["w1"], np.float32) + np.asarray(
        se["b1"], np.float32)
    g = np.maximum(g, np.float32(0))
    g = g @ np.asarray(se["w2"], np.float32) + np.asarray(
        se["b2"], np.float32)
    g = act_named_ref(g, "hsigmoid")
    return (z * g[:, None, None, :]).astype(np.float32)


def forward_all_v3(params: Dict[str, Any], x: np.ndarray, config):
    """Golden per-layer MobileNet-V3 forward (NumPy twin of
    models.mobilenet_v3.forward_v3(collect=True); config is a V3Config).
    Layer names match the device taps exactly."""
    acts: Dict[str, np.ndarray] = {}
    head_act = config.head_act
    # stem is 3x3: conv2d_ref's fixed tap order, then the named activation
    y = conv2d_ref(x, params["conv1"]["w"], 2, params["conv1"]["b"], None)
    y = act_named_ref(y, head_act)
    acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, params["blocks"])):
        z = y
        if bd.has_expand:
            z = pointwise_ref_any(z, blk["exp"]["w"], blk["exp"]["b"], bd.act)
            acts[f"block{i:02d}_exp"] = z
        z = depthwise_ref_any(z, blk["dw"]["w"], bd.stride, blk["dw"]["b"],
                              bd.act)
        acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = se_ref(z, blk["se"])
            acts[f"block{i:02d}_se"] = z
        out = pointwise_ref_any(z, blk["prj"]["w"], blk["prj"]["b"], None)
        acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = out + y
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pointwise_ref_any(y, params["conv_last"]["w"],
                          params["conv_last"]["b"], head_act)
    acts["conv_last"] = y
    pooled = y.astype(np.float32).mean(axis=(1, 2))
    acts["pool"] = pooled
    h = pooled @ np.asarray(params["head"]["w"], np.float32) + np.asarray(
        params["head"]["b"], np.float32)
    h = act_named_ref(h, head_act)
    acts["head"] = h
    logits = h @ params["fc"]["w"] + params["fc"]["b"]
    acts["logits"] = logits
    return logits, acts
