"""Plain PyTorch convolution ops, NHWC activations and HWIO weights at every
public function, as in the JAX package's `ops/conv.py`.

These are the port's own reference: the "plain" routing runs them, the
per-layer taps (`forward(collect=True)`) use them, and the kernels' plain
versions share their stencil. Cast points follow the JAX ops:
- float32 runs in true float32 (the 9-tap stencil and the matmuls are
  computed from float32 operands; the stem convolution and every float32
  matmul of the port turn TF32 off around their call (`no_tf32`), whatever
  the global flags say: cuDNN's convolutions default to TF32, and
  `torch.set_float32_matmul_precision("high")` sends float32 matmuls to it);
- the depthwise and stem convolutions produce the compute dtype and add
  their bias in it (XLA's bf16 convolution has a bf16 result);
- the pointwise and fc products accumulate in float32 and add the bias there
  (`preferred_element_type=float32` in JAX).
TF-SAME padding is asymmetric at stride 2: (lo=0, hi=1) for even inputs at
k = 3, (lo=1, hi=2) at k = 5 (the V3 family's late-stage depthwise).
MobileNet-V3's named activations (`apply_act_named`: relu, relu6,
hsigmoid, hswish) take the `act=` argument of the conv ops.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """TF/XLA 'SAME' (lo, hi) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def apply_activation(y: torch.Tensor, relu6: bool) -> torch.Tensor:
    """ReLU or ReLU6 (clip at 6, the TF-slim convention)."""
    return y.clamp(0, 6) if relu6 else y.clamp_min(0)


@functools.lru_cache(maxsize=None)
def _sixth(dtype: torch.dtype) -> float:
    """1/6 rounded to `dtype`, as a Python float (exact in float32)."""
    return float(torch.tensor(1.0 / 6.0, dtype=dtype))


def apply_act_named(y: torch.Tensor, act: str) -> torch.Tensor:
    """The V3 family's named activations in y's dtype (keras
    mobilenet_v3.py:542-553): hsigmoid = clip(y + 3, 0, 6) * (1/6), hswish
    = y * hsigmoid(y), the constant 1/6 rounded to y's dtype and
    multiplied, as the JAX package's `apply_act_named` does."""
    if act == "relu":
        return y.clamp_min(0)
    if act == "relu6":
        return y.clamp(0, 6)
    if act == "hsigmoid":
        return (y + 3.0).clamp(0, 6) * _sixth(y.dtype)
    if act == "hswish":
        return y * ((y + 3.0).clamp(0, 6) * _sixth(y.dtype))
    raise ValueError(f"unknown activation {act!r}")


def bias_act(y: torch.Tensor, bias: Optional[torch.Tensor], relu6: Optional[bool],
             act: Optional[str] = None) -> torch.Tensor:
    """+ bias, then the named activation `act` if given, else ReLU/ReLU6 if
    relu6 is not None; in y's dtype."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act is not None:
        return apply_act_named(y, act)
    if relu6 is not None:
        y = apply_activation(y, relu6)
    return y


def dw_taps_f32(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise k x k TF-SAME stencil in float32 (k = 3 or 5, from w): the
    sum over taps in dy-then-dx order of x * w, from float32 operands.
    x (N,H,W,C), w (k,k,1,C) -> (N,Ho,Wo,C) float32."""
    n, h, wd, c = x.shape
    k = int(w.shape[0])
    if k not in (3, 5) or tuple(w.shape) != (k, k, 1, c):
        raise ValueError(f"depthwise weight {tuple(w.shape)} for C={c}")
    (ph0, ph1), (pw0, pw1) = same_pads(h, stride, k), same_pads(wd, stride, k)
    xp = F.pad(x.float(), (0, 0, pw0, pw1, ph0, ph1))
    ho, wo = -(-h // stride), -(-wd // stride)
    wf = w.float().reshape(k, k, c)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride, :]
            acc = acc + tap * wf[dy, dx]
    return acc


@contextlib.contextmanager
def no_tf32(x: torch.Tensor):
    """IEEE float32 for cuDNN convolutions and cuBLAS matmuls on the card
    while a float32 `x` is being computed on: cuDNN's TF32 default and a
    float32 matmul precision of "high" or "medium" keep ~10 mantissa bits
    (the JAX package pins Precision.HIGHEST on every float32 dot). A bf16
    input needs no guard: its values and their products are exact in TF32.
    Both flags are restored on exit."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    prev_conv = torch.backends.cudnn.allow_tf32
    prev_mm = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev_conv
        torch.set_float32_matmul_precision(prev_mm)


def ieee_f32(fn):
    """`fn(x, ...)` run under `no_tf32(x)`: the float32 matmuls of the port's
    plain ops and of the kernels' plain versions."""
    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        with no_tf32(x):
            return fn(x, *args, **kwargs)
    return wrapped


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int,
                bias: Optional[torch.Tensor] = None,
                relu6: Optional[bool] = None, act: Optional[str] = None) -> torch.Tensor:
    """Standard conv, NHWC x HWIO -> NHWC, TF-SAME padding (the stem 3x3 s2).
    Accumulates in float32, rounds to x's dtype, then adds the bias in it."""
    n, h, wd, _ = x.shape
    k = int(w.shape[0])
    (ph0, ph1), (pw0, pw1) = same_pads(h, stride, k), same_pads(wd, stride, k)
    xc = F.pad(x.float().permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    with no_tf32(x):
        y = F.conv2d(xc, w.float().permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    return bias_act(y, bias, relu6, act).to(x.dtype)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                   bias: Optional[torch.Tensor] = None,
                   relu6: Optional[bool] = None, act: Optional[str] = None) -> torch.Tensor:
    """Depthwise k x k (k = 3 or 5), w (k,k,1,C) HWIO. Float32 stencil,
    rounded to x's dtype, bias and activation in that dtype."""
    y = dw_taps_f32(x, w, stride).to(x.dtype)
    return bias_act(y, bias, relu6, act).to(x.dtype)


@ieee_f32
def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   relu6: Optional[bool] = None, act: Optional[str] = None) -> torch.Tensor:
    """Pointwise 1x1 as (N*H*W, Cin) @ (Cin, Cout), float32 accumulation,
    bias and activation in float32, then x's dtype. w: (Cin, Cout)."""
    n, h, wd, cin = x.shape
    y = x.float().reshape(n * h * wd, cin) @ w.to(x.dtype).float()
    y = bias_act(y, None if bias is None else bias.float(), relu6, act)
    return y.reshape(n, h, wd, -1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool -> (N, C): float32 mean, cast back."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


@ieee_f32
def fc(x: torch.Tensor, w: torch.Tensor,
       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classifier fc, x (N, C) @ w (C, classes): float32 accumulation and
    bias, then x's dtype."""
    y = x.float() @ w.to(x.dtype).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)
