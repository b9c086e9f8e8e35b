"""Plain PyTorch convolution ops, NHWC activations and HWIO weights at every
public function, as in the JAX package's `ops/conv.py`.

These are the port's own reference: the "plain" routing runs them, the
per-layer taps (`forward(collect=True)`) use them, and the kernels' plain
versions share their stencil. Cast points follow the JAX ops:
- float32 runs in true float32 (the 9-tap stencil and the matmuls are
  computed from float32 operands; a caller on the card sets
  `torch.backends.cudnn.allow_tf32 = False` for the stem convolution);
- the depthwise and stem convolutions produce the compute dtype and add
  their bias in it (XLA's bf16 convolution has a bf16 result);
- the pointwise and fc products accumulate in float32 and add the bias there
  (`preferred_element_type=float32` in JAX).
TF-SAME padding is asymmetric at stride 2: (lo=0, hi=1) for even inputs.
"""

from __future__ import annotations

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


def bias_act(y: torch.Tensor, bias: Optional[torch.Tensor],
             relu6: Optional[bool]) -> torch.Tensor:
    if bias is not None:
        y = y + bias.to(y.dtype)
    if relu6 is not None:
        y = apply_activation(y, relu6)
    return y


def dw_taps_f32(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise 3x3 TF-SAME stencil in float32: the sum over taps in
    dy-then-dx order of x * w, from float32 operands. x (N,H,W,C),
    w (3,3,1,C) -> (N,Ho,Wo,C) float32."""
    n, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, 1, c):
        raise ValueError(f"depthwise weight {tuple(w.shape)} for C={c}")
    (ph0, ph1), (pw0, pw1) = same_pads(h, stride), same_pads(wd, stride)
    xp = F.pad(x.float(), (0, 0, pw0, pw1, ph0, ph1))
    ho, wo = -(-h // stride), -(-wd // stride)
    wf = w.float().reshape(3, 3, c)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride, :]
            acc = acc + tap * wf[dy, dx]
    return acc


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int,
                bias: Optional[torch.Tensor] = None,
                relu6: Optional[bool] = None) -> torch.Tensor:
    """Standard conv, NHWC x HWIO -> NHWC, TF-SAME padding (the stem 3x3 s2).
    Accumulates in float32, rounds to x's dtype, then adds the bias in it."""
    n, h, wd, _ = x.shape
    k = int(w.shape[0])
    (ph0, ph1), (pw0, pw1) = same_pads(h, stride, k), same_pads(wd, stride, k)
    xc = F.pad(x.float().permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xc, w.float().permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    return bias_act(y, bias, relu6).to(x.dtype)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                   bias: Optional[torch.Tensor] = None,
                   relu6: Optional[bool] = None) -> torch.Tensor:
    """Depthwise 3x3, w (3,3,1,C) HWIO. Float32 stencil, rounded to x's
    dtype, bias and activation in that dtype."""
    y = dw_taps_f32(x, w, stride).to(x.dtype)
    return bias_act(y, bias, relu6).to(x.dtype)


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   relu6: Optional[bool] = None) -> torch.Tensor:
    """Pointwise 1x1 as (N*H*W, Cin) @ (Cin, Cout), float32 accumulation,
    bias and activation in float32, then x's dtype. w: (Cin, Cout)."""
    n, h, wd, cin = x.shape
    y = x.float().reshape(n * h * wd, cin) @ w.to(x.dtype).float()
    y = bias_act(y, None if bias is None else bias.float(), relu6)
    return y.reshape(n, h, wd, -1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool -> (N, C): float32 mean, cast back."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


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
