"""Plain PyTorch INT8 ops with per-layer requantization: the port's copy of
the JAX package's `quant/ops.py`, exact on the CPU and on the card.

Semantics (shared bit for bit with `quant/oracle.py`):
  acc: exact integer accumulation;
  requant: v = float32(acc) * m[oc]; v = max(v, 0); v = min(v, six_q) when
           relu6; round half to even; clamp to [-128, 127]; int8;
  linear requant (V2 projections): the same without max/min;
  residual (V2, V3): int32 sum of two int8 tensors, clamp to [-128, 127];
  named requant (V3, `requantize_named`): quant/v3.py's folded order,
  relu/linear clamp(rint(float32(acc) * m), 0 or -128, 127), hswish
  v = float32(acc) * a, clamp(rint((v * clip(v + 3, 0, 6)) * m6));
  quantized squeeze-excite (V3, `se_i8`).

Where exactness is at stake on the card:
- Integer products: `torch.matmul` has no int8/int32 CUDA kernel, so the
  pointwise, fc and stem products run in float64. Every product and partial
  sum is an integer below 2^53 (|acc| <= 1024*127*127), so the result is
  exact in any summation order and whatever float32 matmul precision is set.
- The stem is an im2col product in float64, not `F.conv2d`: a bf16 conv
  returns bf16 (it rounds sums up to 27*127*127), and an f32 cuDNN conv may
  pick Winograd/FFT algorithms, which are not exact.
- Rounding is `torch.round` (half to even, as np.rint).
- f32 epilogues keep numpy's op order: a multiply, then a separate add (no
  fused multiply-add), and a division by a device tensor where the JAX op
  divides (PyTorch's CUDA division by a Python scalar multiplies by its
  reciprocal). Scalars are float32 values, so their conversion is exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import same_pads


def _f32(value) -> float:
    """`value` rounded to float32, as a Python float: every float32 op that
    takes it as a scalar uses exactly this value."""
    return float(np.float32(value))


def requantize(acc_i32: torch.Tensor, m: torch.Tensor, six_q: float,
               relu6: bool = True) -> torch.Tensor:
    """int32 accumulator -> int8 output in the next layer's scale."""
    v = acc_i32.float() * m.float()
    v = v.clamp(0.0, _f32(six_q)) if relu6 else v.clamp_min(0.0)
    return torch.round(v).clamp(-128, 127).to(torch.int8)


def _taps(x: torch.Tensor, stride: int, k: int = 3):
    """The k*k TF-SAME input patches of NHWC x, in dy-dx order."""
    n, h, w, _ = x.shape
    (ph0, ph1), (pw0, pw1) = same_pads(h, stride, k), same_pads(w, stride, k)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    ho, wo = -(-h // stride), -(-w // stride)
    for dy in range(k):
        for dx in range(k):
            yield dy, dx, xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                             dx:dx + stride * (wo - 1) + 1:stride, :]


def requantize_linear(acc_i32: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The signed linear requant of MobileNet-V2's projections: v =
    float32(acc) * m; round half to even; clamp to [-128, 127]; no ReLU."""
    return torch.round(acc_i32.float() * m.float()).clamp(-128, 127).to(torch.int8)


def residual_add_i8(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """Saturating int8 add of two tensors at one scale: int32 sum, clamp."""
    return (a_i8.to(torch.int32) + b_i8.to(torch.int32)).clamp(-128, 127).to(torch.int8)


def depthwise_acc_i8(x_i8: torch.Tensor, w_i8: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise k x k (TF-SAME; k = 3 or 5, from w): the k*k shifted-slice
    int32 products in dy-dx order. x (N,H,W,C) int8, w (k,k,1,C) int8 ->
    int32 (N,Ho,Wo,C), no bias."""
    k, c = int(w_i8.shape[0]), x_i8.shape[-1]
    wi = w_i8.to(torch.int32).reshape(k, k, c)
    acc = None
    for dy, dx, patch in _taps(x_i8.to(torch.int32), stride, k):
        term = patch * wi[dy, dx]
        acc = term if acc is None else acc + term
    return acc


def depthwise_i8(x_i8: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
                 m: torch.Tensor, six_q: float, stride: int,
                 relu6: bool = True) -> torch.Tensor:
    """Depthwise 3x3 (TF-SAME): 9 shifted-slice int32 products in dy-dx
    order, + int32 bias, requant. x (N,H,W,C) int8, w (3,3,1,C) int8."""
    return requantize(depthwise_acc_i8(x_i8, w_i8, stride) + bias_i32, m, six_q, relu6)


def _int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product (M,K) x (K,N) -> int32, through float64."""
    return (x.double() @ w.double()).to(torch.int32)


def pointwise_i8(x_i8: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
                 m: torch.Tensor, six_q: float, relu6: bool = True) -> torch.Tensor:
    """Pointwise 1x1: (N*H*W, Cin) int8 x (Cin, Cout) int8 -> int32, + bias,
    requant."""
    n, h, w, cin = x_i8.shape
    acc = _int_matmul(x_i8.reshape(n * h * w, cin), w_i8) + bias_i32
    return requantize(acc, m, six_q, relu6).reshape(n, h, w, -1)


def pointwise_i8_linear(x_i8: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
    """Pointwise 1x1 with the linear requant (a V2 projection)."""
    n, h, w, cin = x_i8.shape
    acc = _int_matmul(x_i8.reshape(n * h * w, cin), w_i8) + bias_i32
    return requantize_linear(acc, m).reshape(n, h, w, -1)


def conv1_acc_i8(x_q: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """The stem 3x3 s2 conv's exact integer sums: an im2col product in
    float64 -> int32 (N,Ho,Wo,Cout), no bias. x_q (N,H,W,C) holds the
    quantized input as int8 or float values. The TF-SAME windows are a
    strided view (N,Ho,Wo,C,3,3), gathered once in the input's dtype, then
    widened to float64, against the HWIO weight in (C, dy, dx) order."""
    n, h, w, c = x_q.shape
    (ph0, ph1), (pw0, pw1) = same_pads(h, 2), same_pads(w, 2)
    windows = F.pad(x_q, (0, 0, pw0, pw1, ph0, ph1)).unfold(1, 3, 2).unfold(2, 3, 2)
    ho, wo, k = windows.shape[1], windows.shape[2], 9 * c
    cols = windows.reshape(-1, k).double()
    acc = (cols @ w_i8.permute(2, 0, 1, 3).reshape(k, -1).double()).to(torch.int32)
    return acc.reshape(n, ho, wo, -1)


def conv1_i8(x_q: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
             m: torch.Tensor, six_q: float, relu6: bool = True) -> torch.Tensor:
    """The stem 3x3 s2 conv (V1, V2): `conv1_acc_i8` + int32 bias, ReLU6
    requant."""
    return requantize(conv1_acc_i8(x_q, w_i8) + bias_i32, m, six_q, relu6)


def avgpool_i8(x_i8: torch.Tensor) -> torch.Tensor:
    """Global average pool in the quantized domain: int32 sum, times the
    float32 reciprocal of H*W, round half to even, clamp -> (N, C) int8."""
    n, h, w, c = x_i8.shape
    acc = x_i8.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32).float()
    v = acc * _f32(1.0 / (h * w))
    return torch.round(v).clamp(-128, 127).to(torch.int8)


def fc_i8_logits(x_i8: torch.Tensor, w_i8: torch.Tensor, s_in,
                 s_w: torch.Tensor, b_f32: torch.Tensor) -> torch.Tensor:
    """Classifier: int8 product -> int32 -> float32, times
    float32(s_in) * s_w, then + bias (logits stay float)."""
    acc = _int_matmul(x_i8, w_i8).float()
    scale = s_w.float() * _f32(s_in)
    return acc * scale + b_f32.float()


def quantize_input_dev(x_f: torch.Tensor, s_in) -> torch.Tensor:
    """Preprocessed [-1,1] activations -> int8 at s_in: x / float32(s_in),
    round half to even, clamp to [-127, 127] (device twin of
    quantize.quantize_input)."""
    s = torch.full((), _f32(s_in), dtype=torch.float32, device=x_f.device)
    v = x_f.float() / s
    return torch.round(v).clamp(-127, 127).to(torch.int8)


def requantize_named(acc_i32: torch.Tensor, layer, act: str) -> torch.Tensor:
    """quant/v3.py's named requant in the folded order (FOLDED_REQUANT):
    relu / linear: clamp(rint(float32(acc) * m), 0 or -128, 127) with m =
    float32(a) * float32(inv_s); hswish: v = float32(acc) * a, clamp(rint((v
    * clip(v + 3, 0, 6)) * m6), -128, 127) with m6 = float32(inv_s) *
    float32(1/6). `layer` holds "a" and "m" (float32 tensors) and "m6" (a
    float32 value), computed on the host (quant/v3.device_layer_v3). relu6:
    MobileNet-V2's ReLU6 requant (`requantize`) on a V2 layer's "m" and
    "six_q" (quant/model.device_layer)."""
    if act == "relu6":
        return requantize(acc_i32, layer["m"], layer["six_q"], True)
    if act == "hswish":
        v = acc_i32.float() * layer["a"]
        t = (v + 3.0).clamp(0.0, 6.0)
        return torch.round((v * t) * layer["m6"]).clamp(-128, 127).to(torch.int8)
    if act not in ("relu", "linear"):
        raise ValueError(f"named requant: unknown activation {act!r}")
    q = torch.round(acc_i32.float() * layer["m"])
    return q.clamp(0 if act == "relu" else -128, 127).to(torch.int8)


def pointwise_i8_named(x_i8: torch.Tensor, layer, act: str) -> torch.Tensor:
    """Pointwise 1x1 of NHWC (or (N, C)) int8 -> int32 + bias, named
    requant."""
    cin = x_i8.shape[-1]
    acc = _int_matmul(x_i8.reshape(-1, cin), layer["w"]) + layer["b"]
    return requantize_named(acc, layer, act).reshape(*x_i8.shape[:-1], -1)


def se_i8(z_i8: torch.Tensor, se1, se2) -> torch.Tensor:
    """quant/v3.py's quantized squeeze-excite: the int32 sum of z over H, W
    times float32(1/(H*W)), rint, clamp (pooled int8); g1 = relu requant of
    pooled @ w1 + b1; acc2 = g1 @ w2 + b2; gate = clip(float32(acc2) * a2 +
    3, 0, 6) * float32(1/6); out = clamp(rint(float32(z) * gate))."""
    n, h, w, c = z_i8.shape
    s = z_i8.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
    pooled = torch.round(s.float() * _f32(1.0 / (h * w))).clamp(-128, 127).to(torch.int8)
    g1 = pointwise_i8_named(pooled, se1, "relu")
    v = (_int_matmul(g1, se2["w"]) + se2["b"]).float() * se2["a"]
    gate = (v + 3.0).clamp(0.0, 6.0) * _f32(1.0 / 6.0)
    return torch.round(z_i8.float() * gate[:, None, None, :]).clamp(-128, 127).to(torch.int8)
