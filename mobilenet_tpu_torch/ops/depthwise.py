"""Standalone float depthwise 3x3 + bias + ReLU(6): the CUDA kernel
`csrc/depthwise.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_dw.py`
`depthwise_conv_pallas`: MobileNet-V1's "dw" route (the JAX package's
"pallas": this kernel, then the plain pointwise) and the depthwise taps of
the per-layer collect under "fused" routing (`models/mobilenet_v1.py`).
What bounds it on the card and what the design does about it is in the
CUDA source's header.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .conv import apply_activation, dw_taps_f32
from .separable_block import check_aligned, check_channels, check_kernel_args


def depthwise_plain(x: torch.Tensor, w: torch.Tensor, stride: int,
                    bias: Optional[torch.Tensor] = None, relu6: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain ops, as the TPU kernel computes it:
    the float32 TF-SAME stencil (taps in dy-dx order), + bias in float32
    after the sum, ReLU or ReLU6, rounded to x's dtype once. (The plain
    route's `ops/conv.depthwise_conv` rounds before the bias, as XLA's bf16
    convolution does: the same in float32, not in bf16.)"""
    y = dw_taps_f32(x, w, stride)
    if bias is not None:
        y = y + bias.float()
    return apply_activation(y, relu6).to(x.dtype)


def depthwise(x: torch.Tensor, w: torch.Tensor, stride: int,
              bias: Optional[torch.Tensor] = None, relu6: bool = True) -> torch.Tensor:
    """Depthwise 3x3 conv + bias + ReLU(6), TF-SAME padding, NHWC: the
    signature of `depthwise_conv_pallas`.

    x (N,H,W,C) float32 or bf16, w (3,3,1,C) and bias (C,) or None in x's
    dtype, C a multiple of 8, stride 1 or 2 -> (N,Ho,Wo,C) in x's dtype. On
    CPU tensors this is the plain version; on CUDA tensors it launches the
    kernel or raises."""
    name = "depthwise"
    tensors = (x, w) if bias is None else (x, w, bias)
    suffix = check_kernel_args(name, *tensors)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, 1, c) or (bias is not None and tuple(bias.shape) != (c,)):
        raise ValueError(f"{name}: weight {tuple(w.shape)} or bias "
                         f"{None if bias is None else tuple(bias.shape)} does not fit C={c}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    check_channels(name, c)
    if x.device.type == "cpu":
        return depthwise_plain(x, w, stride, bias, relu6)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    check_aligned(name, *tensors)
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-wd // stride), c), dtype=x.dtype,
                      device=x.device)
    code = getattr(lib, f"depthwise_{suffix}")(
        x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, wd, c, stride, int(relu6), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    depthwise.launches += 1
    return out


depthwise.launches = 0
