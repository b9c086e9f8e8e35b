"""Standalone int8 depthwise 3x3 + requant: the CUDA kernel
`csrc/depthwise_i8.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/quant/pallas_dw_i8.py`
`depthwise_i8_pallas`, the per-layer int8 route (`forward_i8(...,
use_dw_kernel=True)`, the int8 verify gate). Its arithmetic is the
depthwise stage that the fused int8 block kernel runs too
(`csrc/int8_tile.cuh`), on the float kernel's design and plan
(`csrc/depthwise_ring.cuh`, `ops/depthwise.dw_plan` at one byte an element).
What bounds it on the card and what the design does about it is in the CUDA
source's header.
"""

from __future__ import annotations

import torch

from ..quant import ops as qops
from . import _build
from .depthwise import dw_plan
from .separable_block import _sms, check_channels

# The kernels load 4-channel weight words, bias and multiplier groups as
# 16-byte vectors, and a window by TMA or 8-byte copies.
ALIGN_BYTES = 16


def check_i8_args(name: str, x, int8s, int32s, float32s) -> None:
    """Wrapper checks of the int8 kernels: one device, int8 activations and
    weights, int32 biases, float32 multipliers, contiguous, 16-byte aligned."""
    groups = ((torch.int8, (x, *int8s)), (torch.int32, int32s), (torch.float32, float32s))
    for dtype, tensors in groups:
        for t in tensors:
            if t.device != x.device:
                raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
            if t.dtype != dtype:
                raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
            if t.data_ptr() % ALIGN_BYTES:
                raise ValueError(f"{name}: tensors must start on a "
                                 f"{ALIGN_BYTES}-byte boundary")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")


def check_i8_dw(name: str, x, w, b, m, stride: int) -> None:
    c = int(x.shape[-1]) if x.dim() == 4 else -1
    if tuple(w.shape) != (3, 3, 1, c) or tuple(b.shape) != (c,) or tuple(m.shape) != (c,):
        raise ValueError(f"{name}: depthwise shapes {tuple(w.shape)} {tuple(b.shape)} "
                         f"{tuple(m.shape)} do not fit C={c}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")


depthwise_i8_plain = qops.depthwise_i8


def depthwise_i8(x, w, b, m, six_q: float, stride: int,
                 relu6: bool = True) -> torch.Tensor:
    """int8 depthwise 3x3 (TF-SAME, stride 1 or 2) + int32 bias + requant.

    x (N,H,W,C) int8, w (3,3,1,C) int8, b (C,) int32, m (C,) float32 ->
    (N,Ho,Wo,C) int8. On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel on the plan of `dw_plan` or raises."""
    name = "depthwise_i8"
    check_i8_args(name, x, (w,), (b,), (m,))
    check_i8_dw(name, x, w, b, m, stride)
    n, h, wd, c = x.shape
    check_channels(name, c)
    if x.device.type == "cpu":
        return depthwise_i8_plain(x, w, b, m, six_q, stride, relu6)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-wd // stride), c), dtype=torch.int8,
                      device=x.device)
    plan = dw_plan(n, h, wd, c, 1, stride, _sms(x.device.index or 0))
    code = lib.depthwise_i8(x.data_ptr(), w.data_ptr(), b.data_ptr(), m.data_ptr(),
                            out.data_ptr(), n, h, wd, c, stride, int(relu6), float(six_q),
                            *plan, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    depthwise_i8.launches += 1
    return out


depthwise_i8.launches = 0
