"""Fused int8 depthwise-separable block: the CUDA kernel
`csrc/separable_block_i8.cu` and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/quant/pallas_block_i8.py`
`separable_block_i8` and the lane-packed
`quant/pallas_block_packed_i8.py` `separable_block_packed_i8` (both
strides): every int8 block, narrow or wide, runs this one dense NHWC kernel.
`pw_linear=True` is the packed kernel's mode of the same name: the pointwise
requant is MobileNet-V2's linear one (`quant/v2.py`, block 0), a second
instantiation of the kernel with its own entry point.
Exact: equal, bit for bit, to the plain version and to the NumPy oracles.
What bounds it on the card and what the design does about it is in the CUDA
source's header.
"""

from __future__ import annotations

import torch

from ..quant import ops as qops
from . import _build
from .depthwise_i8 import check_i8_args, check_i8_dw
from .separable_block import check_channels


def separable_block_i8_plain(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride: int,
                             dw_six_q: float, pw_six_q: float, relu6: bool = True,
                             pw_linear: bool = False) -> torch.Tensor:
    """The plain int8 depthwise then the plain int8 pointwise (linear with
    pw_linear: pw_six_q is then unused)."""
    y = qops.depthwise_i8(x, dw_w, dw_b, dw_m, dw_six_q, stride, relu6)
    if pw_linear:
        return qops.pointwise_i8_linear(y, pw_w, pw_b, pw_m)
    return qops.pointwise_i8(y, pw_w, pw_b, pw_m, pw_six_q, relu6)


def separable_block_i8(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride: int,
                       dw_six_q: float, pw_six_q: float, relu6: bool = True,
                       pw_linear: bool = False) -> torch.Tensor:
    """int8 dw 3x3 (TF-SAME, stride 1 or 2) + bias + requant -> pw 1x1
    s8 x s8 -> s32 + bias + requant (pw_linear: the linear requant
    clamp(rint(float32(acc) * m)), no ReLU).

    x (N,H,W,Cin) int8, dw_w (3,3,1,Cin) int8, dw_b (Cin,) int32, dw_m
    (Cin,) float32, pw_w (Cin,Cout) int8, pw_b (Cout,) int32, pw_m (Cout,)
    float32 -> (N,Ho,Wo,Cout) int8. On CPU tensors this is the plain version;
    on CUDA tensors it launches the kernel or raises."""
    name = "separable_block_i8"
    check_i8_args(name, x, (dw_w, pw_w), (dw_b, pw_b), (dw_m, pw_m))
    check_i8_dw(name, x, dw_w, dw_b, dw_m, stride)
    n, h, w, cin = x.shape
    cout = int(pw_w.shape[-1])
    if (tuple(pw_w.shape) != (cin, cout) or tuple(pw_b.shape) != (cout,)
            or tuple(pw_m.shape) != (cout,)):
        raise ValueError(f"{name}: pointwise shapes {tuple(pw_w.shape)} "
                         f"{tuple(pw_b.shape)} {tuple(pw_m.shape)} do not fit Cin={cin}")
    check_channels(name, cin, cout)
    if x.device.type == "cpu":
        return separable_block_i8_plain(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride,
                                        dw_six_q, pw_six_q, relu6, pw_linear)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout), dtype=torch.int8,
                      device=x.device)
    fn = lib.separable_block_i8_linear if pw_linear else lib.separable_block_i8
    code = fn(
        x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), dw_m.data_ptr(), pw_w.data_ptr(),
        pw_b.data_ptr(), pw_m.data_ptr(), out.data_ptr(), n, h, w, cin, cout, stride,
        int(relu6), float(dw_six_q), float(pw_six_q),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    separable_block_i8.launches += 1
    return out


separable_block_i8.launches = 0
