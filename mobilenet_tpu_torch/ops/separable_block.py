"""Fused depthwise-separable block: the CUDA kernel `csrc/separable_block.cu`
and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_block.py`
`separable_block_pallas` and the lane-packed `ops/pallas_block_packed.py`
`separable_block_packed` / `separable_block_packed_s2`; every block, narrow
or wide, runs this one dense NHWC kernel. `pw_act=False` is the packed
kernels' `pw_epilogue=False` mode (a linear projection: MobileNet-V2's
block 0). What bounds it on the card and what
the design does about it is in the CUDA source's header.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import apply_activation, dw_taps_f32, ieee_f32

KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def check_kernel_args(name: str, *tensors: torch.Tensor) -> str:
    """Common wrapper checks: one device, one supported dtype, contiguous.
    Returns the kernel's dtype suffix."""
    x = tensors[0]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: dtypes {t.dtype} and {x.dtype} differ")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in {list(KERNEL_DTYPES)}")
    return KERNEL_DTYPES[x.dtype]


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Kernels that move rows as 16-byte vectors need 16-byte-aligned data
    (a fresh allocation always is; a view into one may not be)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")


def check_channels(name: str, *channels: int) -> None:
    for c in channels:
        if c <= 0 or c % 8:
            raise ValueError(f"{name}: channel count {c} is not a positive "
                             "multiple of 8")


@ieee_f32
def separable_block_plain(x, dw_w, dw_b, pw_w, pw_b, stride: int,
                          relu6: bool = True, pw_act: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 taps, + dw bias in f32,
    activation, cast to the weight dtype, f32 product, + pw bias in f32,
    activation (none if not pw_act), cast to x's dtype."""
    y = apply_activation(dw_taps_f32(x, dw_w, stride) + dw_b.float(), relu6)
    n, ho, wo, cin = y.shape
    y = y.to(pw_w.dtype).float().reshape(n * ho * wo, cin) @ pw_w.float() + pw_b.float()
    if pw_act:
        y = apply_activation(y, relu6)
    return y.reshape(n, ho, wo, -1).to(x.dtype)


def separable_block(x, dw_w, dw_b, pw_w, pw_b, stride: int,
                    relu6: bool = True, pw_act: bool = True) -> torch.Tensor:
    """dw 3x3 (TF-SAME, stride 1 or 2) + bias + act -> pw 1x1 + bias + act
    (pw_act=False: pw 1x1 + bias, linear).

    x (N,H,W,Cin), dw_w (3,3,1,Cin), dw_b (Cin,), pw_w (Cin,Cout),
    pw_b (Cout,) -> (N,Ho,Wo,Cout). On CPU tensors this is the plain
    version; on CUDA tensors it launches the kernel or raises."""
    name = "separable_block"
    sfx = check_kernel_args(name, x, dw_w, dw_b, pw_w, pw_b)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    cout = int(pw_w.shape[-1])
    if (tuple(dw_w.shape) != (3, 3, 1, cin) or tuple(dw_b.shape) != (cin,)
            or tuple(pw_w.shape) != (cin, cout) or tuple(pw_b.shape) != (cout,)):
        raise ValueError(f"{name}: weight shapes {tuple(dw_w.shape)} "
                         f"{tuple(dw_b.shape)} {tuple(pw_w.shape)} "
                         f"{tuple(pw_b.shape)} do not fit Cin={cin}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"{name}: stride 2 needs an even input, got {h}x{w}")
    check_channels(name, cin, cout)
    if x.device.type == "cpu":
        return separable_block_plain(x, dw_w, dw_b, pw_w, pw_b, stride, relu6, pw_act)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"separable_block_{sfx}")
    code = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
              pw_b.data_ptr(), out.data_ptr(), n, h, w, cin, cout, stride,
              int(relu6), int(pw_act), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    separable_block.launches += 1
    return out


separable_block.launches = 0
