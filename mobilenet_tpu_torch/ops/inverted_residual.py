"""Fused inverted-residual block of MobileNet-V2 and its plain PyTorch
version. On the card it runs the V3 bottleneck's kernel (`csrc/v3_block.cu`,
through `ops/v3_block.check_block` and `launch`) with ReLU6, k 3 and no SE:
bf16 on the Hopper tile of `csrc/v3_wgmma.cuh` (plan `v3_wgmma_plan`),
float32 on the CUDA-core tile of `csrc/v3_f32.cuh` (plan `v3_plan`).

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_ir_block.py`
`inverted_residual_pallas` (V2 blocks 2-16) and, at stride 2,
`ops/pallas_expand_s2.py` `expand_block_packed_s2` (V2 block 1, whose lane
packing and even-pixel `kron` selection were a TPU layout). What bounds it
on the card and what the design does about it is in the CUDA sources'
headers. Each plan is its tile's fits-function: a shape with no plan raises
at the call.
"""

from __future__ import annotations

import torch

from . import v3_block as v3
from .conv import apply_activation, dw_taps_f32, ieee_f32
from .separable_block import check_aligned, check_kernel_args

NO_SE = (None,) * 4


@ieee_f32
def inverted_residual_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride: int,
                            residual: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 expansion + bias in f32,
    ReLU6, rounded to x's dtype; f32 taps (dy then dx) of the zero-padded
    expansion + bias, ReLU6, rounded; f32 projection + bias, rounded; then
    the residual added in x's dtype."""
    n, h, w, cin = x.shape
    z = x.float().reshape(n * h * w, cin) @ exp_w.float() + exp_b.float()
    z = apply_activation(z, True).to(x.dtype).reshape(n, h, w, -1)
    z = apply_activation(dw_taps_f32(z, dw_w, stride) + dw_b.float(), True).to(x.dtype)
    _, ho, wo, e = z.shape
    y = (z.float().reshape(n * ho * wo, e) @ prj_w.float() + prj_b.float()).to(x.dtype)
    y = y.reshape(n, ho, wo, -1)
    return (y + x).to(x.dtype) if residual else y


def inverted_residual(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride: int,
                      residual: bool) -> torch.Tensor:
    """expand 1x1 + bias + ReLU6 -> dw 3x3 (TF-SAME, stride 1 or 2) + bias
    + ReLU6 -> linear projection 1x1 + bias [+ x].

    x (N,H,W,Cin), exp_w (Cin,E), exp_b (E,), dw_w (3,3,1,E), dw_b (E,),
    prj_w (E,Cout), prj_b (Cout,) -> (N,Ho,Wo,Cout); residual needs stride 1
    and Cin == Cout. On CPU tensors this is the plain version; on CUDA
    tensors it launches the V3 bottleneck's tile of its dtype or raises."""
    name = "inverted_residual"
    sfx = check_kernel_args(name, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    sms = v3._sms(x.device.index or 0) if x.device.type == "cuda" else v3.H100_SMS
    kw = dict(k=3, stride=stride, act="relu6", residual=residual)
    e, cout, _, plan = v3.check_block(name, n, h, w, cin, exp_w, exp_b, dw_w, dw_b, prj_w,
                                      prj_b, NO_SE, itemsize=x.element_size(), sms=sms, **kw)
    check_aligned(name, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b)
    if x.device.type == "cpu":
        return inverted_residual_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride,
                                       residual)
    out = v3.launch(name, sfx, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, NO_SE, e=e,
                    cout=cout, sem=0, plan=plan, **kw)
    inverted_residual.launches += 1
    return out


inverted_residual.launches = 0
