"""Fused int8 inverted-residual block of MobileNet-V2 and its plain PyTorch
version. On the card it runs the int8 bottleneck's Hopper tile
(`csrc/v3_i8_wgmma.cuh`, through `csrc/v3_block_i8.cu`) with the ReLU6
requant: k 3, no SE, each layer's six_q as the requant's upper bound.

Replaces the TPU kernels `mobilenet_tpu/quant/pallas_ir_i8.py`
`inverted_residual_pallas_i8` (V2 int8 blocks 2-16), at stride 2
`quant/pallas_expand_s2_i8.py` `expand_block_packed_s2_i8` (V2 block 1),
and `quant/pallas_ir_v3_i8.py` `v3_block_pallas_i8` in the form the JAX
package's V2 int8 route bridges block 13 onto (k 3, relu, no SE; the JAX
route takes it only while six_q rounds to 127, the tile takes any six_q).
Exact: equal, bit for bit, to the plain version and to `quant/v2.py`'s
oracle. What bounds it on the card and what the design does about it is in
the CUDA sources' headers. `ops/v3_block_i8.v3_i8_wgmma_plan` is the
fits-function: a shape with no plan raises at the call.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant import ops as qops
from .v3_block_i8 import check_block_i8, launch_i8


def inverted_residual_i8_plain(x, exp_w, exp_b, exp_m, exp_six_q: float, dw_w, dw_b, dw_m,
                               dw_six_q: float, prj_w, prj_b, prj_m, stride: int,
                               residual: bool) -> torch.Tensor:
    """The plain int8 pointwise (ReLU6 requant) -> the plain int8 depthwise
    -> the linear pointwise [-> the saturating residual add]."""
    z = qops.pointwise_i8(x, exp_w, exp_b, exp_m, exp_six_q)
    z = qops.depthwise_i8(z, dw_w, dw_b, dw_m, dw_six_q, stride)
    y = qops.pointwise_i8_linear(z, prj_w, prj_b, prj_m)
    return qops.residual_add_i8(y, x) if residual else y


def inverted_residual_i8(x, exp_w, exp_b, exp_m, exp_six_q: float, dw_w, dw_b, dw_m,
                         dw_six_q: float, prj_w, prj_b, prj_m, stride: int,
                         residual: bool, *, wt: Optional[dict] = None) -> torch.Tensor:
    """int8 expand 1x1 + bias + ReLU6 requant -> dw 3x3 (TF-SAME, stride 1
    or 2) + bias + ReLU6 requant -> projection 1x1 + bias + linear requant
    [-> + x, saturating].

    x (N,H,W,Cin) int8, exp_w (Cin,E) int8, dw_w (3,3,1,E) int8, prj_w
    (E,Cout) int8, biases int32, multipliers float32 -> (N,Ho,Wo,Cout) int8;
    residual needs stride 1 and Cin == Cout. `wt`: the kernel's weight forms
    ({"exp", "dw", "prj"}: `ops/v3_block_i8.kernel_weights`, made once at
    upload by quant/v2.to_device_i8_v2), which the kernel reads. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel (`launch_i8`), or raises, also when `wt` is not given."""
    name = "inverted_residual_i8"
    layers = [{"w": w, "b": b, "m": m, "six_q": six} for w, b, m, six in (
        (exp_w, exp_b, exp_m, exp_six_q), (dw_w, dw_b, dw_m, dw_six_q),
        (prj_w, prj_b, prj_m, 0.0))]
    exp, dw, prj = layers
    kw = dict(k=3, stride=stride, act="relu6", residual=residual)
    if x.device.type == "cpu":
        check_block_i8(name, x, exp, dw, prj, None, None, **kw)
        return inverted_residual_i8_plain(x, exp_w, exp_b, exp_m, exp_six_q, dw_w, dw_b, dw_m,
                                          dw_six_q, prj_w, prj_b, prj_m, stride, residual)
    if wt is None:
        raise ValueError(f"{name}: the kernel reads its weight forms: give wt "
                         "(ops/v3_block_i8.kernel_weights, made once at upload)")
    for layer, key in zip(layers, ("exp", "dw", "prj")):
        layer["wt"] = wt[key]
    out = launch_i8(name, x, exp, dw, prj, None, None, **kw)
    inverted_residual_i8.launches += 1
    return out


inverted_residual_i8.launches = 0
