"""Fused int8 inverted-residual block of MobileNet-V2: the CUDA kernel
`csrc/inverted_residual_i8.cu` and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/quant/pallas_ir_i8.py`
`inverted_residual_pallas_i8` (V2 int8 blocks 2-16), at stride 2
`quant/pallas_expand_s2_i8.py` `expand_block_packed_s2_i8` (V2 block 1),
and `quant/pallas_ir_v3_i8.py` `v3_block_pallas_i8` in the form the JAX
package's V2 int8 route bridges block 13 onto (k 3, relu, no SE). Exact:
equal, bit for bit, to the plain version and to `quant/v2.py`'s oracle.
What bounds it on the card and what the design does about it is in the
CUDA source's header. The kernel takes one output tile of TH x TW pixels
per thread block; `ir_i8_plan` picks the tile and is the fits-function: a
shape with no plan raises at the call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..quant import ops as qops
from . import _build
from .depthwise_i8 import check_i8_args
from .inverted_residual import plan_tile
from .separable_block import check_channels

# Mirrors of inverted_residual_i8.cu's constants.
KE = 64                 # expanded channels per chunk
LDZ = KE + 4            # expanded window tile row stride (bytes)
LDK = KE + 16           # depthwise tile / projection slice row stride (bytes)
# The largest tile ir_i8_plan takes.
MAX_OUTPUTS_I8 = 256


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def ir_i8_smem_bytes(th: int, tw: int, cin: int, cout: int, stride: int) -> int:
    """Dynamic shared memory of one tile (inverted_residual_i8.cu
    make_shape): the int8 input window, then the chunk buffers (expanded
    window tile, expand and projection weight slices, depthwise tile) or the
    int8 result tile."""
    pp = _rup(((th - 1) * stride + 3) * ((tw - 1) * stride + 3), 16)
    cinp, coutp, tmp = _rup(cin, 32), _rup(cout, 16), _rup(th * tw, 16)
    xs = _rup(pp * (cinp + 16), 128)
    work = (_rup(pp * LDZ, 128) + _rup(KE * (cinp + 16), 128) + _rup(tmp * LDK, 128)
            + _rup(coutp * LDK, 128))
    return xs + max(work, _rup(tmp * (coutp + 16), 128))


@functools.lru_cache(maxsize=None)
def ir_i8_plan(n: int, h: int, w: int, cin: int, cout: int,
               stride: int) -> Optional[Tuple[int, int]]:
    """The output tile (TH, TW) for a block on (n, h, w, cin) -> cout, or
    None when no tile fits: the float kernel's search and time model
    (`ops/inverted_residual.plan_tile`, not refitted to int8 timings) on
    this kernel's shared memory."""
    return plan_tile(n, h, w, cin, cout, stride,
                     lambda th, tw: ir_i8_smem_bytes(th, tw, cin, cout, stride),
                     MAX_OUTPUTS_I8)


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
                         residual: bool) -> torch.Tensor:
    """int8 expand 1x1 + bias + ReLU6 requant -> dw 3x3 (TF-SAME, stride 1
    or 2) + bias + ReLU6 requant -> projection 1x1 + bias + linear requant
    [-> + x, saturating].

    x (N,H,W,Cin) int8, exp_w (Cin,E) int8, dw_w (3,3,1,E) int8, prj_w
    (E,Cout) int8, biases int32, multipliers float32 -> (N,Ho,Wo,Cout) int8;
    residual needs stride 1 and Cin == Cout. On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel or raises."""
    name = "inverted_residual_i8"
    check_i8_args(name, x, (exp_w, dw_w, prj_w), (exp_b, dw_b, prj_b), (exp_m, dw_m, prj_m))
    n, h, w, cin = x.shape
    e, cout = int(exp_w.shape[-1]), int(prj_w.shape[-1])
    if (tuple(exp_w.shape) != (cin, e) or tuple(exp_b.shape) != (e,)
            or tuple(exp_m.shape) != (e,) or tuple(dw_w.shape) != (3, 3, 1, e)
            or tuple(dw_b.shape) != (e,) or tuple(dw_m.shape) != (e,)
            or tuple(prj_w.shape) != (e, cout) or tuple(prj_b.shape) != (cout,)
            or tuple(prj_m.shape) != (cout,)):
        raise ValueError(f"{name}: weight shapes {tuple(exp_w.shape)} {tuple(dw_w.shape)} "
                         f"{tuple(prj_w.shape)} do not fit Cin={cin}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{name}: a residual needs stride 1 and Cin == Cout")
    check_channels(name, cin, e, cout)
    plan = ir_i8_plan(n, h, w, cin, cout, stride)
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"s{stride} (ir_i8_plan)")
    if x.device.type == "cpu":
        return inverted_residual_i8_plain(x, exp_w, exp_b, exp_m, exp_six_q, dw_w, dw_b, dw_m,
                                          dw_six_q, prj_w, prj_b, prj_m, stride, residual)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout), dtype=torch.int8,
                      device=x.device)
    code = lib.inverted_residual_i8(
        x.data_ptr(), exp_w.data_ptr(), exp_b.data_ptr(), exp_m.data_ptr(), dw_w.data_ptr(),
        dw_b.data_ptr(), dw_m.data_ptr(), prj_w.data_ptr(), prj_b.data_ptr(),
        prj_m.data_ptr(), out.data_ptr(), n, h, w, cin, e, cout, stride, int(residual),
        plan[0], plan[1], float(exp_six_q), float(dw_six_q),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    inverted_residual_i8.launches += 1
    return out


inverted_residual_i8.launches = 0
