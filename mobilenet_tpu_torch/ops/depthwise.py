"""Standalone float depthwise 3x3 + bias + ReLU(6): the CUDA kernel
`csrc/depthwise.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_dw.py`
`depthwise_conv_pallas`: MobileNet-V1's "dw" route (the JAX package's
"pallas": this kernel, then the plain pointwise) and the depthwise taps of
the per-layer collect under "fused" routing (`models/mobilenet_v1.py`).
What bounds it on the card and what the design does about it is in the
CUDA source's header. The kernel (`csrc/depthwise_ring.cuh`, shared with
the int8 kernel of `ops/depthwise_i8.py`) runs the plan of `dw_plan`, which
this module's CPU tests check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .conv import apply_activation, dw_taps_f32
from .separable_block import (
    H100_SMS, SMEM_LIMIT, _sms, check_aligned, check_channels, check_kernel_args,
)

# -- the kernel's plan (csrc/depthwise_ring.cuh) --------------------------------
CONSUMERS = 256        # consumer threads a block (8 warps); + one producer warp
VEC = 16               # bytes of channels a consumer thread
MAX_VECS = 16          # a channel slice: at most 256 bytes of a pixel
MAX_SLOTS = 4
SLOT_CAP = 56 * 1024   # a window slot's bytes: four fit in a block's shared memory
BASE_ALIGN = 128       # the slots' alignment (TMA destinations)
MIN_UNITS = 0.5        # units a SM the plan keeps, where rows allow (batch 2's
                       # layers time best as few units of several rows)
MIN_ROWS = 3           # output rows a band's window should hold before slices narrow
RELOAD = 0.3           # a window row loaded before a segment's first output, in outputs


class DwPlan(NamedTuple):
    th: int    # output rows a band
    tw: int    # output columns a band
    seg: int   # output rows a consumer item slides down
    nv: int    # 16-byte vectors a channel slice
    ws: int    # window slots of the ring


def dw_slices(c: int, elem: int) -> tuple:
    """(slices, vectors a slice) of a pixel of c channels of `elem` bytes:
    the fewest slices of at most MAX_VECS vectors, evened out (the last
    vector of int8 at C % 16 == 8 is a half: 8 bytes)."""
    vecs = -(-c * elem // VEC)
    slices = -(-vecs // MAX_VECS)
    return slices, -(-vecs // slices)


def dw_smem_bytes(elem: int, stride: int, th: int, tw: int, nv: int, ws: int) -> int:
    """Dynamic shared memory of a plan (the kernel's `make_geo`): the base's
    alignment, WS slots of (th-1)s+3 rows x (tw-1)s+3 columns x nv * 16
    bytes (each rounded up to 128), and a full and an empty barrier a slot."""
    del elem  # a slot holds bytes, whatever the element
    slot = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3) * nv * VEC
    return BASE_ALIGN + ws * (-(-slot // BASE_ALIGN) * BASE_ALIGN) + 2 * ws * 8


@functools.lru_cache(maxsize=None)
def dw_plan(n: int, h: int, w: int, c: int, elem: int, stride: int,
            sms: int = H100_SMS) -> DwPlan:
    """The kernel's plan for (n, h, w, c) of `elem`-byte elements at `stride`
    on a card of `sms` SMs: channel slices of `dw_slices`, narrowed (halving
    the vectors a slice) while a band's window could hold fewer than MIN_ROWS
    output rows; the fewest column tiles whose window fits a TMA box (256
    columns) and a 3-row slot within SLOT_CAP; the most output rows a band
    whose window fits SLOT_CAP, cut while the units (bands x slices) number
    fewer than MIN_UNITS a SM (halved down to 2 rows, then the slices
    narrowed down to 4 vectors, then 1 row), then evened out over Ho; the
    segment length with the least time for a unit's busiest consumer thread
    (its passes x (rows + RELOAD for each window row a segment loads before
    its first output)); as many slots, up to MAX_SLOTS, as shared memory
    holds. The slot cap, the row and unit floors and RELOAD come from a
    sweep of candidate plans at V1 1.0-224's layers on an H100 (PERF.md, PR
    17)."""
    vecs = -(-c * elem // VEC)
    _, nv = dw_slices(c, elem)
    ho, wo = -(-h // stride), -(-w // stride)
    while True:
        pix = nv * VEC
        ncol = 1
        while True:
            tw = -(-wo // ncol)
            ww = (tw - 1) * stride + 3
            if (ww <= 256 and 3 * ww * pix <= SLOT_CAP) or tw == 1:
                break
            ncol += 1
        rows = max(1, min((SLOT_CAP // (ww * pix) - 3) // stride + 1, (256 - 3) // stride + 1))
        if nv == 1 or rows >= min(ho, MIN_ROWS):
            break
        nv = -(-nv // 2)
    slices = -(-vecs // nv)
    bands_w = -(-wo // tw)
    th = min(ho, rows)
    while n * -(-ho // th) * bands_w * slices < MIN_UNITS * sms:
        if th > 2:
            th = -(-th // 2)
        elif nv > 4:
            nv = -(-nv // 2)
            slices = -(-vecs // nv)
        elif th > 1:
            th = 1
        else:
            break
    th = -(-ho // -(-ho // th))
    lanes = CONSUMERS // nv
    best = None
    for seg in range(th, 0, -1):
        items = -(-th // seg) * tw
        cost = -(-items // lanes) * (seg + RELOAD * (3 - stride))
        if best is None or cost < best[0] - 1e-9:
            best = (cost, seg)
    slot = dw_smem_bytes(elem, stride, th, tw, nv, 1) - BASE_ALIGN - 16
    ws = max(1, min(MAX_SLOTS, (SMEM_LIMIT - BASE_ALIGN - 2 * MAX_SLOTS * 8) // slot))
    plan = DwPlan(th, tw, best[1], nv, ws)
    if dw_smem_bytes(elem, stride, th, tw, nv, ws) > SMEM_LIMIT:
        raise ValueError(f"depthwise: no plan fits shared memory for {(n, h, w, c)} x {elem} "
                         f"bytes at stride {stride}")
    return plan


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
    kernel on the plan of `dw_plan` or raises."""
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
    plan = dw_plan(n, h, wd, c, x.element_size(), stride, _sms(x.device.index or 0))
    code = getattr(lib, f"depthwise_{suffix}")(
        x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, wd, c, stride, int(relu6), *plan, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    depthwise.launches += 1
    return out


depthwise.launches = 0
