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
source's header. The kernel runs the tile plan of `separable_i8_plan`, which
this module's CPU tests check, and reads the pointwise weight K-major, as a
(Cout, Cin) copy (`pw_wt`, made once at upload by `quant/model.py` and
`quant/v2.py`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..quant import ops as qops
from . import _build
from .depthwise_i8 import check_i8_args, check_i8_dw
from .separable_block import (
    H100_SMS, MAX_B_STAGES, SMEM_LIMIT, SepPlan, _sms, _tile, check_aligned, check_channels,
    slice_widths,
)

# -- the int8 kernel's tile plan (csrc/separable_i8_wgmma.cuh) -----------------
CHUNK_I8 = 128          # channels a window chunk, an A atom row, a weight stage's K bytes
B_STAGE_I8 = 128 * 128  # a weight ring slot: up to 128 rows of 128 K bytes
ZERO_I8 = 3 * CHUNK_I8  # the zero row: three window pixels
TAB_GROUP = 336         # the depthwise table: bytes a group of 16 channels
K_ALIGN = 16            # TMA strides are multiples of 16 bytes: Cin is padded to 16
# A unit's time model, in the units of `separable_plan`'s: the depthwise a
# pixel row and input channel, and the product a column more. The product runs
# at twice the bf16 rate (int8 tensor cores); the depthwise at half the bf16
# tile's 0.18, the ratio of the two pre-Hopper tiles' depthwise cycles a
# 32-channel chunk (PERF.md §6: int8 6.9 k at b02, bf16 11.8-15.0 k).
DW_COST_I8, MM_COST_I8 = 0.09, 0.00065


def padded_cin(cin: int) -> int:
    """The Cin the kernel sees: a multiple of 16 (zero channels added)."""
    return -(-cin // K_ALIGN) * K_ALIGN


def separable_i8_smem_bytes(nwg: int, th: int, tw: int, kp: int, ws: int, bs: int,
                            stride: int, cin: int) -> int:
    """Dynamic shared memory of a plan (the kernel's `make_geo`; cin a
    multiple of 16): 1 KB of alignment, the A panel (64 * nwg rows x kp
    int8), the weight ring, the window ring (slots of (th-1)s+3 x (tw-1)s+3
    pixels x min(128, Cin) channels, 1 KB-aligned), the depthwise table
    (TAB_GROUP bytes a 16-channel group), 128 bytes of barriers and a flag,
    and a zero row of 3 pixels."""
    wh, ww = (th - 1) * stride + 3, (tw - 1) * stride + 3
    win = -(-wh * ww * min(CHUNK_I8, cin) // 1024) * 1024
    return (1024 + 64 * nwg * kp + bs * B_STAGE_I8 + ws * win + cin // 16 * TAB_GROUP + 128
            + ZERO_I8)


def chunk_groups_i8(cin: int) -> list:
    """The live 16-channel groups of each 128-channel chunk of the panel
    (the kernel's `live_groups`, Cin padded to 16): the other columns of a
    chunk are never written, and the weight's rows there load as zeros."""
    cin = padded_cin(cin)
    return [min(8, (cin - CHUNK_I8 * c) // 16) for c in range(-(-cin // CHUNK_I8))]


@functools.lru_cache(maxsize=None)
def separable_i8_plan(n: int, h: int, w: int, cin: int, cout: int, stride: int,
                      sms: int = H100_SMS) -> SepPlan:
    """The int8 kernel's plan for (n, h, w, cin) -> cout at `stride` on a card
    of `sms` SMs, built as `separable_plan` is: four consumer warpgroups
    (256-pixel tiles), two (128) or one (64), each with the fewest tiles; the
    A panel (TM x Cin int8, whole 128-channel atoms) all of Cin where it fits
    beside two window slots, or one, else Cin in ranges; the output channels
    split into parts of a multiple of 64 where tiles are too few for the SMs.
    Four warpgroups (the lean depthwise, slices of at most 64 columns) only
    where Cin <= 32: a thread then has one pixel a unit, too little work to
    hide a unit's latencies with two warpgroups (b00: 0.618 ms with two,
    0.399 with four; b01, Cin 64 and two pixels a thread, 0.235 with two,
    0.254 with four: PERF.md §6). The choice
    minimises waves x a unit's time (DW_COST_I8, MM_COST_I8), a single window
    slot counting 1.3x; weight slots grow to 4 as shared memory allows."""
    cin = padded_cin(cin)
    ho, wo = -(-h // stride), -(-w // stride)
    rows, nch = n * ho, -(-cin // CHUNK_I8)
    cands = []
    for nwg in (4, 2, 1) if cin <= 32 else (2, 1):
        th, tw, tiles = _tile(64 * nwg, rows, wo, stride)
        if th * tw <= 64 * (nwg - 1):
            continue  # the last warpgroup would hold no pixel
        best_kpc = 0
        for ws in (2, 1):
            free = SMEM_LIMIT - separable_i8_smem_bytes(nwg, th, tw, 0, ws, 2, stride, cin)
            kpc = min(nch, free // (64 * nwg * CHUNK_I8))
            if kpc > best_kpc:
                best_kpc, best_ws = kpc, ws
            if kpc == nch:
                break
        if best_kpc == 0:
            continue
        kp, ws = best_kpc * CHUNK_I8, best_ws
        bs = 2
        while (bs < MAX_B_STAGES
               and separable_i8_smem_bytes(nwg, th, tw, kp, ws, bs + 1, stride, cin)
               <= SMEM_LIMIT):
            bs += 1
        ranges = -(-nch // best_kpc)
        for parts in range(1, max(1, cout // 64) + 1):
            cw = min(-(-cout // 8) * 8, -(-cout // (parts * 64)) * 64)
            split = -(-cout // cw)
            if split != parts:
                continue
            dw = DW_COST_I8 * (len(slice_widths(cw, max_slice(nwg))) if ranges > 1 else 1)
            cost = -(-tiles * split // sms) * (dw + MM_COST_I8 * cw)
            cost *= 1.3 if ws == 1 else 1.0
            cands.append(((ranges > 1, cost, split, -nwg),
                          SepPlan(nwg, th, tw, kp, split, cw, ws, bs)))
    return min(cands)[1]


def max_slice(nwg: int) -> int:
    """The widest output slice of the kernel's form (`slice_n`)."""
    return 64 if nwg == 4 else 128


def separable_block_i8_plain(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride: int,
                             dw_six_q: float, pw_six_q: float, relu6: bool = True,
                             pw_linear: bool = False) -> torch.Tensor:
    """The plain int8 depthwise then the plain int8 pointwise (linear with
    pw_linear: pw_six_q is then unused)."""
    y = qops.depthwise_i8(x, dw_w, dw_b, dw_m, dw_six_q, stride, relu6)
    if pw_linear:
        return qops.pointwise_i8_linear(y, pw_w, pw_b, pw_m)
    return qops.pointwise_i8(y, pw_w, pw_b, pw_m, pw_six_q, relu6)


def kmajor(pw_w: torch.Tensor) -> torch.Tensor:
    """The K-major (Cout, Cin) copy of a (Cin, Cout) pointwise weight, as the
    kernel reads it (s8 wgmma reads both operands K-major)."""
    return pw_w.t().contiguous()


def _pad_cin(t: torch.Tensor, cin16: int) -> torch.Tensor:
    """t with zero channels appended to its last dimension, up to cin16."""
    return F.pad(t, (0, cin16 - t.shape[-1])).contiguous()


def separable_block_i8(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride: int,
                       dw_six_q: float, pw_six_q: float, relu6: bool = True,
                       pw_linear: bool = False, pw_wt=None) -> torch.Tensor:
    """int8 dw 3x3 (TF-SAME, stride 1 or 2) + bias + requant -> pw 1x1
    s8 x s8 -> s32 + bias + requant (pw_linear: the linear requant
    clamp(rint(float32(acc) * m)), no ReLU).

    x (N,H,W,Cin) int8, dw_w (3,3,1,Cin) int8, dw_b (Cin,) int32, dw_m
    (Cin,) float32, pw_w (Cin,Cout) int8, pw_b (Cout,) int32, pw_m (Cout,)
    float32 -> (N,Ho,Wo,Cout) int8. `pw_wt`: the K-major (Cout, Cin) copy
    of pw_w that the kernel reads; made here with one transpose when absent.
    On CPU tensors this is the plain version (which reads pw_w); on CUDA
    tensors it launches the kernel or raises. A Cin that is not a multiple
    of 16 is padded with zero channels (a copy of x) for the kernel's TMA
    strides."""
    name = "separable_block_i8"
    check_i8_args(name, x, (dw_w, pw_w) + (() if pw_wt is None else (pw_wt,)),
                  (dw_b, pw_b), (dw_m, pw_m))
    check_i8_dw(name, x, dw_w, dw_b, dw_m, stride)
    n, h, w, cin = x.shape
    cout = int(pw_w.shape[-1])
    if (tuple(pw_w.shape) != (cin, cout) or tuple(pw_b.shape) != (cout,)
            or tuple(pw_m.shape) != (cout,)):
        raise ValueError(f"{name}: pointwise shapes {tuple(pw_w.shape)} "
                         f"{tuple(pw_b.shape)} {tuple(pw_m.shape)} do not fit Cin={cin}")
    if pw_wt is not None and tuple(pw_wt.shape) != (cout, cin):
        raise ValueError(f"{name}: pw_wt {tuple(pw_wt.shape)} is not the K-major "
                         f"({cout}, {cin}) copy of pw_w")
    check_channels(name, cin, cout)
    if x.device.type == "cpu":
        return separable_block_i8_plain(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride,
                                        dw_six_q, pw_six_q, relu6, pw_linear)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if pw_wt is None:
        pw_wt = kmajor(pw_w)
    cin16 = padded_cin(cin)
    if cin16 != cin:
        x, dw_w, dw_b, dw_m, pw_wt = (_pad_cin(t, cin16) for t in (x, dw_w, dw_b, dw_m, pw_wt))
    check_aligned(name, x, dw_w, dw_b, dw_m, pw_wt, pw_b, pw_m)  # TMA and vector loads
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout), dtype=torch.int8,
                      device=x.device)
    plan = separable_i8_plan(n, h, w, cin16, cout, stride, _sms(x.device.index or 0))
    fn = lib.separable_block_i8_linear if pw_linear else lib.separable_block_i8
    code = fn(
        x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), dw_m.data_ptr(), pw_wt.data_ptr(),
        pw_b.data_ptr(), pw_m.data_ptr(), out.data_ptr(), n, h, w, cin16, cout, stride,
        int(relu6), float(dw_six_q), float(pw_six_q), *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    separable_block_i8.launches += 1
    return out


separable_block_i8.launches = 0
