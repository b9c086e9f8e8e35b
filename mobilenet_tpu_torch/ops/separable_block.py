"""Fused depthwise-separable block: the CUDA kernel `csrc/separable_block.cu`
and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_block.py`
`separable_block_pallas` and the lane-packed `ops/pallas_block_packed.py`
`separable_block_packed` / `separable_block_packed_s2`; every block, narrow
or wide, runs this one dense NHWC kernel. `pw_act=False` is the packed
kernels' `pw_epilogue=False` mode (a linear projection: MobileNet-V2's
block 0). What bounds it on the card and what
the design does about it is in the CUDA source's header. The bf16 kernel
runs the tile plan of `separable_plan`, which this module's CPU tests check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


# -- the bf16 kernel's tile plan (csrc/separable_wgmma.cuh) --------------------
SMEM_LIMIT = 232448     # dynamic shared memory a block may use (227 KB)
CHUNK = 64              # channels a window chunk, an A atom, a weight stage's K rows
B_STAGE_BYTES = CHUNK * 128 * 2  # a weight ring slot: 64 K rows x up to 128 columns
MAX_B_STAGES = 4
H100_SMS = 132
# A unit's time model, in SM cycles a pixel row (64 a warpgroup) and input
# channel: the depthwise (nine taps on the CUDA cores), and the product per
# output column (1,024 bf16 multiply-adds a cycle an SM, at ~75%).
DW_COST, MM_COST = 0.18, 0.0013


class SepPlan(NamedTuple):
    nwg: int    # consumer warpgroups; TM = 64 * nwg pixels a tile
    th: int     # tile rows (of the N * Ho output rows)
    tw: int     # tile columns (of Wo)
    kp: int     # A panel channels (multiple of 64); below Cin: Cin in ranges
    split: int  # output-channel parts a pixel tile
    cw: int     # output channels a part
    ws: int     # window ring slots
    bs: int     # weight ring slots


def separable_smem_bytes(nwg: int, th: int, tw: int, kp: int, ws: int, bs: int,
                         stride: int) -> int:
    """Dynamic shared memory of a plan (the kernel's `make_geo`): 1 KB of
    alignment, the A panel (64 * nwg rows x kp bf16), the weight ring, the
    window ring (slots of (th-1)s+3 x (tw-1)s+3 pixels x 64 channels,
    1 KB-aligned), 128 bytes of barriers and a zero row of 3 pixels."""
    wh, ww = (th - 1) * stride + 3, (tw - 1) * stride + 3
    win = -(-wh * ww * CHUNK * 2 // 1024) * 1024
    return 1024 + 64 * nwg * kp * 2 + bs * B_STAGE_BYTES + ws * win + 128 + 3 * CHUNK * 2


def slice_widths(cols: int) -> list:
    """The kernel's output slices of a part of `cols` channels: 128 while it
    lasts, then the binary digits of the rest (wgmma N, no padded column)."""
    out = []
    while cols > 0:
        n = next(w for w in (128, 64, 32, 16, 8) if cols >= w)
        out.append(n)
        cols -= n
    return out


def chunk_groups(cin: int) -> list:
    """The live 8-channel groups of each 64-channel chunk of the panel (the
    kernel's `live`): the other groups of a chunk hold zeros, and every
    chunk takes its four 16-wide K steps."""
    return [min(8, (cin - CHUNK * c) // 8) for c in range(-(-cin // CHUNK))]


def _tile(tm: int, rows: int, wo: int, stride: int):
    """(th, tw, tiles): the tile of at most tm pixels over rows x wo that
    minimises tiles x (tm + half the window's pixels), a tile's compute and
    its staging; window sides within a TMA box (256)."""
    cap = 126 if stride == 2 else 254
    best = None
    for tw in range(1, min(wo, tm, cap) + 1):
        th = min(tm // tw, rows, cap)
        tiles = -(-rows // th) * -(-wo // tw)
        win = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
        key = (tiles * (2 * tm + win), win)
        if best is None or key < best[0]:
            best = (key, th, tw, tiles)
    return best[1:]


@functools.lru_cache(maxsize=None)
def separable_plan(n: int, h: int, w: int, cin: int, cout: int, stride: int,
                   sms: int = H100_SMS) -> SepPlan:
    """The bf16 kernel's plan for (n, h, w, cin) -> cout at `stride` on a card
    of `sms` SMs. Candidates: two warpgroups (128-pixel tiles) or one (64),
    each with the fewest tiles (`_tile`); the A panel holds all of Cin where
    it fits beside two window slots, or one, else Cin in ranges of KP
    channels (only if no candidate holds it all); the output channels split
    into parts of a multiple of 64 where there are too few tiles for the SMs.
    The choice minimises waves (one block an SM: the registers of either
    kernel allow no second) x a unit's time (DW_COST, MM_COST), a single
    window slot counting 1.3x; weight slots grow to 4 as shared memory
    allows."""
    ho, wo = -(-h // stride), -(-w // stride)
    rows, nch = n * ho, -(-cin // CHUNK)
    cands = []
    for nwg in (2, 1):
        th, tw, tiles = _tile(64 * nwg, rows, wo, stride)
        if nwg == 2 and th * tw <= 64:
            continue  # the second warpgroup would hold no pixel
        best_kpc = 0
        for ws in (2, 1):
            free = SMEM_LIMIT - separable_smem_bytes(nwg, th, tw, 0, ws, 2, stride)
            kpc = min(nch, free // (64 * nwg * 2 * CHUNK))
            if kpc > best_kpc:
                best_kpc, best_ws = kpc, ws
            if kpc == nch:
                break
        if best_kpc == 0:
            continue
        kp, ws = best_kpc * CHUNK, best_ws
        bs = 2
        while (bs < MAX_B_STAGES and separable_smem_bytes(nwg, th, tw, kp, ws, bs + 1, stride)
               <= SMEM_LIMIT):
            bs += 1
        ranges = -(-nch // best_kpc)
        for parts in range(1, max(1, cout // CHUNK) + 1):
            cw = min(-(-cout // 8) * 8, -(-cout // (parts * CHUNK)) * CHUNK)
            split = -(-cout // cw)
            if split != parts:
                continue
            dw = DW_COST * (len(slice_widths(cw)) if ranges > 1 else 1)
            cost = -(-tiles * split // sms) * (dw + MM_COST * cw)
            cost *= 1.3 if ws == 1 else 1.0
            cands.append(((ranges > 1, cost, split, -nwg),
                          SepPlan(nwg, th, tw, kp, split, cw, ws, bs)))
    return min(cands)[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, cin: int, cout: int, stride: int) -> SepPlan:
    """`separable_plan` for an (N, H, W, Cin) input on its card."""
    n, h, w, _ = x.shape
    return separable_plan(n, h, w, cin, cout, stride, _sms(x.device.index or 0))


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
    args = [x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
            pw_b.data_ptr(), out.data_ptr(), n, h, w, cin, cout, stride, int(relu6),
            int(pw_act)]
    if sfx == "bf16":  # TMA and 16-byte vector loads
        check_aligned(name, x, dw_w, dw_b, pw_w, pw_b)
        args += plan_for(x, cin, cout, stride)
    code = getattr(lib, f"separable_block_{sfx}")(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    separable_block.launches += 1
    return out


separable_block.launches = 0
