"""Fused depthwise-separable block: the CUDA kernel `csrc/separable_block.cu`
and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_block.py`
`separable_block_pallas` and the lane-packed `ops/pallas_block_packed.py`
`separable_block_packed` / `separable_block_packed_s2`; every block, narrow
or wide, runs this one dense NHWC kernel. `pw_act=False` is the packed
kernels' `pw_epilogue=False` mode (a linear projection: MobileNet-V2's
block 0). `pw_epilogue=False` is `separable_block_pallas`'s mode of that
name: the raw float32 pointwise accumulation, with no pw bias and no
activation, the partial that the tensor-parallel forward sums over its
channel shards (parallel/tp_fused.py). Neither plan stages the output in
shared memory (the tiles store from registers), so a float32 output changes
no plan. What bounds it on the card and what
the design does about it is in the CUDA source's header. The bf16 kernel
runs the tile plan of `separable_plan`, the float32 kernel that of
`f32_sep_plan`; the CPU tests check both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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


def tensor_key(t) -> Optional[tuple]:
    """A tensor's part of a wrapper's cache key: its address (which also
    names the device: CUDA's unified addressing gives host and device memory
    disjoint ranges), shape, strides and dtype; None for None."""
    return None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype)


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


def slice_widths(cols: int, top: int = 128) -> list:
    """The kernel's output slices of a part of `cols` channels: `top` (128,
    or 64 in the int8 kernel's four-warpgroup form) while it lasts, then the
    binary digits of the rest (wgmma N, no padded column)."""
    out = []
    while cols > 0:
        n = next(w for w in (128, 64, 32, 16, 8) if w <= top and cols >= w)
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


# -- the float32 kernel's plan (csrc/separable_f32.cuh) -----------------------
F32_WC = 32             # channels a window chunk
F32_WSTR = F32_WC + 4   # floats a staged window pixel
F32_KB = 32             # weight rows a stage
F32_CONSUMERS = 256     # consumer threads a block
F32_MAX_TMP = 256       # tile pixels, rounded up to the form's 4 x mg
# 227 KB less the 256 bytes kept for a stage's shape (as v3_f32.cuh)
F32_SMEM_LIMIT = SMEM_LIMIT - 256
# (window slots, weight slots) the plan tries, each with the most panel
# channels that fit beside it
F32_RINGS = ((4, 3), (3, 3), (3, 2), (2, 2), (1, 2))
# the tile pixels a form tries: 8 x 8 micro-tiles (mg 2), 4 x 4 (mg 1)
F32_TMS = {2: (256, 192, 128, 96, 64), 1: (64, 48, 32, 24, 16)}
# A unit's time model, in SM cycles: the depthwise a pixel and input channel
# (nine float4 taps a channel quad, bound by shared memory; stride 2 reads with
# two-way bank conflicts) or, where the window ring is short, a chunk's load
# latency over the slots; the product a K step of a warp (16 mg^2 fmaf and
# 2 mg float4 loads at a form's issue efficiency) times the warps an SM
# sub-partition runs; a weight stage's wait, a unit's fixed waits, and the
# bytes a cycle an SM reads. The terms' form comes from the instruction
# counts; the constants were fit to an H100's kernel durations of every
# candidate plan (`f32_sep_candidates`) at V1 1.0-224's block shapes and V2
# b00 at batch 1, 2 and 256. `block_times --float32 --plans` times them all
# and reports the model's pick against the fastest.
F32_DW_CYC = {1: 0.34, 2: 0.55}
F32_FORM_EFF = {2: 0.9, 1: 0.66}
F32_CHUNK_LAT, F32_STAGE_CYC, F32_UNIT_CYC, F32_SM_BYTES = 850, 150, 160, 24.0


class F32SepPlan(NamedTuple):
    mg: int     # micro-tile form: 4 * mg rows and columns a thread (8 x 8 or 4 x 4)
    th: int     # tile rows (of the N * Ho output rows, image after image)
    tw: int     # tile columns (of Wo)
    kp: int     # panel channels (a multiple of 32); below Cin: Cin in ranges
    split: int  # output-column parts a tile
    cw: int     # columns a part (a multiple of 8)
    ns: int     # columns a slice at most: a weight stage's width
    ws: int     # window ring slots (32-channel chunks)
    bs: int     # weight ring slots (32-row stages)


def _rup(a: int, m: int) -> int:
    return -(-a // m) * m


def f32_sep_smem_bytes(mg: int, th: int, tw: int, kp: int, ns: int, ws: int, bs: int,
                       stride: int) -> int:
    """Dynamic shared memory of a float32 plan (separable_f32.cuh make_geo; the
    C entry `separable_f32_smem_bytes` computes the same): 128 bytes of
    barriers, ws window chunks ((th-1)s+3 x (tw-1)s+3 pixels x 36 floats, then
    the chunk's 9 depthwise tap rows and bias, 32 floats each), bs weight
    stages (32 rows x ns floats) and the panel (kp channels x the tile's
    pixels rounded up to 4 x mg), each rounded up to 128 bytes."""
    ph, pw = (th - 1) * stride + 3, (tw - 1) * stride + 3
    tmp = _rup(th * tw, 4 * mg)
    win = _rup((ph * pw * F32_WSTR + 10 * F32_WC) * 4, 128)
    return 128 + ws * win + bs * _rup(F32_KB * ns * 4, 128) + _rup(kp * tmp * 4, 128)


def f32_slices(cols: int, ns: int) -> list:
    """The float32 kernel's slices of a part of `cols` columns: ns while it
    lasts, then the rest (a multiple of 8: no padded column)."""
    out = []
    while cols > 0:
        out.append(min(ns, cols))
        cols -= out[-1]
    return out


def f32_threads(mg: int, tmp: int, w: int) -> int:
    """The consumer threads that hold a micro-tile of a slice w columns wide
    at a tile of tmp (rounded) pixels: (tmp / 4mg) x (w / 4mg)."""
    return tmp // (4 * mg) * (w // (4 * mg))


def _f32_tile(tm: int, mg: int, rows: int, wo: int, stride: int):
    """(th, tw, tiles): the tile of at most tm pixels over rows x wo that
    minimises tiles x (2 x its rounded pixels + its window's pixels)."""
    best = None
    for tw in range(1, min(wo, tm) + 1):
        th = min(tm // tw, rows)
        tiles = -(-rows // th) * -(-wo // tw)
        win = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
        key = (tiles * (2 * _rup(th * tw, 4 * mg) + win), win)
        if best is None or key < best[0]:
            best = (key, th, tw, tiles)
    return best[1:]


def _f32_unit_cycles(mg, th, tw, cin, cw, ns, kp, stride, split, ws):
    tmp = _rup(th * tw, 4 * mg)
    sl = f32_slices(cw, ns)
    ranges = -(-cin // kp)
    dw = (len(sl) if ranges > 1 else 1) * max(tmp * cin * F32_DW_CYC[stride],
                                              -(-cin // F32_WC) * F32_CHUNK_LAT / ws)
    pw = sum(16 * mg * mg * cin / F32_FORM_EFF[mg]
             * -(-f32_threads(mg, tmp, w) // 128) for w in sl)
    fixed = len(sl) * -(-cin // F32_KB) * F32_STAGE_CYC + F32_UNIT_CYC
    mem = th * tw * (cin / split + cw) * 4 / F32_SM_BYTES
    return max(dw + pw + fixed, mem)


def f32_sep_candidates(n: int, h: int, w: int, cin: int, cout: int, stride: int,
                       sms: int = H100_SMS) -> list:
    """The plans `f32_sep_plan` weighs for (n, h, w, cin) -> cout at `stride` on a
    card of `sms` SMs, each with its key, in the order it weighs them:
    each form's tile pixel budgets (F32_TMS), each with the fewest-cost tile
    (`_f32_tile`); the output columns in parts of a multiple of 8 (up to eight
    where the tiles alone fill the card), each part in slices of at most ns,
    the columns the form's 256 threads hold at the tile; each ring of
    F32_RINGS with the most panel channels that fit beside it (all of Cin, or
    Cin in ranges). The key: waves (one block an SM) x the unit time model
    above, then more SMs busy, then fewer units, then the larger tile."""
    ho, wo = -(-h // stride), -(-w // stride)
    rows, full = n * ho, _rup(cin, F32_WC)
    out = []
    for mg in (2, 1):
        for tm in F32_TMS[mg]:
            th, tw, tiles = _f32_tile(tm, mg, rows, wo, stride)
            tmp = _rup(th * tw, 4 * mg)
            ns_max = F32_CONSUMERS // (tmp // (4 * mg)) * 4 * mg // 8 * 8
            if ns_max < 8:
                continue
            seen = set()
            for parts in range(1, (cout // 8 if tiles < sms else min(cout // 8, 8)) + 1):
                cw = _rup(-(-cout // parts), 8)
                split = -(-cout // cw)
                ns = min(ns_max, cw)
                if split != parts or (cw, ns) in seen:
                    continue
                seen.add((cw, ns))
                for ws, bs in F32_RINGS:
                    free = F32_SMEM_LIMIT - f32_sep_smem_bytes(mg, th, tw, 0, ns, ws, bs, stride)
                    kp = min(full, free // (tmp * 4 * F32_WC) * F32_WC)
                    if kp < F32_WC:
                        continue
                    units = tiles * split
                    cost = -(-units // sms) * _f32_unit_cycles(mg, th, tw, cin, cw, ns, kp,
                                                              stride, split, ws)
                    out.append(((cost, -min(units, sms), units, -tmp),
                                F32SepPlan(mg, th, tw, kp, split, cw, ns, ws, bs)))
    return out


@functools.lru_cache(maxsize=None)
def f32_sep_plan(n: int, h: int, w: int, cin: int, cout: int, stride: int,
                 sms: int = H100_SMS) -> F32SepPlan:
    """The float32 kernel's plan for (n, h, w, cin) -> cout at `stride` on a
    card of `sms` SMs: the first candidate of `f32_sep_candidates` with the
    least key."""
    return min(f32_sep_candidates(n, h, w, cin, cout, stride, sms), key=lambda c: c[0])[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, cin: int, cout: int, stride: int):
    """The kernel's plan for an (N, H, W, Cin) input on its card:
    `separable_plan` for bf16, `f32_sep_plan` for float32."""
    n, h, w, _ = x.shape
    plan = f32_sep_plan if x.dtype == torch.float32 else separable_plan
    return plan(n, h, w, cin, cout, stride, _sms(x.device.index or 0))


# The kernel's pointwise epilogue codes (csrc/numerics.cuh Epilogue).
EPI_BIAS, EPI_BIAS_ACT, EPI_RAW = 0, 1, 2


@ieee_f32
def separable_block_plain(x, dw_w, dw_b, pw_w, pw_b, stride: int,
                          relu6: bool = True, pw_act: bool = True,
                          pw_epilogue: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 taps, + dw bias in f32,
    activation, cast to the weight dtype, f32 product, + pw bias in f32,
    activation (none if not pw_act), cast to x's dtype. pw_epilogue=False
    returns the f32 product alone (no pw bias, no activation, float32)."""
    y = apply_activation(dw_taps_f32(x, dw_w, stride) + dw_b.float(), relu6)
    n, ho, wo, cin = y.shape
    y = y.to(pw_w.dtype).float().reshape(n * ho * wo, cin) @ pw_w.float()
    if not pw_epilogue:
        return y.reshape(n, ho, wo, -1)
    y = y + pw_b.float()
    if pw_act:
        y = apply_activation(y, relu6)
    return y.reshape(n, ho, wo, -1).to(x.dtype)


def separable_block(x, dw_w, dw_b, pw_w, pw_b, stride: int,
                    relu6: bool = True, pw_act: bool = True,
                    pw_epilogue: bool = True) -> torch.Tensor:
    """dw 3x3 (TF-SAME, stride 1 or 2) + bias + act -> pw 1x1 + bias + act
    (pw_act=False: pw 1x1 + bias, linear; pw_epilogue=False: the raw pw
    1x1 accumulation in float32, no bias, no activation).

    x (N,H,W,Cin), dw_w (3,3,1,Cin), dw_b (Cin,), pw_w (Cin,Cout),
    pw_b (Cout,) -> (N,Ho,Wo,Cout), in x's dtype (float32 when not
    pw_epilogue). On CPU tensors this is the plain version; on CUDA tensors
    it launches the kernel or raises."""
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
        return separable_block_plain(x, dw_w, dw_b, pw_w, pw_b, stride, relu6, pw_act,
                                     pw_epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=x.dtype if pw_epilogue else torch.float32, device=x.device)
    epi = (EPI_BIAS_ACT if pw_act else EPI_BIAS) if pw_epilogue else EPI_RAW
    args = [x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
            pw_b.data_ptr(), out.data_ptr(), n, h, w, cin, cout, stride, int(relu6), epi]
    check_aligned(name, x, dw_w, dw_b, pw_w, pw_b)  # TMA, cp.async and 16-byte vectors
    args += plan_for(x, cin, cout, stride)
    code = getattr(lib, f"separable_block_{sfx}")(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    separable_block.launches += 1
    if not pw_epilogue:
        separable_block.partial_launches += 1  # the raw-partial mode's own count
    return out


separable_block.launches = 0
separable_block.partial_launches = 0
