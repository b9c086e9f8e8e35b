"""Fused MobileNet-V3 bottleneck: the CUDA kernel `csrc/v3_block.cu` and its
plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_ir_v3.py`
`v3_block_pallas`: expand (or the identity) + act -> depthwise k x k (k = 3
or 5, stride 1 or 2) + act -> [squeeze-excite gate] -> linear projection
[+ residual], in one call. On V3-Large it also runs blocks 0 and 1, which
the JAX package sends to its lane-packed kernels; MobileNet-V2's blocks
1-16 run it too (`ops/inverted_residual.py`: ReLU6, k 3, no SE). What
bounds it on the card and what the design does about it (a block with SE
runs two passes: the per-tile channel sums of the gate's pool, then the
gated block) is in the CUDA source's header. bf16 runs the Hopper tile of
`csrc/v3_wgmma.cuh` on the plan of `v3_wgmma_plan`, float32 the CUDA-core
tile of `csrc/v3_f32.cuh` on `v3_plan`; each picks the tile from the
shapes alone and is the fits-function: a shape with no plan raises at the
call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .conv import apply_act_named, dw_taps_f32, ieee_f32
from .head import ACTS
from .separable_block import H100_SMS, _sms, check_aligned, check_channels, check_kernel_args

BLOCK_ACTS = ("relu", "relu6", "hswish")

# -- the float32 kernel's plan (csrc/v3_f32.cuh) ------------------------------
KE = 32                 # expanded channels a chunk: a channel quad a consumer warp
LZ = KE + 4             # floats a pixel row of the expanded tile Z and of the A panel
MAX_TM = 256            # output pixels a unit (8 a lane of the depthwise)
MAX_NJ = 4              # projection channel quads a thread (16 accumulators each)
F32_CONSUMERS = 256     # 8 consumer warps (+ the producer warp)
SMEM_MAX = 232448       # the per-block shared-memory opt-in limit (227 KB)
# 227 KB less the 256 bytes the chain kernel keeps for a stage's shape, so that
# every plan also runs as a chain stage
V3F_SMEM_LIMIT = SMEM_MAX - 256
# (window slots, weight slots) in the order the plan takes the first that fits
V3F_RINGS = ((2, 3), (2, 2), (1, 3), (1, 2), (1, 1))
# The unit time model, in SM cycles (first estimates from the instruction
# counts of 8 consumer warps on 4 schedulers; a least-squares refit to
# `block_times --v2 --float32` and `--v3 --float32` on the card read ~2.4x
# more cycles but chose no faster tiles, so these rank the tiles; PERF.md):
# a 4-channel K step of an expansion round (each thread 64 fmaf, 8 float4
# loads), one tap of the depthwise's pixel slot (a float4 load, 4 fmaf), a
# 4-channel K step of one projection quad a thread, a chunk's barriers and
# waits, a unit's window wait, zeroing and epilogue, an SE unit's gate
# (cycles a product of its two FCs over the consumer threads); the bytes an
# SM streams from L2 a cycle (a chunk takes at least its stage's bytes at
# that rate, and both in turn with a single weight slot; a single window
# slot adds the window's); one block an SM (288 threads at up to 168
# registers: 9 warps put three on one scheduler).
EXP_STEP, DW_TAP, PRJ_STEP, CHUNK_FIXED, UNIT_FIXED, GATE_FMA = 200, 32, 150, 600, 3000, 4
L2_BYTES_PER_CYCLE = 24


class V3FPlan(NamedTuple):
    th: int     # output tile rows of one image
    tw: int     # output tile columns
    ws: int     # window ring slots
    bs: int     # weight ring slots (one 32-channel chunk of E each)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def v3f_quads(tm: int, cout: int) -> Tuple[int, int]:
    """The float32 projection's thread map for tm output pixels: (nj, cqt),
    the channel quads a thread and the thread columns (v3_f32.cuh
    make_geo): the fewest quads a thread that fit the pixel quads x thread
    columns in the 256 consumer threads."""
    pq, cq = -(-tm // 4), cout // 4
    nj = max(1, -(-pq * cq // F32_CONSUMERS))
    while nj < cq and pq * -(-cq // nj) > F32_CONSUMERS:
        nj += 1
    return nj, -(-cq // nj)


def v3_smem_bytes(th: int, tw: int, h: int, w: int, cin: int, e: int, cout: int, se: int,
                  k: int, stride: int, ws: int, bs: int, identity: bool = False) -> int:
    """Dynamic shared memory of a float32 plan (v3_f32.cuh make_geo; the C
    entry `v3_f32_smem_bytes` computes the same): the barriers (128 bytes),
    ws windows (the staged pixels, at most min(ph, h) x min(pw, w) of the
    (th-1)s+k x (tw-1)s+k window, the whole window for the identity, x Cin
    f32), bs stages (a 32-channel chunk's expand weight Cin x 32, projection
    weight 32 x Cout, depthwise weight k*k x 32 and two biases; with SE at
    least the projection weight and the tile's pre-gate rows, th*tw rounded
    up to 4 x 36 f32, of pass 2), the expanded tile Z (the window's pixels x
    36 f32; none for the identity), the A panel (th*tw rounded up to 4
    pixels x 36 f32), the expansion's K-split partials (`v3f_split`: kc - 1
    x its items x 16 f32), and with SE the gate (E f32) and hidden row (Se
    f32); each rounded up to 128 bytes."""
    ph, pw = (th - 1) * stride + k, (tw - 1) * stride + k
    wpix = ph * pw if identity else min(ph, h) * min(pw, w)
    dw_off = (0 if identity else cin * KE * 4) + KE * cout * 4
    stage = max(dw_off + k * k * KE * 4 + 2 * KE * 4,
                dw_off + 4 * -(-th * tw // 4) * LZ * 4 if se else 0)
    z = 0 if identity else _rup(ph * pw * LZ * 4, 128)
    kc, items = v3f_split(wpix, cin, identity)
    split = _rup((kc - 1) * items * 64, 128) if kc > 1 else 0
    gate = _rup(e * 4, 128) + _rup(se * 4, 128) if se else 0
    return (128 + ws * _rup(wpix * cin * 4, 128) + bs * _rup(stage, 128) + z
            + _rup(4 * -(-th * tw // 4) * LZ * 4, 128) + split + gate)


def v3f_split(wpix: int, cin: int, identity: bool) -> Tuple[int, int]:
    """The float32 expansion's K split for a window of at most wpix staged
    pixels (v3_f32.cuh make_geo): (kc, items), the thread groups that share
    Cin (2 where at most half the consumer threads have an item of 4 pixels
    x 4 channels, 4 where at most a quarter do and Cin >= 16) and the items
    at most."""
    items = -(-wpix // 4) * (KE // 4)
    if identity or items > F32_CONSUMERS // 2:
        return 1, items
    return (2 if items > F32_CONSUMERS // 4 or cin < 16 else 4), items


def _staged(n_out: int, t: int, s: int, k: int, pad: int, n_in: int) -> list:
    """The staged window extent along one side of each tile (t outputs a
    tile): the window's rows inside the input."""
    out = []
    for o0 in range(0, n_out, t):
        i0 = o0 * s - pad
        out.append(min((t - 1) * s + k, n_in - i0) - max(0, -i0))
    return out


def _v3f_unit_cycles(th: int, tw: int, h: int, w: int, cin: int, e: int, cout: int, k: int,
                     stride: int, se: int, identity: bool, ws: int, bs: int) -> float:
    """The time model's cycles of one unit (both passes of an SE block: the
    expansion, depthwise and pre-gate store, then the gated projection), on
    the average staged window of the block's tiles."""
    ho, wo = -(-h // stride), -(-w // stride)
    pad = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    ph, pw = (th - 1) * stride + k, (tw - 1) * stride + k
    if identity:
        pv = ph * pw
    else:
        rows, cols = _staged(ho, th, stride, k, pad, h), _staged(wo, tw, stride, k, pad, w)
        pv = sum(rows) * sum(cols) / (len(rows) * len(cols))
    tm = th * tw
    nj, _ = v3f_quads(tm, cout)
    kc, _ = v3f_split(ph * pw if identity else min(ph, h) * min(pw, w), cin, identity)
    expand = 0 if identity else (-(-(-(-int(pv) // 4) * 8) // F32_CONSUMERS) * (cin // 4) / kc
                                 * EXP_STEP + (kc > 1) * CHUNK_FIXED)
    dw = -(-tm // 32) * k * k * DW_TAP
    stage_bytes = (0 if identity else cin * KE * 4) + k * k * KE * 4
    win_bytes = (ph * pw if identity else pv) * cin * 4
    nec = -(-e // KE)
    prj = nj * (KE // 4) * PRJ_STEP
    # a block without SE, or SE pass 1 (which stores its pre-gate rows instead of projecting)
    per_chunk = expand + dw + CHUNK_FIXED + (-(-tm * 8 // F32_CONSUMERS) * DW_TAP if se else prj)
    # a chunk overlaps its stage's load with the previous chunk, but not with a single slot
    join = max if bs > 1 else (lambda a, b: a + b)
    per_chunk = join(per_chunk, (stage_bytes + (0 if se else KE * cout * 4)) / L2_BYTES_PER_CYCLE)
    cyc = UNIT_FIXED + nec * per_chunk
    if ws == 1:
        cyc += win_bytes / L2_BYTES_PER_CYCLE
    if se:  # pass 2: the gate, then the projection of the stages' pre-gate rows
        cyc += (UNIT_FIXED + 2 * e * se / F32_CONSUMERS * GATE_FMA
                + nec * join(prj, KE * (cout + tm) * 4 / L2_BYTES_PER_CYCLE))
    return cyc


@functools.lru_cache(maxsize=None)
def v3_plan(n: int, h: int, w: int, cin: int, e: int, cout: int, k: int, stride: int,
            se: int, identity: bool = False, sms: int = H100_SMS) -> Optional[V3FPlan]:
    """The float32 kernel's plan for a block on (n, h, w, cin) -> cout on a
    card of `sms` SMs, or None when the kernel takes no plan of it.
    Candidates: every output tile of th, tw <= 16 and th * tw <= MAX_TM
    whose projection fits MAX_NJ channel quads a thread; ring slots the
    first of V3F_RINGS that fits V3F_SMEM_LIMIT. The choice minimises waves
    (one block an SM) x the unit time model above (whose expansion counts
    the staged window, so a stride-2 tile pays for its 4x larger window);
    ties go to fewer units, then to the larger tile."""
    ok = (k in (3, 5) and stride in (1, 2) and min(n, h, w, cin, e, cout) > 0
          and cin % 8 == 0 and e % 8 == 0 and cout % 8 == 0 and (not identity or e == cin)
          and (stride == 1 or (h % 2 == 0 and w % 2 == 0)))
    if not ok:
        return None
    ho, wo = -(-h // stride), -(-w // stride)
    best = None
    for th in range(1, min(ho, 16) + 1):
        for tw in range(1, min(wo, 16) + 1):
            if th * tw > MAX_TM or v3f_quads(th * tw, cout)[0] > MAX_NJ:
                continue
            fit = next((f for f in V3F_RINGS if v3_smem_bytes(
                th, tw, h, w, cin, e, cout, se, k, stride, *f, identity) <= V3F_SMEM_LIMIT),
                None)
            if fit is None:
                continue
            units = n * -(-ho // th) * -(-wo // tw)
            cost = -(-units // sms) * _v3f_unit_cycles(th, tw, h, w, cin, e, cout, k, stride,
                                                        se, identity, *fit)
            key = (cost, units, -th * tw)
            if best is None or key < best[0]:
                best = (key, V3FPlan(th, tw, *fit))
    return None if best is None else best[1]


# -- the bf16 kernel's plan (csrc/v3_wgmma.cuh) ------------------------------
V3W_TM = 128            # output pixels a unit at most (two consumer warpgroups)
V3W_CONSUMERS = 256
V3W_CHUNK = 64          # channels a window chunk, an E chunk, a weight box's rows
V3W_MAX_CW = 184        # a part's columns: 128 or 64, then 32 + 16 + 8
# (window slots, weight slots) in the order the plan takes the first that fits
# (at least 2 weight slots: a chunk's stage is awaited while the last one is held)
V3W_RINGS = ((4, 4), (4, 3), (3, 3), (4, 2), (3, 2), (2, 4), (2, 3), (2, 2), (1, 4), (1, 3),
             (1, 2))
# 227 KB less the 256 bytes the chain kernel keeps for a stage's shape, so that
# every plan also runs as a chain stage
V3W_SMEM_LIMIT = 232448 - 256
# A unit's time model, in SM cycles (first estimates from the instruction
# counts, not fitted; `ir_tiles --model v3` times candidate tiles): a round
# of the two warpgroups' m64n64k16 expansion steps, a row block's wait and
# epilogue, one tap of every consumer thread's depthwise pixels, one
# projection column a 16-wide K step (both warpgroups), a chunk's barriers
# and waits, a unit's window wait and epilogue.
MM_STEP, EPI_MB, DW_TAP, PRJ_COL, CHUNK_FIXED, UNIT_FIXED = 64, 200, 40, 1.0, 400, 2000


class V3WPlan(NamedTuple):
    th: int     # output tile rows of one image
    tw: int     # output tile columns
    split: int  # output-channel parts a tile (Cout = split * cw)
    cw: int     # columns a part
    ws: int     # window ring slots (whole windows)
    bs: int     # weight ring slots (a chunk of E's expand and projection weights)


def v3_wgmma_smem_bytes(th: int, tw: int, cin: int, e: int, cout: int, k: int, stride: int,
                        cw: int, ws: int, bs: int, identity: bool) -> int:
    """Dynamic shared memory of a bf16 plan (v3_wgmma.cuh make_geo): 1 KB of
    alignment, 1 KB of barriers, the A panel (128 x 64 bf16), the expanded
    tile Z (MP rows of 64 bf16 padded to 144 bytes, MP the window's
    (th-1)s+k x (tw-1)s+k pixels rounded up to 64; none for the identity),
    bs weight stages (an 8 KB box
    a 64-chunk of Cin, 8 KB a 64-column and 1 KB an 8-column projection box,
    k*k x 64 depthwise weights, two 64-channel biases and 64 f32 gates,
    rounded up to 1 KB) and ws windows (MP x 64 bf16 a 64-chunk of Cin, then
    1 KB for the projection bias)."""
    ph, pw = (th - 1) * stride + k, (tw - 1) * stride + k
    mp = -(-ph * pw // 64) * 64
    nci = -(-cin // V3W_CHUNK)
    nbig = 2 if cw >= 128 else 1 if cw >= 64 else 0
    stage = (0 if identity else nci * 8192) + nbig * 8192 + (cw - 64 * nbig) // 8 * 1024
    stage = -(-(stage + k * k * 128 + 4 * 128) // 1024) * 1024
    z = 0 if identity else mp * 144
    return 1024 + 1024 + V3W_TM * 128 + z + bs * stage + ws * (nci * mp * 128 + 1024)


def _v3w_unit_cycles(th: int, tw: int, cin: int, e: int, k: int, stride: int,
                     identity: bool) -> Tuple[float, float]:
    """The time model's cycles of one unit: (those of pass 1, those a
    projection column adds in pass 2)."""
    mp = -(-((th - 1) * stride + k) * ((tw - 1) * stride + k) // 64) * 64
    steps = sum(-(-min(64, cin - 64 * c) // 16) for c in range(-(-cin // 64)))
    expand = 0 if identity else -(-mp // 128) * (steps * MM_STEP + EPI_MB)
    cyc, per_col = UNIT_FIXED, 0.0
    for c in range(-(-e // V3W_CHUNK)):
        live = min(V3W_CHUNK, e - V3W_CHUNK * c)
        cyc += expand + k * k * -(-th * tw * (live // 8) // V3W_CONSUMERS) * DW_TAP + CHUNK_FIXED
        per_col += -(-live // 16) * PRJ_COL
    return cyc, per_col


@functools.lru_cache(maxsize=None)
def v3_wgmma_plan(n: int, h: int, w: int, cin: int, e: int, cout: int, k: int, stride: int,
                  se: int, identity: bool, sms: int = H100_SMS) -> Optional[V3WPlan]:
    """The bf16 kernel's plan for a block on (n, h, w, cin) -> cout on a card
    of `sms` SMs, or None when the kernel takes no plan of it. Candidates:
    every tile of th x tw <= 128 outputs of one image (window sides within a
    TMA box, 256), every part width cw that divides Cout (a multiple of 8,
    at most V3W_MAX_CW); ring slots the first of V3W_RINGS that fits. The choice
    minimises waves (one block an SM) x the unit time model, pass 1 of an
    SE block included (no split there), a single window slot counting 1.1x;
    ties go to fewer units, then to fewer padded pixels past the image."""
    ok = (k in (3, 5) and stride in (1, 2) and min(n, h, w, cin, e, cout) > 0
          and cin % 8 == 0 and e % 8 == 0 and cout % 8 == 0 and (not identity or e == cin)
          and (stride == 1 or (h % 2 == 0 and w % 2 == 0)))
    if not ok:
        return None
    ho, wo = -(-h // stride), -(-w // stride)
    cws = [c for c in range(8, min(cout, V3W_MAX_CW) + 1, 8) if cout % c == 0]
    best = None
    for th in range(1, min(ho, V3W_TM) + 1):
        for tw in range(1, min(wo, V3W_TM // th) + 1):
            if (th - 1) * stride + k > 256 or (tw - 1) * stride + k > 256:
                continue
            tiles = n * -(-ho // th) * -(-wo // tw)
            cyc, per_col = _v3w_unit_cycles(th, tw, cin, e, k, stride, identity)
            pool = -(-tiles // sms) * cyc if se else 0.0
            for cw in cws:
                fit = next((f for f in V3W_RINGS if v3_wgmma_smem_bytes(
                    th, tw, cin, e, cout, k, stride, cw, *f, identity) <= V3W_SMEM_LIMIT),
                    None)
                if fit is None:
                    continue
                ws, bs = fit
                units = tiles * (cout // cw)
                cost = -(-units // sms) * (cyc + cw * per_col) + pool
                cost *= 1.1 if ws == 1 else 1.0
                # ties: fewer units, then fewer pixels of ragged tiles past the
                # image's edge (measured: 7x14 beats 9x14 at 14^2 by 3-13%)
                key = (cost, units, tiles * th * tw - n * ho * wo, -th * tw)
                if best is None or key < best[0]:
                    best = (key, V3WPlan(th, tw, cout // cw, cw, ws, bs))
    return None if best is None else best[1]


def block_weights(name: str, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se) -> list:
    """The block's weight tensors in kernel order, None left out; raises
    unless exp_w comes with exp_b and the four SE tensors all or none."""
    identity, has_se = exp_w is None, se[0] is not None
    if (exp_b is None) != identity or any((t is None) == has_se for t in se):
        raise ValueError(f"{name}: give exp_w with exp_b, and all four SE tensors or none")
    weights = ([] if identity else [exp_w, exp_b]) + [dw_w, dw_b, prj_w, prj_b]
    return weights + (list(se) if has_se else [])


def check_block(name: str, n: int, h: int, w: int, cin: int, exp_w, exp_b, dw_w, dw_b,
                prj_w, prj_b, se, *, k: int, stride: int, act: str, residual: bool,
                itemsize: int, sms: int = H100_SMS) -> Tuple[int, int, int, tuple]:
    """The kernel's checks of one bottleneck on an (n, h, w, cin) input
    (weights as `block_weights` gives them): weight shapes, k, stride, act,
    the residual, channel counts, and a plan on `sms` SMs: `v3_wgmma_plan`
    for bf16 (itemsize 2), `v3_plan` for float32. Returns (E, Cout, Se,
    plan); raises ValueError on what the kernel does not take."""
    se_w1, se_b1, se_w2, se_b2 = se
    e = cin if exp_w is None else int(exp_w.shape[-1])
    cout = int(prj_w.shape[-1])
    sem = 0 if se_w1 is None else int(se_w1.shape[-1])
    shapes_ok = (tuple(dw_w.shape) == (k, k, 1, e) and tuple(dw_b.shape) == (e,)
                 and tuple(prj_w.shape) == (e, cout) and tuple(prj_b.shape) == (cout,))
    if exp_w is not None:
        shapes_ok &= tuple(exp_w.shape) == (cin, e) and tuple(exp_b.shape) == (e,)
    if se_w1 is not None:
        shapes_ok &= (tuple(se_w1.shape) == (e, sem) and tuple(se_b1.shape) == (sem,)
                      and tuple(se_w2.shape) == (sem, e) and tuple(se_b2.shape) == (e,))
    if not shapes_ok:
        raise ValueError(f"{name}: weight shapes do not fit Cin={cin}, E={e}, k={k}")
    if k not in (3, 5) or stride not in (1, 2) or act not in BLOCK_ACTS:
        raise ValueError(f"{name}: k={k} stride={stride} act={act!r}: the kernel takes "
                         f"k 3 or 5, stride 1 or 2 and an act in {BLOCK_ACTS}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{name}: a residual needs stride 1 and Cin == Cout")
    check_channels(name, cin, e, cout)
    if se_w1 is not None and sem <= 0:
        raise ValueError(f"{name}: SE width {sem}")
    if itemsize == 2:
        plan, fits = v3_wgmma_plan(n, h, w, cin, e, cout, k, stride, sem, exp_w is None,
                                   sms), "v3_wgmma_plan"
    else:
        plan, fits = v3_plan(n, h, w, cin, e, cout, k, stride, sem, exp_w is None,
                             sms), "v3_plan"
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"E{e} k{k} s{stride} SE{sem} ({fits})")
    return e, cout, sem, plan


@ieee_f32
def v3_block_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, *, k: int, stride: int,
                   act: str, se_w1=None, se_b1=None, se_w2=None, se_b2=None,
                   residual: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 expansion + bias, act,
    rounded to x's dtype (exp_w None: the input itself); f32 taps (dy then
    dx) of the zero-padded expansion + bias, act, in f32; with SE the f32
    sum over the outputs x 1/(Ho*Wo) rounded to x's dtype, f32 product + b1,
    relu, rounded, f32 product + b2, clip(g + 3, 0, 6) * (1/6), the
    activation times that gate in f32; rounded; f32 projection + bias,
    rounded; then the residual added in x's dtype."""
    n, h, w, cin = x.shape
    z = x
    if exp_w is not None:
        z = apply_act_named(x.float().reshape(n * h * w, cin) @ exp_w.float() + exp_b.float(),
                            act).to(x.dtype).reshape(n, h, w, -1)
    y = apply_act_named(dw_taps_f32(z, dw_w, stride) + dw_b.float(), act)
    _, ho, wo, e = y.shape
    if se_w1 is not None:
        pooled = (y.sum(dim=(1, 2)) * (1.0 / (ho * wo))).to(x.dtype).float()
        g = (pooled @ se_w1.float() + se_b1.float()).clamp_min(0).to(x.dtype).float()
        g = g @ se_w2.float() + se_b2.float()
        y = y * ((g + 3.0).clamp(0, 6) * (1.0 / 6.0))[:, None, None, :]
    y = y.to(x.dtype).float().reshape(n * ho * wo, e)
    out = (y @ prj_w.float() + prj_b.float()).to(x.dtype).reshape(n, ho, wo, -1)
    return (out + x).to(x.dtype) if residual else out


def v3_block(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, *, k: int, stride: int, act: str,
             se_w1=None, se_b1=None, se_w2=None, se_b2=None,
             residual: bool = False) -> torch.Tensor:
    """One MobileNet-V3 bottleneck, `v3_block_pallas`'s signature.

    x (N,H,W,Cin); exp_w (Cin,E), exp_b (E,), or both None for the block
    with no expansion (the identity, no activation; E == Cin); dw_w
    (k,k,1,E), dw_b (E,); prj_w (E,Cout), prj_b (Cout,); SE weights
    se_w1 (E,Se), se_b1 (Se,), se_w2 (Se,E), se_b2 (E,), all given or all
    None; act in relu / relu6 / hswish -> (N,Ho,Wo,Cout). A residual needs
    stride 1 and Cin == Cout. On CPU tensors this is the plain version; on
    CUDA tensors it launches the kernel or raises."""
    name = "v3_block"
    se = (se_w1, se_b1, se_w2, se_b2)
    weights = block_weights(name, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se)
    sfx = check_kernel_args(name, x, *weights)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    sms = _sms(x.device.index or 0) if x.device.type == "cuda" else H100_SMS
    e, cout, sem, plan = check_block(name, n, h, w, cin, exp_w, exp_b, dw_w, dw_b, prj_w,
                                     prj_b, se, k=k, stride=stride, act=act,
                                     residual=residual, itemsize=x.element_size(), sms=sms)
    check_aligned(name, x, *weights)
    if x.device.type == "cpu":
        return v3_block_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, k=k, stride=stride,
                              act=act, se_w1=se_w1, se_b1=se_b1, se_w2=se_w2, se_b2=se_b2,
                              residual=residual)
    out = launch(name, sfx, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se, k=k, stride=stride,
                 act=act, residual=residual, e=e, cout=cout, sem=sem, plan=plan)
    v3_block.launches += 1
    return out


def launch(name: str, sfx: str, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se, *, k: int,
           stride: int, act: str, residual: bool, e: int, cout: int, sem: int,
           plan) -> torch.Tensor:
    """One launch of the kernel (`sfx` "bf16" or "f32") on a CUDA x, checked
    by `check_block` (which gave E, Cout, Se and `plan`) and `check_aligned`:
    the output, an SE block's scratch, the call. Counts nothing: each public
    wrapper counts its own launches."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    n, h, w, _ = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    partial = None
    if se[0] is not None:  # pass 1's per-tile channel sums, then (bf16) the images' gates
        tiles = -(-ho // plan[0]) * -(-wo // plan[1])  # or (float32) the pre-gate tensor
        partial = torch.empty((n * (tiles + (1 if sfx == "bf16" else ho * wo)) * e,),
                              dtype=torch.float32, device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    identity = exp_w is None
    code = getattr(lib, f"v3_block_{sfx}")(
        x.data_ptr(), ptr(exp_w), ptr(exp_b), dw_w.data_ptr(), dw_b.data_ptr(),
        prj_w.data_ptr(), prj_b.data_ptr(), *map(ptr, se), ptr(partial), out.data_ptr(),
        n, h, w, x.shape[-1], e, cout, sem, k, stride, ACTS["linear" if identity else act],
        ACTS[act], int(residual), int(identity), *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    return out


v3_block.launches = 0
