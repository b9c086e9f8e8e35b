"""Fused MobileNet-V3 bottleneck: the CUDA kernel `csrc/v3_block.cu` and its
plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_ir_v3.py`
`v3_block_pallas`: expand (or the identity) + act -> depthwise k x k (k = 3
or 5, stride 1 or 2) + act -> [squeeze-excite gate] -> linear projection
[+ residual], in one call. On V3-Large it also runs blocks 0 and 1, which
the JAX package sends to its lane-packed kernels; MobileNet-V2's blocks
1-16 run it too (`ops/inverted_residual.py`: ReLU6, k 3, no SE). What
bounds it on the card and what the design does about it (a block with SE
runs two launches: the per-tile channel sums of the gate's pool, then the
gated block) is in the CUDA source's header. bf16 runs the Hopper tile of `csrc/v3_wgmma.cuh` on
the plan of `v3_wgmma_plan`, float32 the tile of `csrc/v3_tile.cuh` on
`v3_plan`; each picks the tile from the shapes alone and is the
fits-function: a shape with no plan raises at the call.
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

# -- the float32 kernel's plan (csrc/v3_tile.cuh) ----------------------------
KE = 32                 # expanded channels per chunk
MAX_FRAGS = 40          # (TMp / 16) * (CoutP / 16): projection accumulators
SMEM_MAX = 232448       # the per-block shared-memory opt-in limit (227 KB)
# Tiles whose shared memory fits this budget keep two blocks on an SM.
SMEM_PREFERRED = 113 * 1024
# The largest tile the float32 plan takes, in outputs. The projection
# accumulators bound TM x Cout (MAX_FRAGS), not TM alone; V3's narrow blocks
# (Cout 16-40 at 112-28 squared) fit 256-output tiles, which load 4x fewer
# windows and weight slices than 64-output ones (`ir_tiles --model v3`,
# PERF.md).
MAX_OUTPUTS_V3 = 256
# The tile plan's time model, fitted to per-tile timings of the V2 1.0-224
# blocks on an H100 at batch 1 and 256: a tile costs, per expanded-channel
# chunk, CHUNK_OVERHEAD plus its work (expanded window pixels x (Cin + 16)
# + output rows x (Cout + 16)), in one unit; the card runs about
# SLOTS_TWO_PER_SM of them at once when two fit on an SM (2 x 132 SMs at
# ~1.3x the latency of one), 132 when one does.
CHUNK_OVERHEAD = 33000
SLOTS_TWO_PER_SM, SLOTS_ONE_PER_SM = 200, 132


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def v3_smem_bytes(th: int, tw: int, cin: int, e: int, cout: int, se: int, k: int,
                  stride: int, itemsize: int) -> int:
    """Dynamic shared memory of one float32 tile (v3_tile.cuh make_shape; the
    arithmetic takes any itemsize): the input
    window ((TH-1)s+k by (TW-1)s+k pixels), then the chunk buffers (f32
    expanded tile, expand and projection weight slices, depthwise tile) or
    the f32 result tile, then with SE the f32 gate (E) and hidden row (Se)."""
    pp = _rup(((th - 1) * stride + k) * ((tw - 1) * stride + k), 16)
    cinp, coutp, tmp = _rup(cin, 16), _rup(cout, 16), _rup(th * tw, 16)
    xs = _rup(pp * (cinp + 8) * itemsize, 128)
    work = (_rup(pp * (KE + 4) * 4, 128) + _rup(cinp * (KE + 8) * itemsize, 128)
            + _rup(tmp * (KE + 8) * itemsize, 128) + _rup(KE * (coutp + 8) * itemsize, 128))
    gate = _rup(e * 4, 128) + _rup(se * 4, 128) if se else 0
    return xs + max(work, _rup(tmp * (coutp + 4) * 4, 128)) + gate


@functools.lru_cache(maxsize=None)
def v3_plan(n: int, h: int, w: int, cin: int, e: int, cout: int, k: int, stride: int,
            se: int, itemsize: int) -> Optional[Tuple[int, int]]:
    """The float32 kernel's output tile (TH, TW) of a block on (n, h, w,
    cin) -> cout, or None when no tile fits. Among tiles of at most
    MAX_OUTPUTS_V3 outputs (TH, TW <= 16) whose projection accumulators and
    shared memory fit, the one the time model above rates fastest: few
    large tiles when the batch fills the card (less halo recompute), many
    small ones when it does not (batch 1)."""
    if k not in (3, 5) or (stride == 2 and (h % 2 or w % 2)):
        return None
    ho, wo = -(-h // stride), -(-w // stride)
    cinp, coutp = _rup(cin, 16), _rup(cout, 16)
    best = None
    for th in range(1, min(ho, 16) + 1):
        for tw in range(1, min(wo, 16) + 1):
            tmp = _rup(th * tw, 16)
            if th * tw > MAX_OUTPUTS_V3 or (tmp // 16) * (coutp // 16) > MAX_FRAGS:
                continue
            smem = v3_smem_bytes(th, tw, cin, e, cout, se, k, stride, itemsize)
            if smem > SMEM_MAX:
                continue
            pp = _rup(((th - 1) * stride + k) * ((tw - 1) * stride + k), 16)
            blocks = n * -(-ho // th) * -(-wo // tw)
            slots = SLOTS_TWO_PER_SM if smem <= SMEM_PREFERRED else SLOTS_ONE_PER_SM
            cost = (max(1.0, blocks / slots)
                    * (CHUNK_OVERHEAD + pp * (cinp + 16) + tmp * (coutp + 16)))
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
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
    the residual, channel counts, and a plan: `v3_wgmma_plan` (on `sms` SMs)
    for bf16 (itemsize 2), `v3_plan`'s (TH, TW) for float32. Returns (E,
    Cout, Se, plan); raises ValueError on what the kernel does not take."""
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
        plan, fits = v3_plan(n, h, w, cin, e, cout, k, stride, sem, itemsize), "v3_plan"
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
    if se[0] is not None:  # pass 1's per-tile channel sums (bf16: then the images' gates)
        tiles = -(-ho // plan[0]) * -(-wo // plan[1])
        partial = torch.empty((n * (tiles + (sfx == "bf16")) * e,), dtype=torch.float32,
                              device=x.device)

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
