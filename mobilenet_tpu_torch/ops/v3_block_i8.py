"""Fused int8 MobileNet-V3 bottleneck: the CUDA kernel `csrc/v3_block_i8.cu`
and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/quant/pallas_ir_v3_i8.py`
`v3_block_pallas_i8` (V3 blocks with an expansion: hswish, k 5, the
quantized squeeze-excite), `quant/pallas_block_packed_i8.py`
`packed_block_i8_named` (block 0: the identity expansion at stride 1),
`packed_block_i8_named_s2` (block 1, whose expansion the JAX package runs
as XLA ops before it) and `packed_block_i8_named_s2_se` (V3-Small's block 0:
the identity at stride 2 with the SE). Exact: equal, bit for bit, to the
plain version and to `quant/v3.py`'s oracle. What bounds it on the card and
what the design does about it is in the CUDA source's header; the kernel
runs the Hopper tile of `csrc/v3_i8_wgmma.cuh` on the plan of
`v3_i8_wgmma_plan`, which is the fits-function: a shape with no plan raises
at the call. A layer is a dict of device tensors
(`quant/v3.device_layer_v3`): "w" int8, "b" int32, "a" and "m" float32 per
output channel, and the float32 value "m6"; the kernel reads the weights in
its own forms ("wt", `v3_i8_kernel_weights`, made once at upload). The act
"relu6" is MobileNet-V2's ReLU6 requant (`quant/ops.requantize`) on V2's
layers (`quant/model.device_layer`: "m" and the float32 value "six_q", no
"a"): `ops/inverted_residual_i8.py` runs V2's blocks 1-16 on this kernel.
On the card the checks and the launch's arguments are made once per
distinct key of `_call_key` and kept (`launch_i8`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..quant import ops as qops
from . import _build
from .depthwise_i8 import check_i8_args
from .head import ACTS
from .separable_block import H100_SMS, _sms, check_aligned, check_channels, tensor_key

NAMED_ACTS = ("relu", "relu6", "hswish")

# -- the kernel's plan (csrc/v3_i8_wgmma.cuh) ----------------------------------
I8W_TM = 128            # output pixels a unit at most (64 a consumer warpgroup)
I8W_CHUNK = 128         # channels a window box, an E chunk, a swizzled row
I8W_ZROW = 144          # a pixel of the expanded tile Z (128 channels, padded)
I8W_VEC = 512           # a chunk of an int32 or f32 vector
I8W_PART = 1024         # a part's projection bias, then its multiplier (cw x 4 bytes each)
I8W_MAX_CW = 184        # a part's columns: 128 or 64, then 32 + 16 + 8
I8W_MAX_ROW_BLOCKS = 32  # the window's 64-row blocks (the expansion's pixel mask)
I8W_GATED_SLOTS = 4     # pass 2's ring
I8W_SMEM_LIMIT = 232448
K_ALIGN = 16            # TMA strides are multiples of 16 bytes: x's Cin and z's E padded to 16
# (window slots, weight slots) in the order the plan takes the first that fits
I8W_RINGS = ((4, 4), (4, 3), (3, 3), (4, 2), (3, 2), (2, 4), (2, 3), (2, 2), (1, 4), (1, 3),
             (1, 2))
FULL, POOL, GATED = 0, 1, 2  # the passes: no SE; SE pass 1; SE pass 2
# A unit's time model, in SM cycles (from thread 0's clock64 shares of the
# first tile, PERF.md §6): a 64-row block's k32 expansion step, its 64
# x 64 epilogue, one tap of a thread's 8-channel depthwise item, a chunk's
# barriers and waits, a unit's set-up and epilogue, one projection column a
# k32 step, a thread's 16-channel gated item of pass 2. Costs within TIE of
# the lowest tie with it (measured: at V2 1.0-224 b11, 14^2 x 96 E576, 7x14
# ran in 0.146 ms against 5x14's 0.183 at a model gap of 0.26%; `ir_tiles
# --model v2 --int8`), and ties go to fewer units; no V3 plan moves
# (tests/test_torch_v3_i8_wgmma.py pins them).
MM_STEP, EPI_HALF, DW_TAP, CHUNK_FIXED, UNIT_FIXED, PRJ_COL, GATE_ITEM = (
    300, 1500, 100, 600, 5000, 5.0, 600)
TIE = 0.003


class V3I8Plan(NamedTuple):
    th: int     # output tile rows of one image
    tw: int     # output tile columns
    split: int  # output-channel parts a tile (Cout = split * cw; pass 1 does not split)
    cw: int     # columns a part
    ws: int     # window ring slots (whole windows) of the full pass and pass 1
    bs: int     # weight ring slots (a chunk of E's weights) of the full pass and pass 1


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def _window(th: int, tw: int, k: int, stride: int):
    """(ph, pw, MP): the window's sides and its pixels rounded up to 64."""
    ph, pw = (th - 1) * stride + k, (tw - 1) * stride + k
    return ph, pw, _rup(ph * pw, 64)


def v3_i8_wgmma_smem_bytes(th: int, tw: int, cin: int, e: int, cout: int, k: int, stride: int,
                           cw: int, ws: int, bs: int, identity: bool, mode: int) -> int:
    """Dynamic shared memory of one pass of a plan (v3_i8_wgmma.cuh
    make_geo): 1 KB of alignment, 1 KB of barriers; the full pass and pass 1:
    the A panel (128 x 128 int8), Z (MP rows of 144 bytes, MP the window's
    (th-1)s+k x (tw-1)s+k pixels rounded up to 64; none for the identity), bs
    weight stages (a 16 KB expand box a 128-chunk of Cin, full only an 8 KB
    64-row and 1 KB 8-row projection box, the depthwise table's k*k/4 + 1
    rows and four vectors of 512 bytes, rounded up to 1 KB) and ws windows
    (MP x 128 bytes a 128-chunk of Cin; full: then 2 KB for the part's
    projection bias and multiplier); pass 2: four stages of a 16 KB z tile,
    the projection boxes, the gate and the part's 2 KB, rounded up to 1 KB."""
    nbig = 2 if cw >= 128 else 1 if cw >= 64 else 0
    prj = nbig * 8192 + (cw - 64 * nbig) // 8 * 1024
    if mode == GATED:
        return 1024 + 1024 + I8W_GATED_SLOTS * _rup(16384 + prj + I8W_VEC + 2 * I8W_PART,
                                                    1024)
    _, _, mp = _window(th, tw, k, stride)
    nci = -(-_rup(cin, K_ALIGN) // I8W_CHUNK)
    stage = ((0 if identity else nci * 16384) + (prj if mode == FULL else 0)
             + (k * k // 4 + 1) * I8W_VEC + 4 * I8W_VEC)
    z = 0 if identity else mp * I8W_ZROW
    part = 2 * I8W_PART if mode == FULL else 0
    return 1024 + 1024 + 16384 + z + bs * _rup(stage, 1024) + ws * (nci * mp * 128 + part)


def _unit_cycles(th, tw, cin, e, k, stride, identity):
    """The time model's cycles of one unit: (those of the expansion and the
    depthwise, those of pass 2's gating, k32 steps of the projection a
    column)."""
    _, _, mp = _window(th, tw, k, stride)
    cx = _rup(cin, K_ALIGN)
    ks = sum(-(-min(I8W_CHUNK, cx - I8W_CHUNK * c) // 32) for c in range(-(-cx // I8W_CHUNK)))
    blocks = -(-mp // 128)  # a warpgroup's 64-row blocks
    cyc, gate, steps = UNIT_FIXED, UNIT_FIXED, 0
    for c in range(-(-e // I8W_CHUNK)):
        live = min(I8W_CHUNK, e - I8W_CHUNK * c)
        expand = 0 if identity else blocks * -(-live // 64) * (ks * MM_STEP + EPI_HALF)
        items = -(-th * tw * (live // 8) // 256)
        cyc += expand + items * k * k * DW_TAP + CHUNK_FIXED
        gate += -(-min(64, th * tw) * -(-live // 16) // 128) * GATE_ITEM + CHUNK_FIXED
        steps += -(-live // 32)
    return cyc, gate, steps


@functools.lru_cache(maxsize=None)
def v3_i8_wgmma_plan(n: int, h: int, w: int, cin: int, e: int, cout: int, k: int, stride: int,
                     se: int, identity: bool, sms: int = H100_SMS) -> Optional[V3I8Plan]:
    """The kernel's plan for a block on (n, h, w, cin) -> cout on a card of
    `sms` SMs, or None when the kernel takes no plan of it. Candidates: every
    tile of th x tw <= 128 outputs of one image (window sides within a TMA
    box, 256; at most 32 64-row blocks), every part width cw that divides
    Cout (a multiple of 8, at most I8W_MAX_CW); ring slots the first of
    I8W_RINGS that fits the full pass (SE blocks: pass 1; pass 2's four
    stages always fit). The choice minimises waves (one block an SM) x the
    unit time model, summed over an SE block's two passes (pass 1 does not
    split Cout), a single window slot counting 1.1x; ties (costs within TIE
    of the lowest) go to fewer units, then to fewer padded pixels past the
    image, then to larger tiles."""
    ok = (k in (3, 5) and stride in (1, 2) and min(n, h, w, cin, e, cout) > 0
          and cin % 8 == 0 and e % 8 == 0 and cout % 8 == 0 and se % 4 == 0
          and (not identity or (e == cin and cin <= I8W_CHUNK))
          and (stride == 1 or (h % 2 == 0 and w % 2 == 0)))
    if not ok:
        return None
    ho, wo = -(-h // stride), -(-w // stride)
    cws = [c for c in range(8, min(cout, I8W_MAX_CW) + 1, 8) if cout % c == 0]
    mode = POOL if se else FULL
    cands = []
    for th in range(1, min(ho, I8W_TM) + 1):
        for tw in range(1, min(wo, I8W_TM // th) + 1):
            ph, pw, mp = _window(th, tw, k, stride)
            if ph > 256 or pw > 256 or mp > 64 * I8W_MAX_ROW_BLOCKS:
                continue
            tiles = n * -(-ho // th) * -(-wo // tw)
            cyc, gate, steps = _unit_cycles(th, tw, cin, e, k, stride, identity)
            for cw in cws:
                fit = next((f for f in I8W_RINGS if v3_i8_wgmma_smem_bytes(
                    th, tw, cin, e, cout, k, stride, cw, *f, identity, mode)
                    <= I8W_SMEM_LIMIT), None)
                if fit is None:
                    continue
                ws, bs = fit
                units = tiles * (cout // cw)
                if se:
                    cost = (-(-tiles // sms) * cyc * (1.1 if ws == 1 else 1.0)
                            + -(-units // sms) * (gate + cw * steps * PRJ_COL))
                else:
                    cost = -(-units // sms) * (cyc + cw * steps * PRJ_COL)
                    cost *= 1.1 if ws == 1 else 1.0
                cands.append(((units, tiles * th * tw - n * ho * wo, -th * tw, cost),
                              V3I8Plan(th, tw, cout // cw, cw, ws, bs)))
    if not cands:
        return None
    # the model resolves no finer than TIE: every candidate within TIE of the
    # lowest cost ties with it (a band around that one cost, so ties cannot
    # chain upward), and ties go by the rest of the key
    low = min(key[-1] for key, _ in cands)
    return min((c for c in cands if c[0][-1] <= low * (1 + TIE)), key=lambda c: c[0])[1]


def dw_table(dw_w: torch.Tensor) -> torch.Tensor:
    """The depthwise weight (k, k, 1, E) int8 as the kernel's dp4a table:
    (k*k//4 + 1, E) int32; row q < k*k//4 holds taps 4q..4q+3 of each channel
    in its bytes (tap 4q in the low byte), the last row the last tap in byte
    e % 4 of channel e's word (the other bytes zero)."""
    k, e = dw_w.shape[0], dw_w.shape[-1]
    taps = dw_w.reshape(k * k, e).to(torch.int64) & 0xFF
    rows = [sum(taps[4 * q + b] << (8 * b) for b in range(4)) for q in range(k * k // 4)]
    rows.append(taps[k * k - 1] << (torch.arange(e, device=dw_w.device) % 4 * 8))
    t = torch.stack(rows)
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32).contiguous()


def kernel_weights(exp, dw, prj) -> dict:
    """The weights in the forms the kernel reads: "exp" the K-major (E, Cx)
    copy of the expansion (Cx = Cin rounded up to 16, zero columns), "prj"
    the K-major (Cout, Ep) copy of the projection (Ep = E rounded up to 16),
    "dw" the depthwise table (`dw_table`); the layers' own "wt" where they
    hold one."""
    def pad_t(w, cols):  # w.t() with zero columns up to `cols`
        return F.pad(w.t(), (0, cols - w.shape[0])).contiguous()

    out = {"dw": dw["wt"] if "wt" in dw else dw_table(dw["w"])}
    e = int(dw["w"].shape[-1])
    out["prj"] = prj["wt"] if "wt" in prj else pad_t(prj["w"], _rup(e, K_ALIGN))
    if exp is not None:
        out["exp"] = (exp["wt"] if "wt" in exp
                      else pad_t(exp["w"], _rup(int(exp["w"].shape[0]), K_ALIGN)))
    return out


def v3_i8_kernel_weights(block: dict) -> dict:
    """Adds the kernel's weight forms (`kernel_weights`) to a block's layers
    as "wt", once, when the block goes to its device (quant/v3.to_device_i8_v3);
    returns the block."""
    for name, t in kernel_weights(block.get("exp"), block["dw"], block["prj"]).items():
        block[name]["wt"] = t
    return block


def requant_bound(layer: dict, act: str) -> float:
    """The kernel's per-layer requant operand (v3_i8_wgmma.cuh `requant`'s
    m6): hswish's m6; the upper bound of relu (127) and of relu6, float32
    min(six_q, 127), which gives V2's clamp(rint(clamp(v, 0, six_q)),
    -128, 127) bit for bit for any six_q."""
    if act == "hswish":
        return float(layer["m6"])
    return qops._f32(min(qops._f32(layer["six_q"]), 127.0)) if act == "relu6" else 127.0


def v3_block_i8_plain(x, exp, dw, prj, *, k: int, stride: int, act: str, se1=None,
                      se2=None, residual: bool = False) -> torch.Tensor:
    """The plain int8 ops in quant/v3.py's order: the expansion's named
    requant (exp None: the input itself), the k x k depthwise's int32 sum +
    bias and named requant, [the quantized SE], the linear requant of the
    projection, [the saturating residual add]. Integer products through
    float64 (quant/ops._int_matmul), exact."""
    z = x if exp is None else qops.pointwise_i8_named(x, exp, act)
    z = qops.requantize_named(qops.depthwise_acc_i8(z, dw["w"], stride) + dw["b"], dw, act)
    if se1 is not None:
        z = qops.se_i8(z, se1, se2)
    y = qops.pointwise_i8_named(z, prj, "linear")
    return qops.residual_add_i8(y, x) if residual else y


def v3_block_i8(x, exp, dw, prj, *, k: int, stride: int, act: str, se1=None, se2=None,
                residual: bool = False) -> torch.Tensor:
    """One int8 MobileNet-V3 bottleneck, `v3_block_pallas_i8`'s signature.

    x (N,H,W,Cin) int8; exp the expansion layer (w (Cin,E)) or None for
    the identity with no activation (E == Cin); dw the depthwise layer (w
    (k,k,1,E)); prj the projection (w (E,Cout)); se1 (w (E,Se)) and se2 (w
    (Se,E)) the SE layers, both or neither; act relu, relu6 or hswish ->
    (N,Ho,Wo,Cout) int8. A residual needs stride 1 and Cin == Cout. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel (`launch_i8`) or raises."""
    name = "v3_block_i8"
    opts = dict(k=k, stride=stride, act=act, residual=residual)
    if x.device.type == "cpu":
        check_block_i8(name, x, exp, dw, prj, se1, se2, **opts)
        return v3_block_i8_plain(x, exp, dw, prj, se1=se1, se2=se2, **opts)
    out = launch_i8(name, x, exp, dw, prj, se1, se2, **opts)
    v3_block_i8.launches += 1
    return out


def check_block_i8(name: str, x, exp, dw, prj, se1, se2, *, k: int, stride: int, act: str,
                   residual: bool) -> V3I8Plan:
    """The kernel's checks of one block (dtypes, devices, layer shapes, k,
    stride, act, the residual, channel counts) and its plan
    (`v3_i8_wgmma_plan`); raises ValueError on what the kernel does not
    take."""
    identity, has_se = exp is None, se1 is not None
    if (se2 is None) == has_se:
        raise ValueError(f"{name}: give both SE layers or neither")
    layers = ([] if identity else [exp]) + [dw, prj] + ([se1, se2] if has_se else [])
    factors = [(l[f], l["b"]) for l in layers for f in ("a", "m") if f in l]
    check_i8_args(name, x, [l["w"] for l in layers], [l["b"] for l in layers],
                  [f for f, _ in factors])
    n, h, w, cin = x.shape
    e = cin if identity else int(exp["w"].shape[-1])
    cout = int(prj["w"].shape[-1])
    sem = int(se1["w"].shape[-1]) if has_se else 0
    shapes = [(dw["w"], (k, k, 1, e)), (dw["b"], (e,)), (prj["w"], (e, cout)),
              (prj["b"], (cout,))]
    if not identity:
        shapes += [(exp["w"], (cin, e)), (exp["b"], (e,))]
    if has_se:
        shapes += [(se1["w"], (e, sem)), (se1["b"], (sem,)), (se2["w"], (sem, e)),
                   (se2["b"], (e,))]
    shapes += [(f, tuple(b.shape)) for f, b in factors]
    if any(tuple(t.shape) != want for t, want in shapes):
        raise ValueError(f"{name}: layer shapes do not fit Cin={cin}, E={e}, k={k}")
    if k not in (3, 5) or stride not in (1, 2) or act not in NAMED_ACTS:
        raise ValueError(f"{name}: k={k} stride={stride} act={act!r}: the kernel takes "
                         f"k 3 or 5, stride 1 or 2 and an act in {NAMED_ACTS}")
    need = {"hswish": ("a", "m6"), "relu6": ("m", "six_q")}.get(act, ("m",))
    if any(f not in l for l in layers[:2 - identity] for f in need):
        raise ValueError(f"{name}: the {act} requant reads each layer's {need}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{name}: a residual needs stride 1 and Cin == Cout")
    check_channels(name, cin, e, cout)
    if has_se and sem <= 0:
        raise ValueError(f"{name}: SE width {sem}")
    sms = _sms(x.device.index or 0) if x.device.type == "cuda" else H100_SMS
    plan = v3_i8_wgmma_plan(n, h, w, cin, e, cout, k, stride, sem, identity, sms)
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"E{e} k{k} s{stride} SE{sem} (v3_i8_wgmma_plan)")
    return plan


class _I8Call(NamedTuple):
    """What one launch needs beyond x's address and the buffers it makes,
    checked (`_prepare_i8`)."""
    cx: int                                # x's channels as the kernel reads them
    out_shape: Tuple[int, int, int, int]
    scratch: Tuple[int, int, int]          # SE: pooled, gate and z elements (0: none)
    weights: Tuple[int, ...]               # the 15 layer pointers after x, in the C order
    dims: tuple                            # N .. identity, the plan, the two bounds, 1/hw, 1/6
    prepared: Any = None                   # v3_block_i8_prepare's buffer (the card)


_CALLS: Dict[tuple, _I8Call] = {}
CALLS_KEPT = 256  # distinct (layers, input) pairs remembered; past it, start over
LAYER_KEYS = ("w", "b", "a", "m", "wt", "six_q", "m6")  # what the checks and launch read


def _call_key(x, layers, opts: tuple) -> tuple:
    """Everything `_prepare_i8` reads of x and the layers, values aside: the
    layers' tensors' addresses (the launch passes them), shapes, strides and
    dtypes and their scalars; x's shape, strides, dtype, device and 16-byte
    alignment (its address is an argument of each launch, so a new input of
    the same shape shares the key); the options. Two calls with equal keys
    launch with the same arguments but x's."""
    return (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16, opts, tuple(
        None if layer is None else tuple(
            tensor_key(v) if isinstance(v, torch.Tensor) else v
            for v in map(layer.get, LAYER_KEYS)) for layer in layers))


def _prepare_i8(name: str, x, exp, dw, prj, se1, se2, *, k: int, stride: int, act: str,
                residual: bool) -> _I8Call:
    """Every check of a launch (`check_block_i8`, then the layers' weight
    forms, which the kernel reads and which must be there: raises
    ValueError), then its arguments and buffer sizes."""
    plan = check_block_i8(name, x, exp, dw, prj, se1, se2, k=k, stride=stride, act=act,
                          residual=residual)
    identity, has_se = exp is None, se1 is not None
    n, h, w, cin = x.shape
    e = cin if identity else int(exp["w"].shape[-1])
    cout = int(prj["w"].shape[-1])
    sem = int(se1["w"].shape[-1]) if has_se else 0
    cx, ep = _rup(cin, K_ALIGN), _rup(e, K_ALIGN)
    want = {"dw": (k * k // 4 + 1, e), "prj": (cout, ep), "exp": (e, cx)}
    forms = {}
    for key, layer in (("exp", exp), ("dw", dw), ("prj", prj)):
        if layer is None:
            continue
        t = layer.get("wt")
        if t is None:
            raise ValueError(f"{name}: the {key} layer holds no kernel form \"wt\": the "
                             "kernel reads the forms made once at upload "
                             "(v3_i8_kernel_weights)")
        if tuple(t.shape) != want[key] or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: the {key} layer's kernel form {tuple(t.shape)} is not "
                             f"{want[key]} (v3_i8_kernel_weights)")
        forms[key] = t
    check_aligned(name, *forms.values())
    ho, wo = -(-h // stride), -(-w // stride)

    def lay(layer, key):  # 0 for a layer the block does not have
        return 0 if layer is None else layer[key].data_ptr()

    mult = "a" if act == "hswish" else "m"  # the named requant's per-channel factor
    weights = (0 if identity else forms["exp"].data_ptr(), lay(exp, "b"), lay(exp, mult),
               forms["dw"].data_ptr(), lay(dw, "b"), lay(dw, mult), forms["prj"].data_ptr(),
               lay(prj, "b"), lay(prj, "m"), lay(se1, "w"), lay(se1, "b"), lay(se1, "m"),
               lay(se2, "w"), lay(se2, "b"), lay(se2, "a"))
    dims = (n, h, w, cin, e, cout, sem, k, stride, ACTS["linear" if identity else act],
            ACTS[act], int(residual), int(identity), *plan,
            0.0 if identity else requant_bound(exp, act), requant_bound(dw, act),
            qops._f32(1.0 / (ho * wo)), qops._f32(1.0 / 6.0))
    scratch = (n * e, n * e, n * ho * wo * ep) if has_se else (0, 0, 0)
    return _I8Call(cx, (n, ho, wo, cout), scratch, weights, dims)


def launch_i8(name: str, x, exp, dw, prj, se1, se2, *, k: int, stride: int, act: str,
              residual: bool) -> torch.Tensor:
    """One launch of the kernel on a CUDA x: the checks and arguments of
    `_prepare_i8` and the kernel's own (`v3_block_i8_prepare`: each pass's
    geometry and weight maps), made once per distinct `_call_key` and kept
    (at most CALLS_KEPT), so that a forward that calls the kernel again on
    the same layers and input shape pays a key's worth of host work ahead of
    its launch; x's pad copy where Cin is not a multiple of 16; the SE
    scratch (its pre-gate tensor, channel sums and gates, living for the
    call); the call. Counts nothing: each public wrapper counts its own
    launches."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    key = _call_key(x, (exp, dw, prj, se1, se2), (k, stride, act, residual))
    call = _CALLS.get(key)
    if call is None:
        call = _prepare_i8(name, x, exp, dw, prj, se1, se2, k=k, stride=stride, act=act,
                           residual=residual)
        buf = ctypes.create_string_buffer(lib.v3_block_i8_prepared_bytes())
        _build.check(lib, lib.v3_block_i8_prepare(buf, *call.weights, *call.dims), name)
        call = call._replace(prepared=buf)
        if len(_CALLS) >= CALLS_KEPT:
            _CALLS.clear()
        _CALLS[key] = call
    if call.cx != x.shape[-1]:
        x = F.pad(x, (0, call.cx - x.shape[-1])).contiguous()
    out = torch.empty(call.out_shape, dtype=torch.int8, device=x.device)
    scratch = [0, 0, 0]
    if call.scratch[0]:
        bufs = [torch.empty((m,), dtype=dt, device=x.device) for m, dt in zip(
            call.scratch, (torch.int32, torch.float32, torch.int8))]
        scratch = [t.data_ptr() for t in bufs]
    code = lib.v3_block_i8_run(call.prepared, x.data_ptr(), *scratch, out.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    return out


v3_block_i8.launches = 0
