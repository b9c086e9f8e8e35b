"""Fused MobileNet-V3 bottleneck: the CUDA kernel `csrc/v3_block.cu` and its
plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_ir_v3.py`
`v3_block_pallas`: expand (or the identity) + act -> depthwise k x k (k = 3
or 5, stride 1 or 2) + act -> [squeeze-excite gate] -> linear projection
[+ residual], in one call. On V3-Large it also runs blocks 0 and 1, which
the JAX package sends to its lane-packed kernels. What bounds it on the card
and what the design does about it (a block with SE runs two launches: the
per-tile channel sums of the gate's pool, then the gated block) is in the
CUDA source's header. `v3_plan` picks the output tile from the shapes alone
and is the fits-function: a shape with no plan raises at the call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build
from .conv import apply_act_named, dw_taps_f32, ieee_f32
from .head import ACTS
from .inverted_residual import KE, _rup, plan_tile
from .separable_block import check_aligned, check_channels, check_kernel_args

BLOCK_ACTS = ("relu", "relu6", "hswish")
# The largest tile the plan takes, in outputs. The kernel's projection
# accumulators bound TM x Cout (MAX_FRAGS), not TM alone; V3's narrow
# blocks (Cout 16-40 at 112-28 squared) fit 256-output tiles, which load
# 4x fewer windows and weight slices than the V2 plan's 64 (`ir_tiles
# --model v3`, PERF.md).
MAX_OUTPUTS_V3 = 256


def v3_smem_bytes(th: int, tw: int, cin: int, e: int, cout: int, se: int, k: int,
                  stride: int, itemsize: int) -> int:
    """Dynamic shared memory of one tile (v3_block.cu make_shape): the input
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
    """The output tile (TH, TW) of a block on (n, h, w, cin) -> cout, or
    None when no tile fits: `ir_plan`'s search and time model
    (ops/inverted_residual.plan_tile) with this kernel's k x k window,
    shared memory and output cap."""
    if k not in (3, 5):
        return None
    return plan_tile(n, h, w, cin, cout, stride,
                     lambda th, tw: v3_smem_bytes(th, tw, cin, e, cout, se, k, stride,
                                                  itemsize), max_outputs=MAX_OUTPUTS_V3, k=k)


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
                itemsize: int) -> Tuple[int, int, int, Tuple[int, int]]:
    """The kernel's checks of one bottleneck on an (n, h, w, cin) input
    (weights as `block_weights` gives them): weight shapes, k, stride, act,
    the residual, channel counts, and a tile plan. Returns (E, Cout, Se,
    (TH, TW)); raises ValueError on what the kernel does not take."""
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
    plan = v3_plan(n, h, w, cin, e, cout, k, stride, sem, itemsize)
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"E{e} k{k} s{stride} SE{sem} (v3_plan)")
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
    identity = exp_w is None
    se = (se_w1, se_b1, se_w2, se_b2)
    has_se = se_w1 is not None
    weights = block_weights(name, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se)
    sfx = check_kernel_args(name, x, *weights)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    e, cout, sem, plan = check_block(name, n, h, w, cin, exp_w, exp_b, dw_w, dw_b, prj_w,
                                     prj_b, se, k=k, stride=stride, act=act,
                                     residual=residual, itemsize=x.element_size())
    check_aligned(name, x, *weights)
    if x.device.type == "cpu":
        return v3_block_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, k=k, stride=stride,
                              act=act, se_w1=se_w1, se_b1=se_b1, se_w2=se_w2, se_b2=se_b2,
                              residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    partial = None
    if has_se:  # pass 1's per-tile channel sums, read by pass 2
        tiles = -(-ho // plan[0]) * -(-wo // plan[1])
        partial = torch.empty((n * tiles * e,), dtype=torch.float32, device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    code = getattr(lib, f"v3_block_{sfx}")(
        x.data_ptr(), ptr(exp_w), ptr(exp_b), dw_w.data_ptr(), dw_b.data_ptr(),
        prj_w.data_ptr(), prj_b.data_ptr(), *map(ptr, se), ptr(partial), out.data_ptr(),
        n, h, w, cin, e, cout, sem, k, stride, ACTS["linear" if identity else act], ACTS[act],
        int(residual), int(identity), plan[0], plan[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    v3_block.launches += 1
    return out


v3_block.launches = 0
