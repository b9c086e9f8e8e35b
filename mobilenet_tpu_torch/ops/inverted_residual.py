"""Fused inverted-residual block of MobileNet-V2: the CUDA kernel
`csrc/inverted_residual.cu` and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_ir_block.py`
`inverted_residual_pallas` (V2 blocks 2-16) and, at stride 2,
`ops/pallas_expand_s2.py` `expand_block_packed_s2` (V2 block 1, whose lane
packing and even-pixel `kron` selection were a TPU layout). What bounds it
on the card and what the design does about it is in the CUDA source's
header. The kernel takes one output tile of TH x TW pixels per thread
block; `ir_plan` picks the tile from the shapes alone and is the
fits-function: a shape with no plan raises at the call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build
from .conv import apply_activation, dw_taps_f32, ieee_f32
from .separable_block import check_aligned, check_channels, check_kernel_args

# Mirrors of inverted_residual.cu's constants.
KE = 32                 # expanded channels per chunk
MAX_FRAGS = 40          # (TMp / 16) * (CoutP / 16): projection accumulators
SMEM_MAX = 232448       # the per-block shared-memory opt-in limit (227 KB)
# Tiles whose shared memory fits this budget keep two blocks on an SM.
SMEM_PREFERRED = 113 * 1024
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


def ir_smem_bytes(th: int, tw: int, cin: int, cout: int, stride: int,
                  itemsize: int) -> int:
    """Dynamic shared memory of one tile (inverted_residual.cu make_shape):
    the input window, then the chunk buffers (f32 expanded tile, expand and
    projection weight slices, depthwise tile) or the f32 result tile."""
    pp = _rup(((th - 1) * stride + 3) * ((tw - 1) * stride + 3), 16)
    cinp, coutp, tmp = _rup(cin, 16), _rup(cout, 16), _rup(th * tw, 16)
    xs = _rup(pp * (cinp + 8) * itemsize, 128)
    work = (_rup(pp * (KE + 4) * 4, 128) + _rup(cinp * (KE + 8) * itemsize, 128)
            + _rup(tmp * (KE + 8) * itemsize, 128) + _rup(KE * (coutp + 8) * itemsize, 128))
    return xs + max(work, _rup(tmp * (coutp + 4) * 4, 128))


@functools.lru_cache(maxsize=None)
def ir_plan(n: int, h: int, w: int, cin: int, cout: int, stride: int,
            itemsize: int) -> Optional[Tuple[int, int]]:
    """The output tile (TH, TW) for a block on (n, h, w, cin) -> cout, or
    None when no tile fits. Among tiles of at most 64 outputs whose
    projection accumulators and shared memory fit, the one the time model
    above rates fastest: few large tiles when the batch fills the card
    (less halo recompute), many small ones when it does not (batch 1)."""
    return plan_tile(n, h, w, cin, cout, stride,
                     lambda th, tw: ir_smem_bytes(th, tw, cin, cout, stride, itemsize))


def plan_tile(n: int, h: int, w: int, cin: int, cout: int, stride: int, smem_bytes,
              max_outputs: int = 64, k: int = 3) -> Optional[Tuple[int, int]]:
    """`ir_plan`'s search, for any inverted-residual kernel with this
    one's tile loop: `smem_bytes(th, tw)` is the kernel's shared memory,
    `max_outputs` the largest tile it takes (TH, TW <= 16 either way), `k`
    the depthwise kernel's side (the input window of a tile)."""
    if stride == 2 and (h % 2 or w % 2):
        return None
    ho, wo = -(-h // stride), -(-w // stride)
    cinp, coutp = _rup(cin, 16), _rup(cout, 16)
    best = None
    for th in range(1, min(ho, 16) + 1):
        for tw in range(1, min(wo, 16) + 1):
            tmp = _rup(th * tw, 16)
            if th * tw > max_outputs or (tmp // 16) * (coutp // 16) > MAX_FRAGS:
                continue
            smem = smem_bytes(th, tw)
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


@ieee_f32
def inverted_residual_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride: int,
                            residual: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 expansion + bias in f32,
    ReLU6, rounded to x's dtype; f32 taps (dy then dx) of the zero-padded
    expansion + bias, ReLU6, rounded; f32 projection + bias, rounded; then
    the residual added in x's dtype."""
    n, h, w, cin = x.shape
    z = x.float().reshape(n * h * w, cin) @ exp_w.float() + exp_b.float()
    z = apply_activation(z, True).to(x.dtype).reshape(n, h, w, -1)
    z = apply_activation(dw_taps_f32(z, dw_w, stride) + dw_b.float(), True).to(x.dtype)
    _, ho, wo, e = z.shape
    y = (z.float().reshape(n * ho * wo, e) @ prj_w.float() + prj_b.float()).to(x.dtype)
    y = y.reshape(n, ho, wo, -1)
    return (y + x).to(x.dtype) if residual else y


def inverted_residual(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride: int,
                      residual: bool) -> torch.Tensor:
    """expand 1x1 + bias + ReLU6 -> dw 3x3 (TF-SAME, stride 1 or 2) + bias
    + ReLU6 -> linear projection 1x1 + bias [+ x].

    x (N,H,W,Cin), exp_w (Cin,E), exp_b (E,), dw_w (3,3,1,E), dw_b (E,),
    prj_w (E,Cout), prj_b (Cout,) -> (N,Ho,Wo,Cout); residual needs stride 1
    and Cin == Cout. On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel or raises."""
    name = "inverted_residual"
    sfx = check_kernel_args(name, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    e, cout = int(exp_w.shape[-1]), int(prj_w.shape[-1])
    if (tuple(exp_w.shape) != (cin, e) or tuple(exp_b.shape) != (e,)
            or tuple(dw_w.shape) != (3, 3, 1, e) or tuple(dw_b.shape) != (e,)
            or tuple(prj_w.shape) != (e, cout) or tuple(prj_b.shape) != (cout,)):
        raise ValueError(f"{name}: weight shapes {tuple(exp_w.shape)} {tuple(dw_w.shape)} "
                         f"{tuple(prj_w.shape)} do not fit Cin={cin}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{name}: a residual needs stride 1 and Cin == Cout")
    check_channels(name, cin, e, cout)
    check_aligned(name, x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b)
    plan = ir_plan(n, h, w, cin, cout, stride, x.element_size())
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"s{stride} (ir_plan)")
    if x.device.type == "cpu":
        return inverted_residual_plain(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, stride,
                                       residual)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout), dtype=x.dtype,
                      device=x.device)
    code = getattr(lib, f"inverted_residual_{sfx}")(
        x.data_ptr(), exp_w.data_ptr(), exp_b.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(),
        prj_w.data_ptr(), prj_b.data_ptr(), out.data_ptr(), n, h, w, cin, e, cout, stride,
        int(residual), plan[0], plan[1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    inverted_residual.launches += 1
    return out


inverted_residual.launches = 0
