"""A run of consecutive MobileNet-V3 bottlenecks in one launch: the CUDA
kernel `csrc/v3_chain.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_chain_v3.py`
`v3_chain_pallas`. The output equals `v3_block` called once per block in
sequence, bit for bit: every stage runs `v3_block.cu`'s tile code
(`csrc/v3_tile.cuh`) on the tile plan that `v3_plan` gives that block alone.
What bounds it on the card and what the design does about it (one
cooperative persistent grid, a grid barrier between stages and between an
SE stage's two passes, ping-pong scratch buffers) is in the CUDA source's
header.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .head import ACTS
from .inverted_residual import SMEM_MAX
from .separable_block import check_aligned, check_kernel_args
from .v3_block import block_weights, check_block, v3_block_plain, v3_plan, v3_smem_bytes

MAX_STAGES = 15  # v3_chain.cu's parameter table: V3-Large's bottleneck count
SHAPE_BYTES = 256  # v3_chain.cu: the running stage's shape, ahead of the tile's smem
SE_KEYS = ("se_w1", "se_b1", "se_w2", "se_b2")
TENSOR_KEYS = ("exp_w", "exp_b", "dw_w", "dw_b", "prj_w", "prj_b") + SE_KEYS  # the C table's order


def v3_chain_fits(n: int, h: int, w: int, shapes: Sequence[Tuple[int, ...]],
                  itemsize: int) -> bool:
    """True when the blocks `shapes` ((Cin, E, Cout, k, stride, Se) each, in
    order) on an (n, h, w, Cin) input run as one chain launch: two blocks or
    more and at most MAX_STAGES, each block's Cin the previous block's Cout,
    and a `v3_plan` for every block whose shared memory leaves room for the
    stage's shape (SHAPE_BYTES) within one block an SM. Then the cooperative
    grid is co-resident: the kernel caps it at what the occupancy query
    allows at the largest stage. No speed rule: which runs are worth a chain
    is the route's choice."""
    if not 2 <= len(shapes) <= MAX_STAGES:
        return False
    c = shapes[0][0]
    for cin, e, cout, k, stride, se in shapes:
        plan = None if cin != c else v3_plan(n, h, w, cin, e, cout, k, stride, se, itemsize)
        if plan is None or v3_smem_bytes(*plan, cin, e, cout, se, k, stride,
                                         itemsize) + SHAPE_BYTES > SMEM_MAX:
            return False
        h, w, c = -(-h // stride), -(-w // stride), cout
    return True


def v3_chain_plain(x, blocks: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """`v3_block_plain` on each block in sequence."""
    for b in blocks:
        x = v3_block_plain(x, b.get("exp_w"), b.get("exp_b"), b["dw_w"], b["dw_b"],
                           b["prj_w"], b["prj_b"], k=int(b["k"]), stride=int(b["stride"]),
                           act=b["act"], residual=bool(b["residual"]),
                           **{key: b.get(key) for key in SE_KEYS})
    return x


class _Plan(NamedTuple):
    """What one chain launch needs beyond the tensors' contents, checked."""

    sfx: str
    out_shape: Tuple[int, int, int, int]
    scratch: Tuple[int, int]  # elements of each ping-pong buffer (0: none)
    partial: int  # float32 elements of the SE channel sums (0: none)
    ptrs: Any  # ctypes (void* x 10) per stage, TENSOR_KEYS order
    dims: Any  # ctypes (int x 12) per stage


_PLANS: Dict[tuple, _Plan] = {}
PLANS_KEPT = 64  # distinct (weights, input) pairs remembered; past it, start over


def _tensor_key(t) -> Optional[tuple]:
    # the address also names the device: CUDA's unified addressing gives
    # host and device memory disjoint ranges
    return None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype)


def _plan_key(x, blocks: Sequence[Dict[str, Any]]) -> tuple:
    """Everything that `_plan` reads of x and the blocks, values aside: the
    weights' addresses (the table holds them), shapes, strides and dtypes;
    x's shape, strides, dtype, device and 16-byte alignment (its address is
    an argument of each launch, so a new input of the same shape shares the
    key); the options. Two calls with equal keys launch with the same
    table."""
    return (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16, tuple(
        (b["k"], b["stride"], b["act"], b["residual"],
         *(_tensor_key(b.get(key)) for key in TENSOR_KEYS)) for b in blocks))


def _plan(x, blocks: Sequence[Dict[str, Any]]) -> _Plan:
    """Every check of `v3_chain` (raising ValueError), then the launch's
    dims and pointer tables and its buffer sizes."""
    name = "v3_chain"
    if not 2 <= len(blocks) <= MAX_STAGES:
        raise ValueError(f"{name}: a chain takes 2 to {MAX_STAGES} blocks, got {len(blocks)}")
    weights, ses = [], []
    for b in blocks:
        ses.append(tuple(b.get(key) for key in SE_KEYS))
        weights.append(block_weights(name, b.get("exp_w"), b.get("exp_b"), b["dw_w"],
                                     b["dw_b"], b["prj_w"], b["prj_b"], ses[-1]))
    flat = [t for ws in weights for t in ws]
    sfx = check_kernel_args(name, x, *flat)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h0, w0, c = x.shape
    h, w = h0, w0
    dims, shapes, scratch, partial = [], [], [0, 0], 0
    for i, (b, se) in enumerate(zip(blocks, ses)):
        k, stride, act, residual = int(b["k"]), int(b["stride"]), b["act"], bool(b["residual"])
        e, cout, sem, (th, tw) = check_block(
            f"{name} block {i}", n, h, w, c, b.get("exp_w"), b.get("exp_b"), b["dw_w"],
            b["dw_b"], b["prj_w"], b["prj_b"], se, k=k, stride=stride, act=act,
            residual=residual, itemsize=x.element_size())
        identity = b.get("exp_w") is None
        ho, wo = -(-h // stride), -(-w // stride)
        dims += [c, e, cout, sem, k, stride, ACTS["linear" if identity else act], ACTS[act],
                 int(residual), int(identity), th, tw]
        shapes.append((c, e, cout, k, stride, sem))
        if sem:  # the SE pass's per-tile channel sums, reused by every SE stage
            partial = max(partial, n * -(-ho // th) * -(-wo // tw) * e)
        if i < len(blocks) - 1:
            scratch[i % 2] = max(scratch[i % 2], n * ho * wo * cout)
        h, w, c = ho, wo, cout
    if not v3_chain_fits(n, h0, w0, shapes, x.element_size()):
        raise ValueError(f"{name}: a stage's tile leaves no room for the stage's shape in "
                         "shared memory (v3_chain_fits)")
    check_aligned(name, x, *flat)
    ptrs = (ctypes.c_void_p * (len(TENSOR_KEYS) * len(blocks)))(*[
        0 if b.get(key) is None else b[key].data_ptr() for b in blocks for key in TENSOR_KEYS])
    return _Plan(sfx, (n, h, w, c), tuple(scratch), partial, ptrs,
                 (ctypes.c_int * len(dims))(*dims))


def v3_chain(x, blocks: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """Two or more consecutive V3 bottlenecks in one launch,
    `v3_chain_pallas`'s signature.

    x (N,H,W,Cin); blocks: dicts of `v3_block`'s tensors (exp_w/exp_b, or
    neither for the identity expansion; dw_w/dw_b/prj_w/prj_b; the four SE
    tensors or none) and its options `k`, `stride`, `act`, `residual`. Each
    block's Cin is the previous block's Cout. On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel or raises.

    The checks and the launch's tables are made once per distinct key of
    `_plan_key` and kept (at most PLANS_KEPT): a forward that calls the
    chain again on the same weights and input shape pays a key's worth of
    host work ahead of its launch. `v3_chain.grid` is the last launch's
    block count."""
    key = _plan_key(x, blocks)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _plan(x, blocks)
        if len(_PLANS) >= PLANS_KEPT:
            _PLANS.clear()
        _PLANS[key] = plan
    if x.device.type == "cpu":
        return v3_chain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"v3_chain: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device)
    # Stage k writes scratch[k % 2], each sized for the largest activation it
    # holds: V3-Large b1-b14 at batch 256 in bf16 takes b01's and b02's
    # outputs, 38.5 MB each, small beside the card's 80 GB.
    bufs = [torch.empty((m,), dtype=x.dtype, device=x.device) if m else None
            for m in plan.scratch]
    part = (torch.empty((plan.partial,), dtype=torch.float32, device=x.device)
            if plan.partial else None)
    grid = ctypes.c_int(0)
    code = getattr(lib, f"v3_chain_{plan.sfx}")(
        x.data_ptr(), out.data_ptr(), *(0 if t is None else t.data_ptr() for t in bufs),
        0 if part is None else part.data_ptr(), *x.shape[:3], len(blocks),
        ctypes.addressof(plan.ptrs), ctypes.addressof(plan.dims), ctypes.addressof(grid),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "v3_chain")
    v3_chain.launches += 1
    v3_chain.grid = grid.value
    return out


v3_chain.launches = 0
v3_chain.grid = 0
