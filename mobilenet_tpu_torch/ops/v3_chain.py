"""A run of consecutive MobileNet-V3 bottlenecks in one launch: the CUDA
kernel `csrc/v3_chain.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_chain_v3.py`
`v3_chain_pallas`. The output equals `v3_block` called once per block in
sequence, bit for bit: every stage runs `v3_block.cu`'s tile code (bf16:
`csrc/v3_wgmma.cuh` on `v3_wgmma_plan`; float32: `csrc/v3_f32.cuh` on
`v3_plan`) on the plan that block alone has.
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
from .separable_block import H100_SMS, _sms, check_aligned, check_kernel_args, tensor_key
from .v3_block import (
    SMEM_MAX, block_weights, check_block, v3_block_plain, v3_plan, v3_smem_bytes, v3_wgmma_plan,
    v3_wgmma_smem_bytes,
)

MAX_STAGES = 15  # v3_chain.cu's parameter table: V3-Large's bottleneck count
SHAPE_BYTES = 256  # v3_chain.cu: the running stage's shape, ahead of the tile's smem
MAPS_BYTES = 1152  # v3_chain.cu: a bf16 stage's nine TMA tensor maps
SE_KEYS = ("se_w1", "se_b1", "se_w2", "se_b2")
TENSOR_KEYS = ("exp_w", "exp_b", "dw_w", "dw_b", "prj_w", "prj_b") + SE_KEYS  # the C table's order


def _stage_smem(n, h, w, cin, e, cout, k, stride, se, itemsize, identity=False,
                sms=H100_SMS) -> Optional[int]:
    """A stage's dynamic shared memory on the plan its block has alone, or
    None without a plan."""
    if itemsize == 2:
        p = v3_wgmma_plan(n, h, w, cin, e, cout, k, stride, se, identity, sms)
        return None if p is None else v3_wgmma_smem_bytes(
            p.th, p.tw, cin, e, cout, k, stride, p.cw, p.ws, p.bs, identity)
    p = v3_plan(n, h, w, cin, e, cout, k, stride, se, identity, sms)
    return None if p is None else v3_smem_bytes(p.th, p.tw, h, w, cin, e, cout, se, k, stride,
                                                p.ws, p.bs, identity)


def v3_chain_fits(n: int, h: int, w: int, shapes: Sequence[Tuple[int, ...]],
                  itemsize: int) -> bool:
    """True when the blocks `shapes` ((Cin, E, Cout, k, stride, Se) each, in
    order; expanded blocks) on an (n, h, w, Cin) input run as one chain
    launch: two blocks or more and at most MAX_STAGES, each block's Cin the
    previous block's Cout, and a plan for every block (`v3_wgmma_plan` in
    bf16, itemsize 2; else `v3_plan`) whose shared memory leaves room for
    the stage's shape (SHAPE_BYTES) within one block an SM. Then the
    cooperative grid is co-resident: the kernel caps it at what the
    occupancy query allows at the largest stage. No speed rule: which runs
    are worth a chain is the route's choice."""
    if not 2 <= len(shapes) <= MAX_STAGES:
        return False
    c = shapes[0][0]
    for cin, e, cout, k, stride, se in shapes:
        smem = None if cin != c else _stage_smem(n, h, w, cin, e, cout, k, stride, se, itemsize)
        if smem is None or smem + SHAPE_BYTES > SMEM_MAX:
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
    gate: int  # float32 elements of the images' SE gates (bf16; 0: none)
    ptrs: Any  # ctypes (void* x 10) per stage, TENSOR_KEYS order
    dims: Any  # ctypes (int x 14; bf16 x 16) per stage


_PLANS: Dict[tuple, _Plan] = {}
PLANS_KEPT = 64  # distinct (weights, input) pairs remembered; past it, start over


def _plan_key(x, blocks: Sequence[Dict[str, Any]]) -> tuple:
    """Everything that `_plan` reads of x and the blocks, values aside: the
    weights' addresses (the table holds them), shapes, strides and dtypes;
    x's shape, strides, dtype, device and 16-byte alignment (its address is
    an argument of each launch, so a new input of the same shape shares the
    key); the options. Two calls with equal keys launch with the same
    table."""
    return (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16, tuple(
        (b["k"], b["stride"], b["act"], b["residual"],
         *(tensor_key(b.get(key)) for key in TENSOR_KEYS)) for b in blocks))


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
    n, h, w, c = x.shape
    sms = _sms(x.device.index or 0) if x.device.type == "cuda" else H100_SMS
    dims, scratch, partial, gate = [], [0, 0], 0, 0
    for i, (b, se) in enumerate(zip(blocks, ses)):
        k, stride, act, residual = int(b["k"]), int(b["stride"]), b["act"], bool(b["residual"])
        identity = b.get("exp_w") is None
        e, cout, sem, plan = check_block(
            f"{name} block {i}", n, h, w, c, b.get("exp_w"), b.get("exp_b"), b["dw_w"],
            b["dw_b"], b["prj_w"], b["prj_b"], se, k=k, stride=stride, act=act,
            residual=residual, itemsize=x.element_size(), sms=sms)
        smem = _stage_smem(n, h, w, c, e, cout, k, stride, sem, x.element_size(), identity,
                           sms)
        if smem + SHAPE_BYTES > SMEM_MAX:
            raise ValueError(f"{name}: block {i}'s tile leaves no room for the stage's shape "
                             "in shared memory (v3_chain_fits)")
        ho, wo = -(-h // stride), -(-w // stride)
        dims += [c, e, cout, sem, k, stride, ACTS["linear" if identity else act], ACTS[act],
                 int(residual), int(identity), *plan]
        if sem:  # the SE pass's per-tile channel sums and gates (float32: the pre-gate
            # tensor after the sums), reused by every SE stage
            tiles = -(-ho // plan[0]) * -(-wo // plan[1])
            partial = max(partial, n * (tiles + (0 if sfx == "bf16" else ho * wo)) * e)
            gate = max(gate, n * e) if sfx == "bf16" else 0
        if i < len(blocks) - 1:
            scratch[i % 2] = max(scratch[i % 2], n * ho * wo * cout)
        h, w, c = ho, wo, cout
    check_aligned(name, x, *flat)
    ptrs = (ctypes.c_void_p * (len(TENSOR_KEYS) * len(blocks)))(*[
        0 if b.get(key) is None else b[key].data_ptr() for b in blocks for key in TENSOR_KEYS])
    return _Plan(sfx, (n, h, w, c), tuple(scratch), partial, gate, ptrs,
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
    scratch = [torch.empty((m,), dtype=x.dtype, device=x.device) if m else None
               for m in plan.scratch]
    part = (torch.empty((plan.partial + plan.gate,), dtype=torch.float32, device=x.device)
            if plan.partial else None)

    def ptr(t, offset=0):
        return 0 if t is None else t.data_ptr() + offset

    bufs = [ptr(t) for t in scratch]
    tables = (len(blocks), ctypes.addressof(plan.ptrs), ctypes.addressof(plan.dims))
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.sfx == "bf16":
        # the stages' TMA maps name this call's input and scratch buffers:
        # encoded into pinned memory, copied in stream order ahead of the launch
        host = torch.empty((len(blocks) * MAPS_BYTES,), dtype=torch.uint8, pin_memory=True)
        _build.check(lib, lib.v3_chain_bf16_maps(
            host.data_ptr(), x.data_ptr(), *bufs, ptr(part, 4 * plan.partial), *x.shape[:3],
            *tables), "v3_chain")
        maps = torch.empty_like(host, device=x.device).copy_(host, non_blocking=True)
        code = lib.v3_chain_bf16(
            x.data_ptr(), out.data_ptr(), *bufs, ptr(part), ptr(part, 4 * plan.partial),
            maps.data_ptr(), *x.shape[:3], *tables, ctypes.addressof(grid), stream)
    else:
        code = lib.v3_chain_f32(x.data_ptr(), out.data_ptr(), *bufs, ptr(part), *x.shape[:3],
                                *tables, ctypes.addressof(grid), stream)
    _build.check(lib, code, "v3_chain")
    v3_chain.launches += 1
    v3_chain.grid = grid.value
    return out


v3_chain.launches = 0
v3_chain.grid = 0
