"""Fused classifier head, [conv_last 1x1 + act] -> pool -> 0-2 matmuls
each + act: the CUDA kernels of `csrc/fused_head.cu` (bf16 on the Hopper
kernels of `csrc/head_wgmma.cuh`, planned by `head_plan`) and their plain
PyTorch version.

Replaces every form of the TPU kernel `mobilenet_tpu/ops/pallas_head.py`
`fused_head`: V1's pool+fc, V2's conv_last + ReLU6 -> pool -> fc, and
V3-Large's and V3-Small's conv_last + hswish -> pool -> head matmul + hswish
-> fc. The conv_last output never reaches device memory: its stage writes
only the pooled (N, E) rows. bf16 launches one kernel a stage (V1 pool, post:
2; V2 conv_walk, post: 2; V3 conv_walk, post, post: 3), float32 two at most
(conv_pool, then the post stage). A post weight whose width is not a
multiple of 8 (or whose rows do not follow the previous stage's padded
width, or whose data is not 16-byte aligned) is copied into a zero-padded
one for the bf16 kernel's TMA maps; no model's head has one. The bf16
conv_last takes at most 1600 input channels (its resident weight slice);
float32 takes any width whose rows fit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .conv import ieee_f32
from .separable_block import H100_SMS, _sms, check_aligned, check_channels, check_kernel_args

# The kernels' activation codes (numerics.cuh enum Act): fused_head, v3_block.
ACTS = {"linear": 0, "relu": 1, "relu6": 2, "hswish": 3}
MAX_POST = 2
HB = 2                  # float32: images per head_post_kernel block
SMEM_MAX = 232448       # the per-block shared-memory opt-in limit (227 KB)

# -- the bf16 kernels' plan (csrc/head_wgmma.cuh) -------------------------------
KCH = 64                # K a chunk (one 128-byte A row)
TM = TN = 64            # rows of a tile; columns of a warpgroup's tile
CHUNK_BYTES = 64 * 64 * 2
MAX_POST_STAGES = 8     # post: slots of its A + W ring, a part's chunks at most
MAX_CONV_STAGES = 16    # conv_walk: slots of its A ring, two tiles' chunks where they fit
RED_LD = TN + 4         # post: floats a row of the f32 partial tile
STAGE_LD = TN // 2 + 4  # conv_walk: 32-bit words a row of a staging tile
MAX_KPARTS = 8          # post: K parts a tile, one thread-block cluster
MIN_BLOCKS = 128        # post: blocks a launch puts on the card, where K allows
SMEM_SM = 233472        # shared memory an SM holds (228 KB); a block also takes 1 KB
CONV_NWG2_MIN_N = 16    # conv_walk: two warpgroups (128 columns) from this batch up


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def f32_post_smem_bytes(c: int, conv: Optional[Tuple], post: Sequence[Tuple]) -> int:
    """Dynamic shared memory of the float32 post stage (fused_head.cu
    head_post_kernel): two f32 rows of the widest pooled/post width per
    image. The float32 conv_last stage uses a fixed static tile."""
    e = int(conv[0].shape[1]) if conv is not None else c
    maxw = max([e] + [int(w.shape[1]) for w, _, _ in post])
    return _rup(2 * HB * maxw * 4, 128)


def head_smem_bytes(kind: int, c: int, nwg: int, stages: int) -> int:
    """Dynamic shared memory of a bf16 kernel (head_wgmma.cuh; the C entry
    `head_smem_bytes` computes the same): kind 0 conv_walk_kernel on C input
    channels with nwg warpgroups and an A ring of `stages` chunks (1 KB of
    alignment, the resident weight slice: a 64 x 64 box a chunk of C and a
    warpgroup, the ring, a 64-row staging tile a warpgroup, the ring's and
    the weight's barriers); kind 1 post_kernel with a ring of `stages` (A
    and W boxes; the f32 partial tile, the tile's f32 bias, the barriers).
    pool_kernel uses a static 8 KB slab."""
    if kind == 0:
        return (1024 + _cdiv(c, KCH) * nwg * CHUNK_BYTES + stages * CHUNK_BYTES
                + nwg * TM * STAGE_LD * 4 + 8 * (2 * stages + 1))
    return 1024 + stages * 2 * CHUNK_BYTES + TM * RED_LD * 4 + TN * 4 + 8 * 2 * stages


class ConvPlan(NamedTuple):
    nwg: int      # consumer warpgroups, 64 columns each
    slices: int   # column slices of E: cdiv(E, 64 nwg)
    groups: int   # image groups (grid y)
    gimg: int     # images a group: cdiv(N, groups), as the kernel computes it
    stages: int   # A ring slots (64 x 64 chunks)
    per_sm: int   # blocks an SM holds
    smem: int
    eager: bool   # fewer slots than C's chunks: each chunk's slot freed as it is done


class PostPlan(NamedTuple):
    k: int        # W's rows
    m: int        # W's width (a multiple of 8)
    kparts: int   # K parts a tile: the cluster's size
    ti: int       # 64-row tiles
    tj: int       # 64-column tiles
    nch: int      # 64-row chunks of K
    blocks: int   # ti x tj x kparts
    stages: int   # ring slots


class HeadPlan(NamedTuple):
    conv: Optional[ConvPlan]
    ld: int       # the pooled rows' pitch: E, or C rounded up to 8
    posts: Tuple[PostPlan, ...]


def conv_eager(c: int, stages: int) -> bool:
    """Whether conv_walk_kernel runs its eager ring protocol (head_wgmma.cuh
    conv_eager): a ring of fewer slots than C's 64-channel chunks cannot
    hold a tile's chunks until its products are done, so each chunk's slot
    is freed as soon as its own are."""
    return stages < _cdiv(c, KCH)


@functools.lru_cache(maxsize=None)
def _conv_stages(c: int, nwg: int, tiles: int = 2) -> int:
    """The most A ring slots up to `tiles` tiles' chunks (two: the next tile
    loads while this one computes) that fit beside the weight slice; 0 if
    not even two fit."""
    nch = _cdiv(c, KCH)
    for stages in range(min(max(2, tiles * nch), MAX_CONV_STAGES), 1, -1):
        if head_smem_bytes(0, c, nwg, stages) <= SMEM_MAX:
            return stages
    return 0


def conv_plan(n: int, c: int, e: int, sms: int = H100_SMS) -> ConvPlan:
    """conv_walk_kernel's plan: from batch 16 up two warpgroups (128-column
    slices) where they fit and an A ring of up to two tiles' chunks
    (`_conv_stages`); below, one warpgroup (64 columns: more blocks) and a
    ring of one tile's chunks (a block walks one or two images, and a
    smaller block lets two share an SM); image groups so that slices x
    groups fill one wave of the card. Raises where even one warpgroup's
    weight slice and a two-slot ring do not fit."""
    big = n >= CONV_NWG2_MIN_N
    nwg = 2 if big and _conv_stages(c, 2) else 1
    stages = _conv_stages(c, nwg, 2 if big else 1)
    if not stages:
        smem = head_smem_bytes(0, c, nwg, 2)
        raise ValueError(f"head_plan: conv_last's {c} input channels need {smem} bytes of "
                         f"shared memory, above {SMEM_MAX}")
    smem = head_smem_bytes(0, c, nwg, stages)
    slices = _cdiv(e, TN * nwg)
    per_sm = min(SMEM_SM // (smem + 1024), 2048 // (128 * nwg + 32))
    gimg = _cdiv(n, max(1, min(n, sms * per_sm // slices)))
    groups = _cdiv(n, gimg)
    return ConvPlan(nwg, slices, groups, _cdiv(n, groups), stages, per_sm, smem,
                    conv_eager(c, stages))


def post_plan(n: int, k: int, m: int, sms: int = H100_SMS) -> PostPlan:
    """post_kernel's plan for (n, k) @ (k, m): 64 x 64 output tiles, and K
    split into the fewest parts (at most 8, one a 64-row chunk at least)
    that put MIN_BLOCKS blocks on the card; a ring as deep as a part's
    chunks (at most 8), shallower where the blocks would not all fit the
    card at once otherwise."""
    nch, ti, tj = _cdiv(k, KCH), _cdiv(n, TM), _cdiv(m, TN)
    kparts = max(1, min(MAX_KPARTS, nch, _cdiv(MIN_BLOCKS, ti * tj)))
    blocks = ti * tj * kparts
    stages = min(MAX_POST_STAGES, _cdiv(nch, kparts))
    while stages > 2 and _cdiv(blocks, sms) * (head_smem_bytes(1, 0, 0, stages) + 1024) > SMEM_SM:
        stages -= 1
    return PostPlan(k, m, kparts, ti, tj, nch, blocks, stages)


@functools.lru_cache(maxsize=None)
def head_plan(n: int, c: int, e: Optional[int], widths: Tuple[int, ...],
              sms: int = H100_SMS) -> HeadPlan:
    """The bf16 kernels' plan for n images of c channels (any number of
    pixels), conv_last c -> e (None: none) and post weights of `widths`
    (each a multiple of 8: the wrapper pads the others)."""
    conv = conv_plan(n, c, e, sms) if e else None
    ld = e if e else _rup(c, 8)
    posts, k = [], e if e else c
    for m in widths:
        posts.append(post_plan(n, k, m, sms))
        k = m
    return HeadPlan(conv, ld, tuple(posts))


def head_fits(c: int, conv: Optional[Tuple], post: Sequence[Tuple]) -> bool:
    """True when the kernels take this form: 0-2 post matmuls, known
    activations, and the float32 post stage's rows within the shared-memory
    limit. bf16 with a conv_last also needs `bf16_conv_fits`."""
    acts = ([conv[2]] if conv is not None else []) + [a for _, _, a in post]
    return (len(post) <= MAX_POST and all(a in ACTS for a in acts)
            and f32_post_smem_bytes(c, conv, post) <= SMEM_MAX)


def bf16_conv_fits(c: int) -> bool:
    """True when the bf16 conv_walk_kernel takes a conv_last of c input
    channels: one warpgroup's resident weight slice (c x 64) and a two-slot
    ring within the shared-memory limit (c <= 1600)."""
    return _conv_stages(c, 1) > 0


def head_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """pallas_head.py `_kact`, in float32."""
    if act == "linear":
        return y
    if act == "relu":
        return y.clamp_min(0)
    if act == "relu6":
        return y.clamp(0, 6)
    if act == "hswish":
        return y * ((y + 3.0).clamp(0, 6) * (1.0 / 6.0))
    raise ValueError(f"unknown activation {act!r}")


@ieee_f32
def fused_head_plain(x, conv: Optional[Tuple], post: Sequence[Tuple]) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: [f32 conv_last + bias, act,
    cast], f32 mean over H*W cast to x's dtype, then each post: f32 product
    + bias, act, cast."""
    n, h, w, c = x.shape
    y = x
    if conv is not None:
        cw, cb, act = conv
        y = head_act(x.float().reshape(n * h * w, c) @ cw.float() + cb.float(), act)
        y = y.to(x.dtype).reshape(n, h, w, -1)
    y = y.float().mean(dim=(1, 2)).to(x.dtype)
    for pw, pb, act in post:
        y = head_act(y.float() @ pw.float() + pb.float(), act).to(x.dtype)
    return y


def fused_head(x, conv: Optional[Tuple], post: Sequence[Tuple]) -> torch.Tensor:
    """[conv_last] -> pool -> post-matmul chain, the JAX entry point's
    signature. x (N,H,W,C); conv: (w (C,E), b (E,), act) or None; post:
    [(w (K,M), b (M,), act), ...] with 0-2 entries -> (N, last width).
    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel or raises."""
    name = "fused_head"
    if len(post) > MAX_POST:
        raise NotImplementedError(f"{name}: {len(post)} post matmuls; the kernel "
                                  f"takes 0-{MAX_POST}")
    weights = [t for layer in ([conv] if conv is not None else []) + list(post)
               for t in layer[:2]]
    sfx = check_kernel_args(name, x, *weights)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    k = c
    for cw, cb, act in ([conv] if conv is not None else []) + list(post):
        m = int(cw.shape[-1])
        if tuple(cw.shape) != (k, m) or tuple(cb.shape) != (m,):
            raise ValueError(f"{name}: weight {tuple(cw.shape)} / bias {tuple(cb.shape)} "
                             f"do not follow width {k}")
        if act not in ACTS:
            raise ValueError(f"{name}: unknown activation {act!r}")
        k = m
    if conv is not None:  # the conv_last stage moves rows as 16-byte vectors
        check_channels(name, c, int(conv[0].shape[1]))
        check_aligned(name, x, conv[0], conv[1])
    if not head_fits(c, conv, post):
        raise ValueError(f"{name}: rows of width {k} exceed the kernel's shared memory")
    if sfx == "bf16" and conv is not None and not bf16_conv_fits(c):
        raise ValueError(f"{name}: the bf16 conv_last's weight slice of {c} input channels "
                         f"exceeds the kernel's shared memory")
    if x.device.type == "cpu":
        return fused_head_plain(x, conv, post)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    if sfx == "bf16":
        out = _launch_bf16(lib, x, conv, post, k, _sms(x.device.index or 0),
                           torch.cuda.current_stream(x.device).cuda_stream)
        fused_head.launches += 1
        return out
    out = torch.empty((n, k), dtype=x.dtype, device=x.device)
    e = int(conv[0].shape[1]) if conv is not None else c
    # the conv_last stage's pooled (N, E) rows, read by the post stage
    pooled = None if conv is None else torch.empty((n, e), dtype=x.dtype, device=x.device)
    ptrs = [0, 0] if conv is None else [conv[0].data_ptr(), conv[1].data_ptr()]
    dims = []
    for j in range(MAX_POST):
        if j < len(post):
            ptrs += [post[j][0].data_ptr(), post[j][1].data_ptr()]
            dims += [int(post[j][0].shape[1]), ACTS[post[j][2]]]
        else:
            ptrs += [0, 0]
            dims += [0, 0]
    code = getattr(lib, f"fused_head_{sfx}")(
        x.data_ptr(), *ptrs, 0 if pooled is None else pooled.data_ptr(), out.data_ptr(),
        n, h * w, c, e,
        -1 if conv is None else ACTS[conv[2]], len(post), *dims,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    fused_head.launches += 1
    return out


fused_head.launches = 0


def _tma_weight(w: torch.Tensor, b: torch.Tensor, rows: int):
    """(w, b) as the bf16 post kernel maps them: `rows` rows, a width m a
    multiple of 8, 16-byte aligned; else a zero-padded copy (the zero columns
    compute act(0) = 0, the zero rows meet the previous stage's zero
    columns)."""
    k, m = w.shape
    mp = _rup(m, 8)
    if mp == m and k == rows and w.data_ptr() % 16 == 0:
        return w, b, m
    wp = w.new_zeros((rows, mp))
    wp[:k, :m] = w
    bp = b.new_zeros((mp,))
    bp[:m] = b
    return wp, bp, mp


@functools.lru_cache(maxsize=256)
def _bf16_ints(n: int, hw: int, c: int, e: int, widths: Tuple[int, ...],
               acts: Tuple[int, ...], conv_act: int, m_out: int, sms: int):
    """The C entry's integer arguments for one form and batch (`head_plan`'s
    numbers), and the elements of the pooled rows and the first post's
    rows (0: none)."""
    plan = head_plan(n, c, e or None, widths, sms)
    cp, n_post = plan.conv, len(widths)
    dims = []
    for j in range(MAX_POST):
        dims += [widths[j], acts[j]] if j < n_post else [0, 0]
    ints = (n, hw, c, e, conv_act, n_post, *dims, m_out,
            cp.nwg if cp else 0, cp.groups if cp else 0, cp.stages if cp else 0,
            *[plan.posts[j].kparts if j < n_post else 0 for j in range(MAX_POST)],
            *[plan.posts[j].stages if j < n_post else 0 for j in range(MAX_POST)])
    return ints, n * plan.ld if n_post else 0, n * widths[0] if n_post == 2 else 0


def _launch_bf16(lib, x, conv, post, m_out: int, sms: int, stream: int) -> torch.Tensor:
    """The bf16 kernels of head_wgmma.cuh on the plan of `head_plan` for a
    card of `sms` SMs, on `stream`: the output, and one scratch allocation
    for the pooled rows and the first post's rows (16-byte aligned)."""
    n, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    e = int(conv[0].shape[1]) if conv is not None else 0
    ptrs = [0, 0] if conv is None else [conv[0].data_ptr(), conv[1].data_ptr()]
    widths, acts, keep, rows = [], [], [], e or c
    for pw, pb, act in post:
        tw, tb, rows = _tma_weight(pw, pb, rows)
        keep += [tw, tb]  # a padded copy lives until the launch is queued
        ptrs += [tw.data_ptr(), tb.data_ptr()]
        widths.append(rows)
        acts.append(ACTS[act])
    ptrs += [0, 0] * (MAX_POST - len(post))
    ints, n_pooled, n_mid = _bf16_ints(n, h * w, c, e, tuple(widths), tuple(acts),
                                       -1 if conv is None else ACTS[conv[2]], m_out, sms)
    out = torch.empty((n, m_out), dtype=dt, device=dev)
    pooled = mid = 0
    if n_pooled:
        scratch = torch.empty(_rup(n_pooled, 8) + n_mid, dtype=dt, device=dev)
        pooled = scratch.data_ptr()
        mid = pooled + 2 * _rup(n_pooled, 8) if n_mid else 0
    code = lib.fused_head_bf16(x.data_ptr(), *ptrs, pooled, mid, out.data_ptr(), *ints, stream)
    _build.check(lib, code, "fused_head")
    return out
