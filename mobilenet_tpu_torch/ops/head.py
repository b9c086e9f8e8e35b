"""Fused classifier head, [conv_last 1x1 + act] -> pool -> 0-2 matmuls
each + act: the CUDA kernels of `csrc/fused_head.cu` (bf16 on the Hopper
kernels of `csrc/head_wgmma.cuh`, planned by `head_plan`) and their plain
PyTorch version.

Replaces every form of the TPU kernel `mobilenet_tpu/ops/pallas_head.py`
`fused_head`: V1's pool+fc, V2's conv_last + ReLU6 -> pool -> fc, and
V3-Large's and V3-Small's conv_last + hswish -> pool -> head matmul + hswish
-> fc. The conv_last output never reaches device memory: its stage writes
only the pooled (N, E) rows. bf16 launches one kernel a stage (V1 pool, post:
2; V2 conv_walk, post: 2; V3 conv_walk, post, post: 3), float32 likewise on
the CUDA-core kernels of `csrc/head_f32.cuh`, planned by `f32_head_plan`. A
post weight whose width is not a multiple of 8 (or whose rows do not follow
the previous stage's padded width, or whose data is not 16-byte aligned) is
copied into a zero-padded one for the kernels' 16-byte loads (TMA maps in
bf16); no model's head has one. The bf16 conv_last takes at most 1600 input
channels (its resident weight slice); float32 streams its weight and takes
any width.
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


# -- the float32 kernels' plan (csrc/head_f32.cuh) -----------------------------
F32_BK = 32             # conv_walk: K a chunk
F32_CS = 3              # conv_walk: ring slots
F32_PK = 32             # post: K a chunk
F32_PT = 64             # post: rows and columns a tile
F32_PS = 4              # post: ring slots
F32_RED_LD = F32_PT + 4
# narrow_f32_kernel (8 or 16 columns a block, the whole of K, no cluster) for
# the post matmuls up to this batch, and for the conv_last walk up to two of
# its 64-row pixel tiles
F32_SMALL_N = 16
F32_NARROW_ROWS = 128
F32_POST_NC = 8         # narrow post: columns a block
# blocks an SM holds by registers: conv_walk's 256 threads at up to 128
# (`__launch_bounds__(256, 2)`)
F32_CONV_PER_SM = 2


class F32ConvPlan(NamedTuple):
    bm: int       # 128 (conv_walk: 128-row tiles), or narrow's columns a block (8, 16)
    bn: int       # columns of E a block
    slices: int   # cdiv(E, bn)
    groups: int   # image groups (grid y; narrow: 1)
    gimg: int     # images a group: cdiv(N, groups), as the kernel computes it
    per_sm: int   # blocks an SM holds
    smem: int


class F32PostPlan(NamedTuple):
    k: int        # W's rows
    m: int        # W's width (a multiple of 8)
    narrow: bool  # narrow_f32_kernel (a batch up to F32_SMALL_N), else post_f32_kernel
    kparts: int   # K parts a tile: the cluster's size (narrow: 1)
    ti: int       # 64-row tiles (narrow: 1)
    tj: int       # 64-column tiles (narrow: blocks)
    nch: int      # chunks of K: 32 rows (narrow: 256)
    blocks: int   # ti x tj x kparts


class F32HeadPlan(NamedTuple):
    conv: Optional[F32ConvPlan]
    ld: int       # the pooled rows' pitch: E, or C rounded up to 8
    posts: Tuple[F32PostPlan, ...]


def f32_head_smem_bytes(kind: int, pool: int = 0, nc: int = 8) -> int:
    """Dynamic shared memory of a float32 kernel (head_f32.cuh; the C entry
    `head_f32_smem_bytes` computes the same), f32: kind 0 conv_walk (its
    ring of 3 A chunks 128 x 32 and weight chunks 32 x 128, or the staged
    tile 128 x 132 over it, the larger), kind 1 post (a ring of 4 A chunks
    64 x 32 and W chunks 32 x 64, then the 64 x 68 partial tile), kind 2
    narrow on nc columns a block (pool: the conv_last form, a ring of 4 A
    chunks 64 x 64 and W chunks 64 x nc and the K slices' 64 x nc partials;
    else a ring of 4 A chunks 16 x 256 and W chunks 256 x nc and the
    slices' 16 x nc partials; 256 threads over the tile's 4 x 4 quads, the
    rest K slices). pool_f32_kernel uses a static 16 KB slab."""
    if kind == 0:
        return max(F32_CS * 2 * 128 * F32_BK, 128 * 132) * 4
    if kind == 1:
        return (F32_PS * 2 * F32_PT * F32_PK + F32_PT * F32_RED_LD) * 4
    tr, nk, slots = (64, 64, 4) if pool else (F32_SMALL_N, 256, 4)
    slices = 256 // (tr // 4 * (nc // 4))
    return (slots * (tr * nk + nk * nc) + slices * tr * nc) * 4


def f32_conv_plan(n: int, hw: int, c: int, e: int, sms: int = H100_SMS) -> F32ConvPlan:
    """The float32 conv_last walk's plan: up to F32_NARROW_ROWS pixel rows
    (batch 1 and 2 at 7 x 7), narrow_f32_kernel<true>: 8 columns of E a
    block, 16 where E / 8 blocks would exceed the card's SMs, each every
    image's rows and the whole of C; above, conv_walk_f32_kernel (8 x 8
    fmaf a thread) with image groups so that slices x groups fill one
    wave."""
    if n * hw > F32_NARROW_ROWS:
        smem = f32_head_smem_bytes(0)
        per_sm = min(SMEM_SM // (smem + 1024), F32_CONV_PER_SM)
        slices = _cdiv(e, 128)
        gimg = _cdiv(n, max(1, min(n, sms * per_sm // slices)))
        return F32ConvPlan(128, 128, slices, _cdiv(n, gimg), gimg, per_sm, smem)
    nc = 16 if _cdiv(e, 8) > sms else 8
    smem = f32_head_smem_bytes(2, 1, nc)
    return F32ConvPlan(nc, nc, _cdiv(e, nc), 1, n, SMEM_SM // (smem + 1024), smem)


def f32_post_plan(n: int, k: int, m: int) -> F32PostPlan:
    """The float32 post matmul's plan for (n, k) @ (k, m): up to F32_SMALL_N
    rows, narrow_f32_kernel (F32_POST_NC columns a block, the whole of K in
    256-row chunks); above, post_f32_kernel's 64 x 64 output tiles with K
    split into the fewest parts (at most 8, one a 32-row chunk at least)
    that put MIN_BLOCKS blocks on the card."""
    if n <= F32_SMALL_N:
        tj = _cdiv(m, F32_POST_NC)
        return F32PostPlan(k, m, True, 1, 1, tj, _cdiv(k, 256), tj)
    nch, ti, tj = _cdiv(k, F32_PK), _cdiv(n, F32_PT), _cdiv(m, F32_PT)
    kparts = max(1, min(MAX_KPARTS, nch, _cdiv(MIN_BLOCKS, ti * tj)))
    return F32PostPlan(k, m, False, kparts, ti, tj, nch, ti * tj * kparts)


@functools.lru_cache(maxsize=None)
def f32_head_plan(n: int, hw: int, c: int, e: Optional[int], widths: Tuple[int, ...],
                  sms: int = H100_SMS) -> F32HeadPlan:
    """The float32 kernels' plan for n images of hw pixels of c channels,
    conv_last c -> e (None: none) and post weights of `widths` (each a
    multiple of 8: the wrapper pads the others)."""
    conv = f32_conv_plan(n, hw, c, e, sms) if e else None
    ld = e if e else _rup(c, 8)
    posts, k = [], e if e else c
    for m in widths:
        posts.append(f32_post_plan(n, k, m))
        k = m
    return F32HeadPlan(conv, ld, tuple(posts))


def head_fits(c: int, conv: Optional[Tuple], post: Sequence[Tuple]) -> bool:
    """True when the kernels take this form: 0-2 post matmuls and known
    activations (the float32 kernels tile every width; bf16 with a
    conv_last also needs `bf16_conv_fits`). c: the input's channels."""
    acts = ([conv[2]] if conv is not None else []) + [a for _, _, a in post]
    return c > 0 and len(post) <= MAX_POST and all(a in ACTS for a in acts)


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
        raise ValueError(f"{name}: the kernels do not take this form")
    if sfx == "bf16" and conv is not None and not bf16_conv_fits(c):
        raise ValueError(f"{name}: the bf16 conv_last's weight slice of {c} input channels "
                         f"exceeds the kernel's shared memory")
    if x.device.type == "cpu":
        return fused_head_plain(x, conv, post)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    launch = _launch_bf16 if sfx == "bf16" else _launch_f32
    out = launch(lib, x, conv, post, k, _sms(x.device.index or 0),
                 torch.cuda.current_stream(x.device).cuda_stream)
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


@functools.lru_cache(maxsize=256)
def _f32_ints(n: int, hw: int, c: int, e: int, widths: Tuple[int, ...],
              acts: Tuple[int, ...], conv_act: int, m_out: int, sms: int):
    """The float32 C entry's integer arguments for one form and batch
    (`f32_head_plan`'s numbers), and the elements of the pooled rows and the
    first post's rows (0: none)."""
    plan = f32_head_plan(n, hw, c, e or None, widths, sms)
    cp, n_post = plan.conv, len(widths)
    dims = []
    for j in range(MAX_POST):
        dims += [widths[j], acts[j]] if j < n_post else [0, 0]
    ints = (n, hw, c, e, conv_act, n_post, *dims, m_out, cp.bm if cp else 0,
            cp.groups if cp else 0,
            *[plan.posts[j].kparts if j < n_post else 0 for j in range(MAX_POST)])
    return ints, n * plan.ld if n_post else 0, n * widths[0] if n_post == 2 else 0


def _launch_f32(lib, x, conv, post, m_out: int, sms: int, stream: int) -> torch.Tensor:
    """The float32 kernels of head_f32.cuh on the plan of `f32_head_plan`
    for a card of `sms` SMs, on `stream`: the output, and one scratch
    allocation for the pooled rows and the first post's rows."""
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
    ints, n_pooled, n_mid = _f32_ints(n, h * w, c, e, tuple(widths), tuple(acts),
                                      -1 if conv is None else ACTS[conv[2]], m_out, sms)
    out = torch.empty((n, m_out), dtype=dt, device=dev)
    pooled = mid = 0
    if n_pooled:
        scratch = torch.empty(_rup(n_pooled, 4) + n_mid, dtype=dt, device=dev)
        pooled = scratch.data_ptr()
        mid = pooled + 4 * _rup(n_pooled, 4) if n_mid else 0
    code = lib.fused_head_f32(x.data_ptr(), *ptrs, pooled, mid, out.data_ptr(), *ints, stream)
    _build.check(lib, code, "fused_head")
    return out
