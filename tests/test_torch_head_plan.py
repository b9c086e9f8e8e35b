"""The bf16 head kernels' plan (`ops/head.head_plan`, `csrc/head_wgmma.cuh`)
and a NumPy mirror of their arithmetic, on the CPU.

The plan is pinned at every model form's widths at 1.0-224 (V1, V2, V3-Large,
V3-Small and V2 alpha 1.4's 448 -> 1792) at batch 1, 8, 64 and 256: the
conv_last walk's image groups and column slices cover every image and every
column once, the post matmuls' 64 x 64 tiles cover the output and their K
parts every 64-row chunk of K once (each part non-empty) with the reduction's
column shares (groups of 4) covering the tile's 64 columns once, each kernel's shared
memory is the sum of its parts and within a block's limit, and at batch 1
every post launch puts >= 128 blocks on the card. The conv_last walk's ring
handshakes, stepped role by role, finish at every width the plan takes (the
eager protocol where the ring holds fewer slots than C's chunks), and the
dtypes' domains differ only above 1600 conv_last input channels.

The mirror copies the kernels' order of work: the pool's f32 sums in pixel
order; the conv_last walk over 64-row tiles that cross image boundaries
(+ bias, activation, bf16, then each column's running f32 sum carried from
tile to tile and stored at an image's last pixel); each post matmul's f32
partial products over K parts of 64-row chunks, summed in rank order, + bias,
activation, bf16; and the wrapper's zero padding of a ragged post weight. Its
outputs are held against the plain version and the JAX package's Pallas
`fused_head` in interpret mode, with the tolerances of test_torch_head.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_head import fused_head as jax_fused_head
from mobilenet_tpu_torch.block_times import HEAD_FORMS
from mobilenet_tpu_torch.ops.head import (
    CHUNK_BYTES, F32_NARROW_ROWS, F32_PK, F32_POST_NC, F32_PT, F32_SMALL_N, KCH,
    MAX_CONV_STAGES, MAX_KPARTS,
    MAX_POST_STAGES, MIN_BLOCKS, RED_LD, SMEM_MAX, SMEM_SM, STAGE_LD, TM, TN, ConvPlan, PostPlan,
    _tma_weight, conv_plan, f32_head_plan, f32_head_smem_bytes, f32_post_plan, fused_head,
    fused_head_plain, head_act, head_fits, head_plan, head_smem_bytes, post_plan,
)

# test_torch_head.py's tolerances: one bf16 step at each rounding; conv
# forms round at 2-4 cast points.
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1 / 64, rtol=2 ** -7)
BF16_CONV_TOL = dict(atol=1 / 32, rtol=2 ** -6)

# 1.0-224 (and V2 alpha 1.4): C, conv_last E (None: none), post widths.
FORMS = {name: (c, conv[0] if conv else None, tuple(m for m, _ in posts))
         for name, (c, conv, posts) in HEAD_FORMS.items()}


@pytest.mark.parametrize("form,n,want", [
    # V1: the pool, then the fc in 4 x 16 tiles x 2 K parts at batch 256,
    # 16 tiles x 8 parts below 65 images
    ("v1", 256, (None, 1024, ((2, 128),))),
    ("v1", 64, (None, 1024, ((8, 128),))),
    ("v1", 8, (None, 1024, ((8, 128),))),
    ("v1", 1, (None, 1024, ((8, 128),))),
    # conv_last: (warpgroups, column slices, image groups, images a group,
    # A ring slots: two tiles' chunks from batch 16 up where they fit)
    ("v2", 256, ((2, 10, 13, 20, 10), 1280, ((2, 128),))),
    ("v2", 64, ((2, 10, 13, 5, 10), 1280, ((8, 128),))),
    ("v2", 8, ((1, 20, 8, 1, 5), 1280, ((8, 128),))),
    ("v2", 1, ((1, 20, 1, 1, 5), 1280, ((8, 128),))),
    ("v3l", 256, ((2, 8, 16, 16, 6), 960, ((2, 160), (2, 128)))),
    ("v3l", 64, ((2, 8, 16, 4, 6), 960, ((7, 140), (8, 128)))),
    ("v3l", 8, ((1, 15, 8, 1, 3), 960, ((7, 140), (8, 128)))),
    ("v3l", 1, ((1, 15, 1, 1, 3), 960, ((7, 140), (8, 128)))),
    ("v3s", 256, ((2, 5, 52, 5, 4), 576, ((2, 128), (2, 128)))),
    ("v3s", 64, ((2, 5, 32, 2, 4), 576, ((8, 128), (8, 128)))),
    ("v3s", 8, ((1, 9, 8, 1, 2), 576, ((8, 128), (8, 128)))),
    ("v3s", 1, ((1, 9, 1, 1, 2), 576, ((8, 128), (8, 128)))),
    ("v2a14", 256, ((2, 14, 9, 29, 11), 1792, ((2, 128),))),
    ("v2a14", 64, ((2, 14, 8, 8, 11), 1792, ((8, 128),))),
    ("v2a14", 8, ((1, 28, 4, 2, 7), 1792, ((8, 128),))),
    ("v2a14", 1, ((1, 28, 1, 1, 7), 1792, ((8, 128),))),
])
def test_head_plan_pinned(form, n, want):
    c, e, widths = FORMS[form]
    p = head_plan(n, c, e, widths)
    conv = None if p.conv is None else tuple(p.conv[:5])
    assert (conv, p.ld, tuple((q.kparts, q.blocks) for q in p.posts)) == want


@pytest.mark.parametrize("n", [1, 8, 64, 65, 256])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_head_plan_covers(form, n):
    """Every image and column once in the conv_last walk; every output
    element and K chunk once in each post launch."""
    c, e, widths = FORMS[form]
    p = head_plan(n, c, e, widths)
    if e is not None:
        cp = p.conv
        # images: groups of gimg = cdiv(n, groups) (the kernel's formula), none empty
        seen = np.zeros(n, int)
        for g in range(cp.groups):
            img0, img1 = g * cp.gimg, min(n, (g + 1) * cp.gimg)
            assert img0 < img1
            seen[img0:img1] += 1
        assert (seen == 1).all()
        # columns: slices of 64 nwg, the last may run past E (its columns load as zeros)
        cols = np.zeros(cp.slices * TN * cp.nwg, int)
        for s in range(cp.slices):
            cols[s * TN * cp.nwg:(s + 1) * TN * cp.nwg] += 1
        assert (cols[:e] == 1).all() and cp.slices == -(-e // (TN * cp.nwg))
        assert p.ld == e
    else:
        assert p.ld == -(-c // 8) * 8
    k = e or c
    for q, m in zip(p.posts, widths):
        assert (q.k, q.m) == (k, m)
        assert q.ti * TM >= n > (q.ti - 1) * TM and q.tj * TN >= m > (q.tj - 1) * TN
        assert q.nch == -(-k // KCH) and 1 <= q.kparts <= min(8, q.nch)
        chunks = np.zeros(q.nch, int)
        share = np.zeros(TN, int)
        for part in range(q.kparts):
            c0, c1 = part * q.nch // q.kparts, (part + 1) * q.nch // q.kparts
            assert c0 < c1
            chunks[c0:c1] += 1
            share[4 * (part * (TN // 4) // q.kparts):4 * ((part + 1) * (TN // 4) // q.kparts)] += 1
        assert (chunks == 1).all() and (share == 1).all()
        assert q.blocks == q.ti * q.tj * q.kparts
        k = m


@pytest.mark.parametrize("form", sorted(FORMS))
def test_head_plan_smem(form):
    """Each kernel's shared memory is the sum of its parts (the C side's
    conv_smem_bytes / post_smem_bytes) and fits a block; the blocks an SM
    holds fit its shared memory and threads."""
    c, e, widths = FORMS[form]
    for n in (1, 8, 64, 256):
        for q in head_plan(n, c, e, widths).posts:
            post = 1024 + q.stages * 2 * CHUNK_BYTES + TM * RED_LD * 4 + TN * 4 + 16 * q.stages
            assert head_smem_bytes(1, 0, 0, q.stages) == post <= SMEM_MAX
            assert 2 <= q.stages <= min(MAX_POST_STAGES, max(2, -(-q.nch // q.kparts)))
            # the launch's blocks all fit the card at once
            assert -(-q.blocks // 132) * (post + 1024) <= SMEM_SM
        cp = head_plan(n, c, e, widths).conv
        if cp is None:
            continue
        nch = -(-c // KCH)
        parts = (1024 + nch * cp.nwg * CHUNK_BYTES + cp.stages * CHUNK_BYTES
                 + cp.nwg * TM * STAGE_LD * 4 + 8 * (2 * cp.stages + 1))
        assert cp.smem == head_smem_bytes(0, c, cp.nwg, cp.stages) == parts <= SMEM_MAX
        assert 2 <= cp.stages <= min(MAX_CONV_STAGES, 2 * nch if n >= 16 else max(2, nch))
        assert cp.per_sm >= 1 and cp.per_sm * (cp.smem + 1024) <= SMEM_SM
        assert cp.per_sm * (128 * cp.nwg + 32) <= 2048


@pytest.mark.parametrize("form", sorted(FORMS))
def test_head_plan_batch1_fills_card(form):
    """At batch 1 (and 8) every post launch puts >= 128 blocks on the card:
    one 64-row tile, so the K parts multiply the column tiles."""
    c, e, widths = FORMS[form]
    for n in (1, 8):
        for q in head_plan(n, c, e, widths).posts:
            assert q.blocks >= MIN_BLOCKS, q


def test_head_plan_refuses_oversized_conv():
    """A conv_last whose one-warpgroup weight slice does not fit raises."""
    with pytest.raises(ValueError, match="shared memory"):
        head_plan(1, 8192, 64, ())


# -- the conv_last walk's ring protocol ---------------------------------------------


def ring_walk(nch, stages, nwg, tiles, eager):
    """Steps conv_walk_kernel's producer and consumer warpgroups through
    their ring handshakes (mbarrier phases as counts; a TMA load and a
    chunk's products complete at once) and returns True if every role
    finishes, False where none can move (a deadlock).

    Producer: chunk `it` (tile-major, nch a tile) waits for slot it % stages
    to have been freed it // stages times, then fills it. A consumer: for
    tile 0 it issues (each chunk waits for its slot's fill; eager: frees the
    previous chunk's slot once that chunk is done), then for each tile
    finishes it (frees its slots: eager only the last chunk's) and issues
    the next. A slot is freed once all nwg warpgroups arrive."""
    total = tiles * nch
    filled = [0] * stages      # fills done a slot (the full barrier's phases)
    freed = [0] * stages       # completed frees a slot (the empty barrier's phases)
    arrivals = [0] * stages    # warpgroups arrived in the current free phase

    def free(it):
        s = it % stages
        assert freed[s] == it // stages, "a slot freed out of phase"
        arrivals[s] += 1
        if arrivals[s] == nwg:
            arrivals[s], freed[s] = 0, freed[s] + 1

    def producer():
        for it in range(total):
            s = it % stages
            while freed[s] < it // stages:
                yield False
            filled[s] += 1
            yield True

    def consumer():
        it = 0

        def issue():
            nonlocal it
            for c in range(nch):
                s = it % stages
                while filled[s] < it // stages + 1:
                    yield False
                if eager and c > 0:
                    free(it - 1)
                it += 1
                yield True

        def finish(tile):
            for c in range(nch - 1 if eager else 0, nch):
                free(tile * nch + c)
            yield True

        yield from issue()
        for tile in range(tiles - 1):
            yield from finish(tile)
            yield from issue()
        yield from finish(tiles - 1)

    roles = [producer()] + [consumer() for _ in range(nwg)]
    live = list(roles)
    while live:
        moved = False
        for r in list(live):
            try:
                moved |= next(r)
            except StopIteration:
                live.remove(r)
                moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("n", [1, 8, 16, 64, 256])
@pytest.mark.parametrize("c", [8, 96, 160, 320, 448, 512, 520, 576, 704, 832, 840, 1024, 1280,
                               1600])
def test_conv_ring_progresses(c, n):
    """At every conv_last width the plan takes, up to 1600 input channels
    (a two-warpgroup ring of 7 slots for 9 chunks at C = 576, one of 11 for
    16 at C = 1024), the ring protocol that the plan selects (eager where
    the ring holds fewer slots than C's chunks) finishes every tile of the
    busiest image group."""
    cp = conv_plan(n, c, 1280)
    nch = -(-c // KCH)
    assert cp.eager == (cp.stages < nch) and cp.stages >= 2
    tiles = -(-cp.gimg * 49 // TM)
    assert ring_walk(nch, cp.stages, cp.nwg, tiles, cp.eager)


def test_conv_ring_tile_release_needs_a_tile_of_slots():
    """Freeing a tile's slots only once all its products are done stalls when
    the ring holds fewer slots than the tile's chunks; the eager protocol
    does not, down to two slots."""
    assert not ring_walk(16, 11, 1, 2, eager=False)
    assert not ring_walk(9, 7, 2, 3, eager=False)
    assert ring_walk(9, 9, 2, 3, eager=False)
    for nch, stages, nwg in [(16, 11, 1), (9, 7, 2), (3, 2, 1), (25, 2, 2)]:
        assert ring_walk(nch, stages, nwg, 4, eager=True)


def test_head_domain_by_dtype():
    """float32 takes a conv_last of any width (its kernels stream the weight:
    2048 input channels here); bf16 raises above 1600, on the CPU as on the
    card."""
    rng = np.random.default_rng(3)

    def operands(c, dtype):
        x = torch.from_numpy(rng.uniform(0, 6, (1, 2, 2, c)).astype(np.float32)).to(dtype)
        conv = (torch.from_numpy(rng.normal(0, c ** -0.5, (c, 64)).astype(np.float32)).to(dtype),
                torch.zeros(64, dtype=dtype), "relu6")
        return x, conv, [(torch.zeros(64, 8, dtype=dtype), torch.zeros(8, dtype=dtype),
                          "linear")]

    assert head_fits(2048, operands(2048, torch.float32)[1], [])
    x, conv, post = operands(2048, torch.float32)
    torch.testing.assert_close(fused_head(x, conv, post), fused_head_plain(x, conv, post))
    with pytest.raises(ValueError, match="weight slice"):
        fused_head(*operands(2048, torch.bfloat16))
    x, conv, post = operands(1600, torch.bfloat16)
    torch.testing.assert_close(fused_head(x, conv, post), fused_head_plain(x, conv, post))


# -- the NumPy mirror -------------------------------------------------------------


def _round(a, bf16: bool) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if not bf16:
        return a
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _act(a, act: str) -> np.ndarray:
    return head_act(torch.from_numpy(np.asarray(a, np.float32)), act).numpy()


def mirror_pool(x, bf16):
    """pool_kernel: f32 sums in pixel order, / HW, rounded."""
    n, h, w, c = x.shape
    s = np.zeros((n, c), np.float32)
    for p in range(h * w):
        s = s + x.reshape(n, h * w, c)[:, p]
    return _round(s / np.float32(h * w), bf16)


def mirror_conv_walk(x, cw, cb, act, cp: ConvPlan, bf16):
    """conv_walk_kernel: for each column slice and image group, 64-row tiles
    of the group's pixel rows (crossing images; rows past the tensor zero),
    the product in f32, + bias, activation, rounded; each column's running
    f32 sum over the rows in order, stored at an image's last pixel."""
    n, h, w, c = x.shape
    hw, e = h * w, cw.shape[1]
    rows = np.concatenate([x.reshape(n * hw, c), np.zeros((TM, c), np.float32)])
    out = np.full((n, e), np.nan, np.float32)
    width = TN * cp.nwg
    for s in range(cp.slices):
        c0, c1 = s * width, min(e, (s + 1) * width)
        for g in range(cp.groups):
            img0, img1 = g * cp.gimg, min(n, (g + 1) * cp.gimg)
            row0, row1 = img0 * hw, img1 * hw
            total, cur, left = np.zeros(c1 - c0, np.float32), img0, hw
            for r0 in range(row0, row1, TM):
                y = rows[r0:r0 + TM] @ cw[:, c0:c1] + cb[c0:c1]
                y = _round(_act(y, act), bf16)
                for rr in range(min(TM, row1 - r0)):
                    total = total + y[rr]
                    left -= 1
                    if left == 0:
                        out[cur, c0:c1] = _round(total / np.float32(hw), bf16)
                        total, left, cur = np.zeros_like(total), hw, cur + 1
    assert not np.isnan(out).any()
    return out


def mirror_post(a, wt, b, act, q: PostPlan, m_out, bf16):
    """post_kernel: for each 64 x 64 tile, the f32 partial product of each K
    part (its 64-row chunks), summed over the parts in rank order, + bias,
    activation, rounded; columns past m_out are not stored."""
    n = a.shape[0]
    k, m = wt.shape
    a = np.pad(a, ((0, q.ti * TM - n), (0, q.nch * KCH - a.shape[1])))
    wt = np.pad(wt, ((0, q.nch * KCH - k), (0, q.tj * TN - m)))
    bias = np.pad(b, (0, q.tj * TN - m))
    out = np.zeros((q.ti * TM, q.tj * TN), np.float32)
    for i in range(q.ti):
        for j in range(q.tj):
            rs, cs = slice(TM * i, TM * (i + 1)), slice(TN * j, TN * (j + 1))
            v = np.zeros((TM, TN), np.float32)
            for part in range(q.kparts):
                ks = slice(part * q.nch // q.kparts * KCH, (part + 1) * q.nch // q.kparts * KCH)
                v = v + a[rs, ks] @ wt[ks, cs]
            out[rs, cs] = _round(_act(v + bias[cs], act), bf16)
    return out[:n, :m_out]


def mirror_head(x, conv, post, plan, bf16):
    """The three kernels in sequence, on the wrapper's padded weights."""
    n, h, w, c = x.shape
    if conv is not None:
        feat = mirror_conv_walk(x, conv[0], conv[1], conv[2], plan.conv, bf16)
    else:
        feat = np.pad(mirror_pool(x, bf16), ((0, 0), (0, plan.ld - c)))
    rows = conv[0].shape[1] if conv is not None else c
    for j, ((pw, pb, act), q) in enumerate(zip(post, plan.posts)):
        tw, tb, mp = _tma_weight(torch.from_numpy(pw), torch.from_numpy(pb), rows)
        last = j == len(post) - 1
        feat = mirror_post(feat, tw.numpy(), tb.numpy(), act, q,
                           pw.shape[1] if last else mp, bf16)
        rows = mp
    return feat if post or conv is not None else feat[:, :c]


def _layer(rng, k, m, act, bf16):
    return (_round(rng.normal(0, 1, (k, m)) / np.sqrt(k), bf16),
            _round(rng.normal(0, 0.1, (m,)), bf16), act)


# (n, hw side, c, conv (e, act) or None, posts, forced plan parts): image
# groups whose tiles cross image boundaries (9 pixels an image, 8 or 16
# images a group: image 7 spans rows 63-71), a last column slice of 8 live
# columns, K parts of 1-4 chunks, ragged post widths (130, 36) that the
# wrapper pads. Batch x pixels a multiple of 8, as the JAX kernel's tiling asks.
MIRROR_CASES = {
    "v1_ragged": (8, 5, 200, None, [(130, "linear")], dict(kparts=(2,))),
    "v1_split": (8, 7, 256, None, [(100, "linear")], dict(kparts=(4,))),
    "v2_cross": (16, 3, 24, (136, "relu6"), [(72, "linear")],
                 dict(nwg=1, groups=1, kparts=(3,))),
    "v3_cross": (16, 3, 32, (96, "hswish"), [(136, "hswish"), (36, "linear")],
                 dict(nwg=2, groups=2, kparts=(2, 3))),
    "v3_one": (2, 2, 16, (48, "hswish"), [], dict(nwg=1, groups=1, kparts=())),
}


def _forced_plan(n, c, conv, post, force):
    plan = head_plan(n, c, conv[0] if conv else None,
                     tuple(-(-m // 8) * 8 for m, _ in post))
    cp = plan.conv
    if cp is not None:
        nwg, groups = force["nwg"], force["groups"]
        cp = cp._replace(nwg=nwg, slices=-(-conv[0] // (TN * nwg)), groups=groups,
                         gimg=-(-n // groups))
    posts = tuple(post_plan(n, q.k, q.m)._replace(kparts=kp)
                  for q, kp in zip(plan.posts, force["kparts"]))
    return plan._replace(conv=cp, posts=posts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_mirror_vs_plain_and_pallas(case, dtype):
    n, side, c, conv_spec, posts, force = MIRROR_CASES[case]
    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(n * 100 + c)
    x = _round(rng.uniform(0, 6, (n, side, side, c)), bf16)
    conv, k = None, c
    if conv_spec is not None:
        conv = _layer(rng, c, conv_spec[0], conv_spec[1], bf16)
        k = conv_spec[0]
    post = []
    for m, act in posts:
        post.append(_layer(rng, k, m, act, bf16))
        k = m
    plan = _forced_plan(n, c, conv_spec, posts, force)
    got = mirror_head(x, conv, post, plan, bf16)
    assert got.shape == (n, k)

    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def tx(layer):
        return (torch.from_numpy(layer[0]).to(tdt), torch.from_numpy(layer[1]).to(tdt), layer[2])

    def jx(layer):
        return (jnp.asarray(layer[0], jdt), jnp.asarray(layer[1], jdt), layer[2])

    tol = F32_TOL if not bf16 else (BF16_TOL if conv is None else BF16_CONV_TOL)
    plain = fused_head_plain(torch.from_numpy(x).to(tdt), None if conv is None else tx(conv),
                             [tx(p) for p in post])
    np.testing.assert_allclose(got, plain.float().numpy(), **tol)
    ref = jax_fused_head(jnp.asarray(x, jdt), None if conv is None else jx(conv),
                         [jx(p) for p in post], interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **tol)


def test_mirror_split_is_fixed_order():
    """The K-split sum in rank order is one fixed order: the same inputs give
    the same bits, and one K part is the unsplit product."""
    rng = np.random.default_rng(7)
    a = _round(rng.normal(0, 1, (3, 512)), True)
    wt = _round(rng.normal(0, 0.05, (512, 64)), True)
    b = _round(rng.normal(0, 0.1, (64,)), True)
    q = post_plan(3, 512, 64)
    assert q.kparts == 8
    one = mirror_post(a, wt, b, "linear", q, 64, False)
    assert np.array_equal(one, mirror_post(a, wt, b, "linear", q, 64, False))
    whole = mirror_post(a, wt, b, "linear", q._replace(kparts=1), 64, False)
    np.testing.assert_allclose(one, whole, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(whole, a @ wt + b, rtol=1e-5, atol=1e-5)


# -- the bf16 launch's arguments ------------------------------------------------------


class _RecordingLib:
    """Stands in for the kernel library: records fused_head_bf16's arguments."""

    def __init__(self):
        self.calls = []

    def fused_head_bf16(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("n,c,conv_spec,posts", [
    (1, 1024, None, [(1000, "linear")]),                              # V1
    (65, 320, (1280, "relu6"), [(1000, "linear")]),                   # V2, ragged batch
    (8, 96, (576, "hswish"), [(1024, "hswish"), (1000, "linear")]),   # V3-Small
    (3, 200, None, [(130, "linear")]),                                # ragged width: padded
    (2, 24, (200, "relu"), []),                                       # no post
])
def test_launch_bf16_arguments(n, c, conv_spec, posts):
    """What the wrapper hands the C entry point: as many arguments as its
    signature declares (and the stream), the plan's numbers, the output, and
    the pooled rows and first post's rows as disjoint 16-byte-aligned parts
    of one scratch allocation (the second after the first's n x ld
    elements)."""
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.head import ACTS, _launch_bf16

    bf = torch.bfloat16
    x = torch.zeros(n, 7, 7, c, dtype=bf)
    conv, k = None, c
    if conv_spec is not None:
        conv = (torch.zeros(c, conv_spec[0], dtype=bf), torch.zeros(conv_spec[0], dtype=bf),
                conv_spec[1])
        k = conv_spec[0]
    post = []
    for m, act in posts:
        post.append((torch.zeros(k, m, dtype=bf), torch.zeros(m, dtype=bf), act))
        k = m
    lib = _RecordingLib()
    out = _launch_bf16(lib, x, conv, post, k, 132, 7)
    (args,) = lib.calls
    assert len(args) == len(_build._SIGNATURES["fused_head_bf16"]) + 1 and args[-1] == 7
    ptrs, ints = args[:10], args[10:-1]
    (xp, cwp, cbp, w0p, b0p, w1p, b1p, pooled, mid, outp) = ptrs
    (N, hw, C, E, conv_act, n_post, m0, act0, m1, act1, m_out, nwg, groups, stages,
     kp0, kp1, st0, st1) = ints
    assert out.shape == (n, k) and outp == out.data_ptr() and xp == x.data_ptr()
    assert (N, hw, C, m_out, n_post) == (n, 49, c, k, len(posts))
    assert E == (conv_spec[0] if conv_spec else 0)
    assert (cwp != 0) == (conv_spec is not None)
    assert conv_act == (ACTS[conv_spec[1]] if conv_spec else -1)
    widths = [-(-m // 8) * 8 for m, _ in posts]
    assert [m0, m1][:len(posts)] == widths and [act0, act1][:len(posts)] == [
        ACTS[a] for _, a in posts]
    plan = head_plan(n, c, E or None, tuple(widths), 132)
    if plan.conv is not None:
        assert (nwg, groups, stages) == (plan.conv.nwg, plan.conv.groups, plan.conv.stages)
    assert [kp0, kp1][:len(posts)] == [q.kparts for q in plan.posts]
    assert [st0, st1][:len(posts)] == [q.stages for q in plan.posts]
    assert (pooled != 0) == bool(posts) and (mid != 0) == (len(posts) == 2)
    assert (w1p != 0) == (len(posts) == 2) and (w0p != 0) == bool(posts)
    if posts:
        assert pooled % 16 == 0
    if len(posts) == 2:
        assert mid % 16 == 0 and mid >= pooled + 2 * n * plan.ld
    if posts and posts[0][0] % 8:  # a ragged width reaches the kernel padded
        assert w0p != post[0][0].data_ptr()


# -- the float32 kernels' plan (csrc/head_f32.cuh) ---------------------------------------

# the forms' widths, and a conv_last above the bf16 kernel's resident limit
F32_FORMS = dict(FORMS, c2048=(2048, 256, (104,)))


def _parts(nch, kparts):
    """The chunk ranges of K parts [p * nch / kp, (p + 1) * nch / kp)."""
    return [(p * nch // kparts, (p + 1) * nch // kparts) for p in range(kparts)]


@pytest.mark.parametrize("n", [1, 2, 3, 64, 256])
@pytest.mark.parametrize("form", sorted(F32_FORMS))
def test_f32_head_plan_covers(form, n):
    """The float32 plan at C = 1024 (V1), 320 (V2), 160 (V3-L), 96 (V3-S),
    448 (V2 alpha 1.4) and 2048: conv_walk's image groups and 128-column
    slices cover every image and column once, or narrow's 8- or 16-column
    blocks cover E once with every image in each; each post's tiles cover the
    output (narrow up to F32_SMALL_N rows: 8-column blocks, the whole of K;
    else 64 x 64 tiles whose K parts take every 32-row chunk once, each
    non-empty, and whose column shares, groups of 4, take the tile's 64
    columns once); at batch 1 a model's form puts >= 36 blocks on the card
    in its conv_last and >= 63 in each post; shared memory within the
    limit."""
    c, e, widths = F32_FORMS[form]
    plan = f32_head_plan(n, 49, c, e, widths)
    cp = plan.conv
    if e is None:
        assert cp is None and plan.ld == -(-c // 8) * 8
    else:
        assert plan.ld == e and cp.smem <= SMEM_MAX
        assert cp.slices * cp.bn >= e > (cp.slices - 1) * cp.bn
        assert cp.groups * cp.gimg >= n > (cp.groups - 1) * cp.gimg
        if cp.bm == 128:
            assert cp.smem == f32_head_smem_bytes(0) and cp.bn == 128
            assert n * 49 > F32_NARROW_ROWS
        else:
            assert cp.bm == cp.bn in (8, 16) and cp.groups == 1 and n * 49 <= F32_NARROW_ROWS
            assert cp.smem == f32_head_smem_bytes(2, 1, cp.bn) <= SMEM_MAX
            assert cp.slices <= 132 or cp.bn == 16
        if n == 1 and form in FORMS:
            assert cp.slices >= 36
    k = e or c
    for q, m in zip(plan.posts, widths):
        assert (q.k, q.m) == (k, m) and q.narrow == (n <= F32_SMALL_N)
        if q.narrow:
            nc = F32_POST_NC
            assert q.kparts == 1 and q.tj * nc >= m > (q.tj - 1) * nc
            assert q.nch == -(-k // 256) and f32_head_smem_bytes(2, 0, nc) <= SMEM_MAX
        else:
            assert q.ti * F32_PT >= n > (q.ti - 1) * F32_PT and q.tj * F32_PT >= m
            assert q.nch == -(-k // F32_PK) and 1 <= q.kparts <= min(MAX_KPARTS, q.nch)
            ranges = _parts(q.nch, q.kparts)
            assert ranges[0][0] == 0 and ranges[-1][1] == q.nch
            assert all(a < b for a, b in ranges)
            shares = [(p * 16 // q.kparts, (p + 1) * 16 // q.kparts) for p in range(q.kparts)]
            assert shares[0][0] == 0 and shares[-1][1] == 16
            assert f32_head_smem_bytes(1) <= SMEM_MAX
        if n == 1 and form in FORMS:
            assert q.blocks >= 125
        k = m


def test_f32_head_smem():
    """The float32 kernels' shared memory, part by part (f32): conv_walk's
    ring of 3 chunks (128 x 32 + 32 x 128), over which its staged 128 x 132
    tile lies; post's ring of 4 (64 x 32 + 32 x 64) and a 64 x 68 partial;
    narrow's conv_last form, a ring of 4 (64 x 64 + 64 x nc) and 256 / (16 x
    nc / 4) slices' 64 x nc partials, and its post form, a ring of 4 (16 x
    256 + 256 x nc) and 256 / (4 x nc / 4) slices' 16 x nc partials."""
    assert f32_head_smem_bytes(0) == 3 * 2 * 4096 * 4 > 128 * 132 * 4
    assert f32_head_smem_bytes(1) == (4 * 4096 + 64 * 68) * 4
    assert f32_head_smem_bytes(2, 1, 8) == (4 * (4096 + 512) + 8 * 512) * 4
    assert f32_head_smem_bytes(2, 1, 16) == (4 * (4096 + 1024) + 4 * 1024) * 4
    assert f32_head_smem_bytes(2, 0, 8) == (4 * (4096 + 2048) + 32 * 128) * 4
    assert f32_head_smem_bytes(2, 0, 16) == (4 * (4096 + 4096) + 16 * 256) * 4


def mirror_conv_f32(x, cw, cb, act, cp):
    """The float32 conv_last walk's order of work: conv_walk (bm 128): each
    128-column slice's 128-row tiles of an image group, the product over C in
    order; narrow (bm the columns a block): every image's rows in 64-row
    tiles, each of its K slices summing its rows of every 64-row chunk in order, the slices
    then summed in order; + bias, act, and each column's running f32 sum over
    the rows in order, stored / HW at an image's last pixel."""
    n, h, w, c = x.shape
    hw, e = h * w, cw.shape[1]
    rows = x.reshape(n * hw, c)
    out = np.full((n, e), np.nan, np.float32)
    tile = 128 if cp.bm == 128 else 64
    for s in range(cp.slices):
        cs = slice(s * cp.bn, min(e, (s + 1) * cp.bn))
        for g in range(cp.groups):
            img0, img1 = g * cp.gimg, min(n, (g + 1) * cp.gimg)
            total, cur, left = np.zeros(cs.stop - cs.start, np.float32), img0, hw
            for r0 in range(img0 * hw, img1 * hw, tile):
                r1 = min(img1 * hw, r0 + tile)
                y = rows[r0:r1] @ cw[:, cs] if cp.bm == 128 else _sliced(
                    rows[r0:r1], cw[:, cs], 64, 256 // (16 * cp.bn // 4))
                y = _act(y + cb[cs], act)
                for rr in range(r1 - r0):
                    total = total + y[rr]
                    left -= 1
                    if left == 0:
                        out[cur, cs] = total / np.float32(hw)
                        total, left, cur = np.zeros_like(total), hw, cur + 1
    assert not np.isnan(out).any()
    return out


def _sliced(a, wt, nk, slices):
    """narrow's sum: slice s takes rows [s * nk / slices, ...) of every
    nk-row chunk of K; the slices' sums then added in slice order."""
    kps = nk // slices
    total = None
    for s in range(slices):
        idx = np.concatenate([np.arange(c0 + s * kps, min(c0 + (s + 1) * kps, a.shape[1]))
                              for c0 in range(0, a.shape[1], nk)])
        part = a[:, idx] @ wt[idx] if len(idx) else np.zeros((a.shape[0], wt.shape[1]), np.float32)
        total = part if total is None else total + part
    return total


def mirror_post_f32(a, wt, b, act, q, m_out):
    """post_f32_kernel (each tile's K parts of 32-row chunks in rank order)
    or narrow (its K slices of every 256-row chunk, in slice order)."""
    if q.narrow:
        out = _sliced(a, wt, 256, 256 // (4 * F32_POST_NC // 4))
    else:
        out = np.zeros((a.shape[0], wt.shape[1]), np.float32)
        for lo, hi in _parts(q.nch, q.kparts):
            ks = slice(lo * F32_PK, hi * F32_PK)
            out = out + a[:, ks] @ wt[ks]
    return _act(out + b, act)[:, :m_out]


@pytest.mark.parametrize("kernel", ["walk", "narrow"])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_f32_mirror_vs_plain_and_pallas(case, kernel):
    """The float32 kernels' order of work (either conv_last kernel, and
    either post kernel, forced) against the plain version and the JAX
    package's Pallas kernel in interpret mode."""
    n, side, c, conv_spec, posts, _ = MIRROR_CASES[case]
    rng = np.random.default_rng(n * 100 + c + 1)
    x = rng.uniform(0, 6, (n, side, side, c)).astype(np.float32)
    conv, k = None, c
    if conv_spec is not None:
        conv = _layer(rng, c, conv_spec[0], conv_spec[1], False)
        k = conv_spec[0]
    post = []
    for m, act in posts:
        post.append(_layer(rng, k, m, act, False))
        k = m
    plan = f32_head_plan(n, side * side, c, conv_spec[0] if conv_spec else None,
                         tuple(-(-m // 8) * 8 for m, _ in posts))
    if conv is not None:
        e = conv_spec[0]
        cp = plan.conv._replace(bm=128, bn=128, slices=-(-e // 128), groups=2,
                                gimg=-(-n // 2)) if kernel == "walk" else \
            plan.conv._replace(bm=8, bn=8, slices=-(-e // 8), groups=1, gimg=n)
        feat = mirror_conv_f32(x, conv[0], conv[1], conv[2], cp)
    else:
        feat = np.pad(mirror_pool(x, False), ((0, 0), (0, plan.ld - c)))
    rows = conv_spec[0] if conv_spec else c
    for j, ((pw, pb, act), q) in enumerate(zip(post, plan.posts)):
        q = f32_post_plan(F32_SMALL_N + 1 if kernel == "walk" else 1, q.k, q.m)
        tw, tb, mp = _tma_weight(torch.from_numpy(pw), torch.from_numpy(pb), rows)
        a = feat[:, :q.k] if j == 0 else feat
        feat = mirror_post_f32(a, tw.numpy(), tb.numpy(), act, q,
                               pw.shape[1] if j == len(post) - 1 else mp)
        rows = mp
    got = feat if post or conv is not None else feat[:, :c]
    assert got.shape == (n, k)
    tx = [(torch.from_numpy(w), torch.from_numpy(b), a) for w, b, a in post]
    plain = fused_head_plain(torch.from_numpy(x), None if conv is None else (
        torch.from_numpy(conv[0]), torch.from_numpy(conv[1]), conv[2]), tx)
    np.testing.assert_allclose(got, plain.numpy(), **F32_TOL)
    jx = [(jnp.asarray(w), jnp.asarray(b), a) for w, b, a in post]
    ref = jax_fused_head(jnp.asarray(x), None if conv is None else (
        jnp.asarray(conv[0]), jnp.asarray(conv[1]), conv[2]), jx, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **F32_TOL)


class _RecordingLibF32:
    """Stands in for the kernel library: records fused_head_f32's arguments."""

    def __init__(self):
        self.calls = []

    def fused_head_f32(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("n,c,conv_spec,posts", [
    (1, 1024, None, [(1000, "linear")]),                              # V1
    (65, 320, (1280, "relu6"), [(1000, "linear")]),                   # V2, ragged batch
    (8, 96, (576, "hswish"), [(1024, "hswish"), (1000, "linear")]),   # V3-Small
    (3, 200, None, [(130, "linear")]),                                # ragged width: padded
    (2, 24, (200, "relu"), []),                                       # no post
])
def test_launch_f32_arguments(n, c, conv_spec, posts):
    """What the float32 wrapper hands the C entry point: as many arguments
    as its signature declares (and the stream), `f32_head_plan`'s numbers,
    the output, and the pooled rows and the first post's rows as disjoint
    16-byte-aligned parts of one scratch allocation."""
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.head import ACTS, _launch_f32

    x = torch.zeros(n, 7, 7, c)
    conv, k = None, c
    if conv_spec is not None:
        conv = (torch.zeros(c, conv_spec[0]), torch.zeros(conv_spec[0]), conv_spec[1])
        k = conv_spec[0]
    post = []
    for m, act in posts:
        post.append((torch.zeros(k, m), torch.zeros(m), act))
        k = m
    lib = _RecordingLibF32()
    out = _launch_f32(lib, x, conv, post, k, 132, 7)
    (args,) = lib.calls
    assert len(args) == len(_build._SIGNATURES["fused_head_f32"]) + 1 and args[-1] == 7
    ptrs, ints = args[:10], args[10:-1]
    (xp, cwp, cbp, w0p, b0p, w1p, b1p, pooled, mid, outp) = ptrs
    (N, hw, C, E, conv_act, n_post, m0, act0, m1, act1, m_out, bm, groups, kp0, kp1) = ints
    assert out.shape == (n, k) and outp == out.data_ptr() and xp == x.data_ptr()
    assert (N, hw, C, m_out, n_post) == (n, 49, c, k, len(posts))
    assert E == (conv_spec[0] if conv_spec else 0)
    assert conv_act == (ACTS[conv_spec[1]] if conv_spec else -1)
    widths = [-(-m // 8) * 8 for m, _ in posts]
    assert [m0, m1][:len(posts)] == widths
    plan = f32_head_plan(n, 49, c, E or None, tuple(widths))
    if conv_spec:
        assert (bm, groups) == (plan.conv.bm, plan.conv.groups)
    assert [kp0, kp1][:len(posts)] == [q.kparts for q in plan.posts]
    assert all(q.narrow == (n <= F32_SMALL_N) for q in plan.posts)
    if posts:
        assert pooled % 16 == 0 and pooled != 0
        if len(posts) == 2:
            assert mid % 16 == 0 and mid >= pooled + 4 * n * plan.ld
    else:
        assert pooled == 0 and mid == 0
