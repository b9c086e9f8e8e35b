"""The float32 separable tile's plan (`ops/separable_block.f32_sep_plan`) and
a NumPy mirror of the kernel's order of work (`csrc/separable_f32.cuh`), on
the CPU: the units cover every output once at V1's block shapes over the
alpha and resolution grid, at batch 1, 2 and 256, at V2's block 0 and the
chain's 14^2 x 512; the window staging holds every in-image tap; each
slice's thread map covers its pixels and columns once with no padded
column; shared memory fits; the rings' handshakes progress at every slot
count; and the mirror, which stages windows, runs the depthwise into the
panel and the products stage by stage as the kernel does, agrees with the
plain version and with the JAX package's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block import separable_block_pallas
from mobilenet_tpu.ops.pallas_block_packed import (
    pack, separable_block_packed, separable_block_packed_s2, unpack,
)
from mobilenet_tpu_torch import ModelConfig
from mobilenet_tpu_torch.ops.separable_block import (
    F32_CONSUMERS, F32_KB, F32_MAX_TMP, F32_RINGS, F32_SMEM_LIMIT, F32_WC, F32SepPlan,
    f32_sep_plan, f32_sep_smem_bytes, f32_slices, f32_threads, separable_block_plain,
)
from mobilenet_tpu_torch.utils.golden import MM_TOL

# the mirror against the plain version: both sum the taps in the same order;
# the products sum over Cin in another order (f32 reassociation, K <= 128)
MIRROR_TOL = dict(atol=3e-5, rtol=1e-5)


def _v1_blocks(alpha, res):
    """(h, cin, cout, stride) of each V1 block at alpha-res."""
    cfg = ModelConfig(alpha, res)
    out, h, cin = [], res // 2, cfg.stem_channels
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        out.append((h, cin, cout, stride))
        h, cin = -(-h // stride), cout
    return out


def geo(n, h, w, cin, cout, stride, p):
    """separable_f32.cuh make_geo's derived sizes of a plan."""
    ho, wo = -(-h // stride), -(-w // stride)
    tmp = -(-p.th * p.tw // (4 * p.mg)) * 4 * p.mg
    rows, tiles_c = n * ho, -(-wo // p.tw)
    tiles = -(-rows // p.th) * tiles_c
    return dict(ho=ho, wo=wo, rows=rows, tiles_c=tiles_c, tiles=tiles, units=tiles * p.split,
                tmp=tmp, tm_t=tmp // (4 * p.mg), pad=1 if stride == 1 else 0,
                ph=(p.th - 1) * stride + 3, pw=(p.tw - 1) * stride + 3)


def geo_ok(n, h, w, cin, cout, stride, p):
    """separable_f32.cuh geo_ok."""
    g = geo(n, h, w, cin, cout, stride, p)
    return (cin % 8 == 0 and cout % 8 == 0 and p.mg in (1, 2) and g["tmp"] <= F32_MAX_TMP
            and p.kp >= F32_WC and p.kp % F32_WC == 0 and p.kp <= -(-cin // F32_WC) * F32_WC
            and p.cw % 8 == 0 and p.split == -(-cout // p.cw) and p.ns >= 8 and p.ns % 8 == 0
            and g["tm_t"] * (p.ns // (4 * p.mg)) <= F32_CONSUMERS and 1 <= p.ws <= 4
            and 1 <= p.bs <= 4
            and f32_sep_smem_bytes(p.mg, p.th, p.tw, p.kp, p.ns, p.ws, p.bs, stride)
            <= F32_SMEM_LIMIT)


def units_of(n, h, w, cin, cout, stride, p):
    """separable_f32.cuh unit_of over every unit, as arrays: the tile's first
    stacked output row R0 and column x0, the part's columns [c0, c1), the
    window origin (sr0, sc0) and its staged rows [ry0, ry1), columns [rx0, rx1)."""
    g = geo(n, h, w, cin, cout, stride, p)
    u = np.arange(g["units"], dtype=np.int64)
    tile, part = u // p.split, u % p.split
    tr = tile // g["tiles_c"]
    r0, x0 = tr * p.th, (tile - tr * g["tiles_c"]) * p.tw
    c0 = part * p.cw
    sr0, sc0 = r0 * stride - g["pad"], x0 * stride - g["pad"]
    return dict(R0=r0, x0=x0, c0=c0, c1=np.minimum(cout, c0 + p.cw), sr0=sr0, sc0=sc0,
                ry0=np.maximum(0, -sr0), ry1=np.minimum(g["ph"], n * h - sr0),
                rx0=np.maximum(0, -sc0), rx1=np.minimum(g["pw"], w - sc0))


def thread_map(mg, tmp, w):
    """The (pixel row, column) pairs each consumer thread's micro-tile holds
    in a slice w columns wide: rows mt*4 + i (+ tmp/2), columns nt*4 + j
    (+ w/2), for the threads below tm_t x tn_t."""
    tn_t, tm_t = w // (4 * mg), tmp // (4 * mg)
    cells = []
    for t in range(F32_CONSUMERS):
        mt, nt = t // tn_t, t % tn_t
        if mt >= tm_t:
            continue
        for i in range(4 * mg):
            for j in range(4 * mg):
                cells.append((mt * 4 + i % 4 + i // 4 * (tmp // 2),
                              nt * 4 + j % 4 + j // 4 * (w // 2)))
    return cells


def check_plan(n, h, cin, cout, stride, p=None):
    """One block's plan against the kernel's rules: it exists and passes
    geo_ok; its tiles cover every output pixel once and its parts' slices
    every column once; every tile's staged window holds the in-image taps
    of its outputs at the right input row; each slice's thread map covers
    its tile's pixels and its columns once (no padded column)."""
    p = p or f32_sep_plan(n, h, h, cin, cout, stride)
    assert geo_ok(n, h, h, cin, cout, stride, p), (n, h, cin, cout, stride, p)
    g = geo(n, h, h, cin, cout, stride, p)
    un = units_of(n, h, h, cin, cout, stride, p)
    first = un["c0"] == 0
    # pixels: a difference grid of the tiles (the part-0 units)
    grid = np.zeros((g["rows"] + p.th + 1, g["wo"] + p.tw + 1), np.int64)
    r0, x0 = un["R0"][first], un["x0"][first]
    np.add.at(grid, (r0, x0), 1)
    np.add.at(grid, (r0 + p.th, x0), -1)
    np.add.at(grid, (r0, x0 + p.tw), -1)
    np.add.at(grid, (r0 + p.th, x0 + p.tw), 1)
    cover = grid.cumsum(0).cumsum(1)[:g["rows"], :g["wo"]]
    assert (cover == 1).all()
    # columns: each tile's parts, each part's slices
    cols = np.zeros(cout, np.int64)
    for c0, c1 in {(int(a), int(b)) for a, b in zip(un["c0"], un["c1"])}:
        sl = f32_slices(c1 - c0, p.ns)
        assert all(wd % 8 == 0 and wd <= p.ns for wd in sl) and sum(sl) == c1 - c0
        cols[c0:c1] += 1
        for wd in sl:
            assert f32_threads(p.mg, g["tmp"], wd) <= F32_CONSUMERS
            cells = thread_map(p.mg, g["tmp"], wd)
            assert len(cells) == len(set(cells)) == g["tmp"] * wd
            assert {c for _, c in cells} == set(range(wd))
    assert (cols == 1).all()
    assert (np.bincount(un["c0"] // p.cw) == g["tiles"]).all()
    # the staged window of every tile, row by row of its outputs: a tap in
    # the image reads window row (R - R0) s + dy, staged, at the stacked input
    # row of its own image
    tile_of_r = np.arange(g["rows"]) // p.th
    rr = np.arange(g["rows"])
    for dy in range(3):
        wr = (rr - tile_of_r * p.th) * stride + dy
        iy = (rr % g["ho"]) * stride - g["pad"] + dy
        ok = (iy >= 0) & (iy < h)
        sr0 = tile_of_r * p.th * stride - g["pad"]
        ry0, ry1 = np.maximum(0, -sr0), np.minimum(g["ph"], n * h - sr0)
        assert ((wr[ok] >= ry0[ok]) & (wr[ok] < ry1[ok])).all()
        assert (sr0[ok] + wr[ok] == (rr[ok] // g["ho"]) * h + iy[ok]).all()
    xx = np.arange(g["wo"])
    for dx in range(3):
        wc = (xx % p.tw) * stride + dx
        ix = xx * stride - g["pad"] + dx
        ok = (ix >= 0) & (ix < h)
        sc0 = xx // p.tw * p.tw * stride - g["pad"]
        rx0, rx1 = np.maximum(0, -sc0), np.minimum(g["pw"], h - sc0)
        assert ((wc[ok] >= rx0[ok]) & (wc[ok] < rx1[ok]) & (sc0[ok] + wc[ok] == ix[ok])).all()
    return p, g


@pytest.mark.parametrize("alpha", [0.25, 0.5, 0.75, 1.0])
def test_plan_covers_every_v1_block(alpha):
    """`check_plan` at every V1 block at 96, 160 and 224 pixels, batch 1, 2
    and 256."""
    for res in (96, 160, 224):
        for n in (1, 2, 256):
            for blk in _v1_blocks(alpha, res):
                check_plan(n, *blk)


@pytest.mark.parametrize("n", [1, 2, 256])
def test_plan_v2_b00_and_the_chain(n):
    """V2 1.0-224's linear block 0 (112^2, 32 -> 16) and the V1 chain's
    blocks (14^2 x 512, stride 1)."""
    check_plan(n, 112, 32, 16, 1)
    check_plan(n, 14, 512, 512, 1)


def test_plan_fills_the_card_at_batch_1():
    """At batch 1 the units of V1 1.0-224's blocks put work on most of the
    132 SMs (the old tile ran the chain's blocks on 16): at least 96 at
    every block (at 28^2 x 256 the card ran 98 units of 4 x 4 pixels faster
    than 112 of 4 x 7), and at least 112 at the 14^2 and 7^2 blocks, the
    chain's among them; at batch 256 on all of them."""
    for h, cin, cout, stride in _v1_blocks(1.0, 224):
        _, g1 = check_plan(1, h, cin, cout, stride)
        assert g1["units"] >= 96 and (h > 14 or g1["units"] >= 112), (h, cin, cout, g1)
        assert check_plan(256, h, cin, cout, stride)[1]["units"] >= 132
    assert check_plan(1, 14, 512, 512, 1)[1]["units"] >= 112


@pytest.mark.parametrize("cout", [16, 64])
def test_no_padded_columns(cout):
    """Cout 16 (V2 b00) and 64 (V1 b00): the stage and every thread's columns
    lie inside the slice (the map covers exactly Cout), at every batch."""
    for n in (1, 2, 256):
        p, g = check_plan(n, 112, 32, cout, 1)
        assert p.ns <= cout and sum(f32_slices(p.cw, p.ns)) * p.split == cout
        assert max(c for _, c in thread_map(p.mg, g["tmp"], min(p.ns, cout))) == \
            min(p.ns, cout) - 1


def test_smem_fits_and_rings():
    """Every plan of the V1 grid fits 227 KB less the stage room, on rings
    of F32_RINGS."""
    for alpha in (0.25, 0.75, 1.0):
        for n in (1, 256):
            for h, cin, cout, stride in _v1_blocks(alpha, 224):
                p = f32_sep_plan(n, h, h, cin, cout, stride)
                assert (p.ws, p.bs) in F32_RINGS
                assert f32_sep_smem_bytes(p.mg, p.th, p.tw, p.kp, p.ns, p.ws, p.bs,
                                          stride) <= F32_SMEM_LIMIT <= 232448


# -- the rings, stepped role by role ------------------------------------------------------


class Bar:
    """An mbarrier: `count` arrivals complete a phase; wait(parity) passes
    once the phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.left, self.done = count, count, 0

    def arrive(self):
        self.left -= 1
        if self.left == 0:
            self.left, self.done = self.count, self.done + 1

    def passed(self, parity):
        return self.done % 2 != parity


class Ring:
    """separable_f32.cuh Ring."""

    def __init__(self):
        self.cur = self.par = 0

    def next(self, slots):
        s = self.cur
        self.cur = 0 if s + 1 == slots else s + 1
        parity = (self.par >> s) & 1
        self.par ^= 1 << s
        return s, parity


def sequence(units, slices, cin, kp):
    """The kernel's ring uses of one run in order: per unit, per slice, per
    range of Cin, its window chunks (every slice where Cin is in ranges,
    else the first) then its weight stages."""
    seq = []
    for u in range(units):
        for s in range(slices):
            for k0 in range(0, cin, kp):
                k1 = min(cin, k0 + kp)
                if kp < cin or s == 0:
                    seq += [("w", (u, s, kc)) for kc in range(k0, k1, F32_WC)]
                seq += [("b", (u, s, kk)) for kk in range(k0, k1, F32_KB)]
    return seq


def ring_walk(runs, ws, bs, lanes=3, consumers=3):
    """Steps the window producer's lanes (each arrives on a window slot's full
    barrier), the weight producer (one arrival a stage) and the consumer
    threads (a few of each: the barriers count them) through the two rings
    over a sequence of runs (the chain's stages restart the cursors). Each
    producer walks the whole order and fills only its ring. Every fill is
    tagged and every read checks its tag; returns False at a deadlock."""
    slots = {"w": ws, "b": bs}
    bars = {"w": [(Bar(lanes), Bar(consumers)) for _ in range(4)],
            "b": [(Bar(1), Bar(consumers)) for _ in range(4)]}
    tags = {r: [None] * 4 for r in slots}

    def producer(mine):
        ring = Ring()
        for ri, seq in enumerate(runs):
            ring.cur = 0
            for r, tag in seq:
                if r != mine:
                    continue
                s, parity = ring.next(slots[r])
                full, empty = bars[r][s]
                while not empty.passed(parity ^ 1):
                    yield False
                tags[r][s] = (ri, tag)
                full.arrive()
                yield True

    def consumer():
        rings = {"w": Ring(), "b": Ring()}
        for ri, seq in enumerate(runs):
            for r in rings.values():
                r.cur = 0
            for ring, tag in seq:
                s, parity = rings[ring].next(slots[ring])
                while not bars[ring][s][0].passed(parity):
                    yield False
                assert tags[ring][s] == (ri, tag)
                bars[ring][s][1].arrive()
                yield True

    live = ([producer("w") for _ in range(lanes)] + [producer("b")]
            + [consumer() for _ in range(consumers)])
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


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
@pytest.mark.parametrize("bs", [1, 2, 3, 4])
def test_rings_progress(ws, bs):
    """Every slot count: units and chunks below, at and past the slots, one
    and several slices, Cin whole and in ranges, one run and a chain of
    three stages."""
    for units in (1, 3):
        for slices, cin, kp in ((1, 64, 64), (2, 96, 96), (3, 160, 64), (1, 8, 32),
                                (2, 40, 32)):
            seq = sequence(units, slices, cin, kp)
            assert ring_walk([seq], ws, bs)
            assert ring_walk([seq, seq, seq], ws, bs)


# -- the NumPy mirror of the kernel's order of work ---------------------------------------


def _act(v, relu6):
    v = np.maximum(v, np.float32(0))
    return np.minimum(v, np.float32(6)) if relu6 else v


def mirror(x, dw_w, dw_b, pw_w, pw_b, stride, relu6, pw_act, p):
    """float32 NumPy of the kernel on plan p: each unit stages its window
    chunk by chunk (in-image pixels of the stacked input only; the rest NaN,
    so a read of an unstaged pixel shows), runs the depthwise of each chunk's
    channel quads at the kernel's window offsets and tap masks (taps summed
    dy then dx from 0, + bias, act; zeros for pixels outside the output)
    into the K-major panel, and the products stage by stage (32 rows, k
    ascending) into each slice's accumulators, then + bias, act, and stores
    the pixels that lie in the output."""
    n, h, w, cin = x.shape
    cout = pw_w.shape[1]
    g = geo(n, h, w, cin, cout, stride, p)
    un = units_of(n, h, w, cin, cout, stride, p)
    xs = x.reshape(n * h, w, cin)
    dws = dw_w.reshape(9, cin)
    out = np.full((g["rows"] * g["wo"], cout), np.nan, np.float32)
    m = np.arange(g["tmp"])
    r, c = m // p.tw, m % p.tw
    for u in range(g["units"]):
        r0, x0 = int(un["R0"][u]), int(un["x0"][u])
        sr0, sc0 = int(un["sr0"][u]), int(un["sc0"][u])
        ry0, ry1, rx0, rx1 = (int(un[k][u]) for k in ("ry0", "ry1", "rx0", "rx1"))
        rr, xo = r0 + r, x0 + c
        live = (m < p.th * p.tw) & (rr < g["rows"]) & (xo < g["wo"])
        iy = (rr % g["ho"]) * stride - g["pad"]
        ix = xo * stride - g["pad"]
        c0 = int(un["c0"][u])
        for wd in f32_slices(int(un["c1"][u]) - c0, p.ns):
            acc = np.zeros((g["tmp"], wd), np.float32)
            for k0 in range(0, cin, p.kp):
                k1 = min(cin, k0 + p.kp)
                if p.kp < cin or c0 == int(un["c0"][u]):
                    panel = np.full((k1 - k0, g["tmp"]), np.nan, np.float32)
                    for kc in range(k0, k1, F32_WC):
                        ce = min(k1, kc + F32_WC)
                        win = np.full((g["ph"], g["pw"], ce - kc), np.nan, np.float32)
                        win[ry0:ry1, rx0:rx1] = xs[sr0 + ry0:sr0 + ry1, sc0 + rx0:sc0 + rx1,
                                                   kc:ce]
                        a = np.zeros((g["tmp"], ce - kc), np.float32)
                        for dy in range(3):
                            for dx in range(3):
                                tap = (live & (iy + dy >= 0) & (iy + dy < h) & (ix + dx >= 0)
                                       & (ix + dx < w))
                                z = np.zeros((g["tmp"], ce - kc), np.float32)
                                wy = np.where(tap, r * stride + dy, 0)
                                wx = np.where(tap, c * stride + dx, 0)
                                z[tap] = win[wy[tap], wx[tap]]
                                a = a + z * dws[dy * 3 + dx, kc:ce]
                        v = _act(a + dw_b[kc:ce], relu6)
                        panel[kc - k0:ce - k0] = np.where(live[:, None], v, 0).T
                for kk in range(k0, k1, F32_KB):
                    for k in range(kk, min(k1, kk + F32_KB)):
                        acc = acc + panel[k - k0][:, None] * pw_w[k, c0:c0 + wd][None, :]
            y = acc + pw_b[c0:c0 + wd]
            if pw_act:
                y = _act(y, relu6)
            out[(rr * g["wo"] + xo)[live], c0:c0 + wd] = y[live]
            c0 += wd
    assert not np.isnan(out).any()
    return out.reshape(n, g["ho"], g["wo"], cout)


def _inputs(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, h, w, cin)).astype(np.float32),
            rng.normal(0, 0.5, (3, 3, 1, cin)).astype(np.float32),
            rng.normal(0, 0.2, (cin,)).astype(np.float32),
            rng.normal(0, 0.3, (cin, cout)).astype(np.float32),
            rng.normal(0, 0.2, (cout,)).astype(np.float32))


def _plain(arrs, stride, relu6=True, pw_act=True):
    return separable_block_plain(*[torch.from_numpy(a) for a in arrs], stride, relu6,
                                 pw_act).numpy()


# n, h, w, cin, cout, stride: Cin 8/24/40 (a chunk of 8 live channels),
# odd Wo at stride 1, stride 2 on even sides, V1 b00/b01's classes, the
# chain's width, several images a tile
MIRROR_SHAPES = [(2, 16, 16, 32, 64, 1), (2, 16, 16, 64, 128, 2), (2, 13, 13, 24, 40, 1),
                 (1, 16, 14, 40, 24, 2), (2, 9, 11, 8, 16, 1), (3, 4, 4, 128, 128, 1),
                 (1, 7, 7, 512, 64, 1)]


@pytest.mark.parametrize("n,h,w,cin,cout,stride", MIRROR_SHAPES)
def test_mirror_equals_plain(n, h, w, cin, cout, stride):
    """The mirror on the plan the kernel gets (at batch 256's rules too:
    the plan of the shape) against separable_block_plain, ReLU6 and the
    linear projection."""
    arrs = _inputs(cin + cout + h, n, h, w, cin, cout)
    p = f32_sep_plan(n, h, w, cin, cout, stride)
    if h == w:
        check_plan(n, h, cin, cout, stride, p)
    for relu6, pw_act in ((True, True), (False, False)):
        np.testing.assert_allclose(mirror(*arrs, stride, relu6, pw_act, p),
                                   _plain(arrs, stride, relu6, pw_act), **MIRROR_TOL)


# plans no V1 shape gets at these sizes: Cin in ranges with several slices
# and parts, the 4 x 4 form, one-slot rings
FORCED = [((2, 12, 12, 48, 40, 1), F32SepPlan(2, 4, 8, 32, 2, 24, 16, 1, 1)),
          ((1, 12, 12, 64, 48, 2), F32SepPlan(1, 3, 4, 32, 1, 48, 16, 2, 2)),
          ((2, 7, 7, 40, 32, 1), F32SepPlan(1, 9, 7, 32, 4, 8, 8, 4, 3)),
          ((1, 10, 10, 16, 24, 2), F32SepPlan(2, 5, 5, 32, 1, 24, 8, 3, 2))]


@pytest.mark.parametrize("shape,p", FORCED)
def test_mirror_forced_plans(shape, p):
    n, h, w, cin, cout, stride = shape
    assert geo_ok(n, h, w, cin, cout, stride, p)
    check_plan(n, h, cin, cout, stride, p)
    arrs = _inputs(cin * cout, *shape[:5])
    np.testing.assert_allclose(mirror(*arrs, stride, True, True, p), _plain(arrs, stride),
                               **MIRROR_TOL)


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("n,h,cin,cout,stride", [(2, 16, 64, 128, 1), (2, 16, 128, 64, 2),
                                                 (2, 14, 24, 40, 1)])
def test_mirror_vs_pallas(n, h, cin, cout, stride):
    arrs = _inputs(7 * cin + stride, n, h, h, cin, cout)
    ref = separable_block_pallas(*_jax(arrs), stride, True, interpret=True)
    got = mirror(*arrs, stride, True, True, f32_sep_plan(n, h, h, cin, cout, stride))
    atol, rtol = MM_TOL
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("stride,cin,cout,linear", [(1, 32, 64, False), (1, 32, 32, True),
                                                    (2, 64, 128, False)])
def test_mirror_vs_packed(stride, cin, cout, linear):
    """V1 b00's and b01's classes and a linear projection against the
    lane-packed kernels in interpret mode."""
    arrs = _inputs(cin + cout, 2, 16, 16, cin, cout)
    x, *wts = _jax(arrs)
    kern = separable_block_packed if stride == 1 else separable_block_packed_s2
    ref = unpack(kern(pack(x, cin), *wts, cin, cout, True, pw_epilogue=not linear,
                      interpret=True), cout)
    got = mirror(*arrs, stride, True, not linear, f32_sep_plan(2, 16, 16, cin, cout, stride))
    atol, rtol = MM_TOL
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol, rtol=rtol)
