"""The stem kernels' plans and NumPy mirrors of their order of work, on the
CPU: bf16 (`ops/stem.stem_plan`, `csrc/stem_wgmma.cuh`) below, float32
(`f32_stem_plan`, `csrc/stem_f32.cuh`) in the section that closes the file.

The plan is pinned at V1 1.0-224 (batch 256 and 1) and at the card tests'
odd and ragged sizes, and its shared memory stays within a block's limit.
The mirror copies the kernels' addressing: the window staged as the 16-byte
granules that hold each row (from a tensor at any byte offset) with each
row's offset beside it, the gather of a stem pixel's 27 taps in (dy, dx, c)
order and 5 zero columns into a row of the 128-byte-swizzled K-major A
panel (`store_row`), the resident weight in 8-column blocks without swizzle
(`load_b`); wgmma's reads of both through their descriptors (the 128-byte
swizzle as the XOR of address bits 4-6 with bits 7-9, LBO and SBO of the
weight's blocks); and for stem_block0 its exact stem (an FMA chain a
channel, taps in (dy, dx, c) order), the f32 stem tile's chunk swizzle, the
depthwise's column strips and its writes into the pointwise's A panel. Its
outputs are held against the plain versions and the JAX package's Pallas
stem kernels in interpret mode, within chip_smoke.py's bf16 tolerance (the
products' f32 sum order differs from the plain versions' only); the mirror
of stem_block0's stem and depthwise, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import unpack
from mobilenet_tpu.ops.pallas_stem import stem_conv_packed
from mobilenet_tpu.ops.pallas_stem_b0 import stem_block0_fused
from mobilenet_tpu_torch.config import PREPROCESS_OFFSET, PREPROCESS_SCALE
from mobilenet_tpu_torch.ops.separable_block import SMEM_LIMIT
from mobilenet_tpu_torch.ops.stem import (
    A_ROW, B_BLOCK, HALO_W, K, STEP, StemPlan, stem_block0_plain, stem_conv_plain, stem_plan,
    stem_smem_bytes,
)

# chip_smoke.py's BF16_ATOL/RTOL: the f32 sums differ in order, and a last
# bit can move a bf16 rounding of the stem or the depthwise by one step,
# which the next stage carries.
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)


@pytest.mark.parametrize("args,want", [
    # V1 1.0-224: stem_conv on whole stem rows, 4 x 112 (3.5 steps of 128)
    ((256, 224, 224, 32, False), StemPlan(4, 112, 1, 7168, 3, 396, 60744)),
    ((1, 224, 224, 32, False), StemPlan(1, 112, 1, 112, 4, 112, 44184)),
    # stem_block0: 12 x 16 outputs (a 14 x 18 halo tile: a stem pixel a
    # thread) at batch 256, 6 x 16 at batch 1
    ((256, 224, 224, 64, True), StemPlan(12, 16, 2, 17920, 2, 264, 73320)),
    ((1, 224, 224, 64, True), StemPlan(6, 16, 2, 133, 2, 133, 48136)),
    # the card tests' odd sides (TF-SAME pads 1, 1) and ragged tiles
    ((2, 37, 45, 32, False), StemPlan(1, 23, 1, 38, 4, 38, 37752)),
    ((1, 225, 224, 16, False), StemPlan(1, 112, 1, 113, 4, 113, 43128)),
    ((2, 225, 223, 32, False), StemPlan(1, 112, 1, 226, 4, 226, 44184)),
    ((1, 16, 16, 256, False), StemPlan(1, 8, 1, 8, 4, 8, 51480)),
    ((3, 40, 52, 16, True), StemPlan(6, 16, 2, 24, 2, 24, 44968)),
    # partial persistent waves (tiles above the grid)
    ((16, 224, 224, 32, False), StemPlan(4, 112, 1, 448, 3, 396, 60744)),
    ((6, 224, 224, 64, True), StemPlan(12, 16, 2, 420, 2, 264, 73320)),
])
def test_stem_plan_pinned(args, want):
    assert stem_plan(*args) == want


@pytest.mark.parametrize("block0", [False, True])
def test_stem_plan_smem_within_limit(block0):
    """Every plan's shared memory stays within a block's 227 KB, and its
    blocks an SM within the SM's 228 KB; stem_block0 refuses a Cout whose
    resident weight would not fit (it raises, never falls back)."""
    couts = (8, 16, 24, 32, 64, 128, 256) if not block0 else (8, 16, 64, 128, 512, 1024)
    for n, h, w in ((1, 224, 224), (256, 224, 224), (2, 37, 45), (1, 640, 480), (3, 40, 52)):
        if block0 and (h % 2 or w % 2):
            continue
        for cout in couts:
            p = stem_plan(n, h, w, cout, block0)
            assert p.smem == stem_smem_bytes(block0, p.th, p.tw, cout) <= SMEM_LIMIT
            assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= 233472
            assert 1 <= p.grid <= p.tiles
    if block0:
        with pytest.raises(ValueError, match="shared memory"):
            stem_plan(1, 224, 224, 4096, True)


# -- the NumPy mirror -------------------------------------------------------------


def _bits(a) -> np.ndarray:
    """float32 -> bf16 bit patterns, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _f32(bits) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _rb(a) -> np.ndarray:
    return _f32(_bits(a))


def _act(a, relu6):
    a = np.maximum(a, np.float32(0))
    return np.minimum(a, np.float32(6)) if relu6 else a


def _flat(raw: np.ndarray, base: int) -> np.ndarray:
    """The tensor's bytes at byte `base` of a buffer of whole 16-byte
    granules (the kernel may load any granule that holds one of its bytes)."""
    data = raw.view(np.uint8).ravel()
    buf = np.zeros(-(-(base + data.size) // 16) * 16, np.uint8)
    buf[base:base + data.size] = data
    return buf


def _stage(buf, base, n, h, w, pb, r0, wr, c0, wc):
    """stage_window: each row's granules (the rest of the row garbage) and
    its offset in the first, or -1 outside the image."""
    cs, ce = max(c0, 0), min(c0 + wc, w)
    pitch = 16 * (-(-wc * pb // 16) + 1)
    win = np.full((wr, pitch), 0xA5, np.uint8)
    roff = np.full(wr, -1)
    for r in range(wr):
        hi = r0 + r
        if not 0 <= hi < h:
            continue
        s = base + ((n * h + hi) * w + cs) * pb
        e = s + (ce - cs) * pb
        count = ((e - 1) >> 4) - (s >> 4) + 1
        assert count * 16 <= pitch
        roff[r] = s & 15
        win[r, :count * 16] = buf[(s & ~15):(s & ~15) + count * 16]
    return win, roff, cs


def _gather(win, roff, w, pb, wr0, wi0, cs, get) -> np.ndarray:
    """A stem pixel's A row: 27 taps in (dy, dx, c) order, then 5 zeros
    (bf16 bits)."""
    h = np.zeros(K, np.uint16)
    for dy in range(3):
        off = roff[wr0 + dy]
        for dx in range(3):
            wi = wi0 + dx
            if off < 0 or not 0 <= wi < w:
                continue
            for c in range(3):
                h[(dy * 3 + dx) * 3 + c] = get(win[wr0 + dy], off + (wi - cs) * pb, c)
    return h


def _store_row(a: np.ndarray, m: int, h: np.ndarray) -> None:
    """store_row: 16-byte chunk j (K 8j..8j+7) of row m at chunk j ^ (m % 8)."""
    hb = h.view(np.uint8)
    for j in range(4):
        p = m * A_ROW + ((j ^ (m & 7)) << 4)
        a[p:p + 16] = hb[16 * j:16 * j + 16]


def _read_a(a: np.ndarray, m0: int) -> np.ndarray:
    """wgmma's A (64 rows from row m0, K 32) through its descriptors: start
    m0 * 128 + 32 k for K step k, 8-row groups 1024 bytes apart, the 128-byte
    swizzle XOR-ing address bits 4-6 with bits 7-9."""
    out = np.zeros((64, K), np.uint16)
    for k in range(2):
        start = m0 * A_ROW + 32 * k
        for i in range(64):
            for kk in range(16):
                lin = start + (i // 8) * 1024 + (i % 8) * 128 + 2 * kk
                phys = lin ^ (((lin >> 7) & 7) << 4)
                out[i, 16 * k + kk] = a[phys:phys + 2].view(np.uint16)[0]
    return out


def _load_b(wbits: np.ndarray) -> np.ndarray:
    """load_b: a (rows <= 32, cols) weight into 8-column blocks of 32 K
    rows x 16 bytes; rows past `rows` zero."""
    rows, cols = wbits.shape
    b = np.full(cols // 8 * B_BLOCK, 0xFF, np.uint8)
    for k in range(K):
        for n in range(cols):
            v = wbits[k, n] if k < rows else 0
            p = (n >> 3) * B_BLOCK + k * 16 + (n & 7) * 2
            b[p:p + 2] = np.array([v], np.uint16).view(np.uint8)
    return b


def _read_b(b: np.ndarray, col0: int, ncol: int) -> np.ndarray:
    """wgmma's B (32 x ncol from column col0) through its descriptors: start
    + (col0 / 8) * 512 + 256 k, LBO 128 (8 K rows), SBO 512 (8 columns)."""
    out = np.zeros((K, ncol), np.uint16)
    for k in range(2):
        start = (col0 >> 3) * B_BLOCK + 256 * k
        for kk in range(16):
            for nn in range(ncol):
                p = start + (nn // 8) * B_BLOCK + (kk // 8) * 128 + (kk % 8) * 16 + (nn % 8) * 2
                out[16 * k + kk, nn] = b[p:p + 2].view(np.uint16)[0]
    return out


def _product(a: np.ndarray, b: np.ndarray, m0: int, cout: int) -> np.ndarray:
    """d (64 x Cout) in f32 over the slices of 64, then 32, 16 and 8 columns."""
    d, col = np.zeros((64, cout), np.float32), 0
    av = _f32(_read_a(a, m0))
    while col < cout:
        n = next(w for w in (64, 32, 16, 8) if cout - col >= w)
        d[:, col:col + n] = av @ _f32(_read_b(b, col, n))
        col += n
    return d


def _bf16_get(row, p, c):
    return row[p + 2 * c:p + 2 * c + 2].view(np.uint16)[0]


def _norm_get(row, p, c):
    v = np.float32(row[p + c]) * np.float32(PREPROCESS_SCALE) + np.float32(PREPROCESS_OFFSET)
    return _bits(np.float32(v)).reshape(-1)[0]


def conv_mirror(x_bits: np.ndarray, w_bits, b_bits, relu6, base, plan) -> np.ndarray:
    """stem_conv's bf16 kernel: x (N, H, W, 3) bf16 bits at byte `base`."""
    n_, h, w, _ = x_bits.shape
    cout = w_bits.shape[-1]
    hs, ws, pt, pl = -(-h // 2), -(-w // 2), h % 2, w % 2
    th, tw = plan.th, plan.tw
    buf = _flat(x_bits, base)
    b = _load_b(w_bits.reshape(27, cout))
    bias = _f32(b_bits)
    out = np.full((n_, hs, ws, cout), np.nan, np.float32)
    th_n, tw_n = -(-hs // th), -(-ws // tw)
    for t in range(n_ * th_n * tw_n):
        n, rest = divmod(t, th_n * tw_n)
        t0, u0 = (rest // tw_n) * th, (rest % tw_n) * tw
        r0, c0 = 2 * t0 - pt, 2 * u0 - pl
        win, roff, cs = _stage(buf, base, n, h, w, 6, r0, 2 * th + 1, c0, 2 * tw + 1)
        npix = th * tw
        a = np.zeros(-(-npix // STEP) * STEP * A_ROW, np.uint8)
        for m in range(npix):
            ih, iw = divmod(m, tw)
            _store_row(a, m, _gather(win, roff, w, 6, 2 * ih, c0 + 2 * iw, cs, _bf16_get))
        for m0 in range(0, npix, 64):
            d = _product(a, b, m0, cout)
            for i in range(64):
                m = m0 + i
                ih, iw = divmod(m, tw)
                ho, wo = t0 + ih, u0 + iw
                if m < npix and ho < hs and wo < ws:
                    out[n, ho, wo] = _rb(_act(d[i] + bias, relu6))
    return out


def _b0_stem(img, sw, sb, relu6, base, plan):
    """stem_block0's stem tiles: for each tile, the f32 stem tile (halo pixel
    q's chunk j, channels 4j..4j+3, at j ^ (q % 8)), by the kernel's walk:
    the window staged as granules, each halo pixel's 27 taps normalized as
    they are gathered, an FMA chain a channel in (dy, dx, c) order (a bf16
    product is exact in f32: a multiply then an add), + bias, activation,
    rounded; 0 outside the stem grid."""
    n_, h, w, _ = img.shape
    hs, ws, th = h // 2, w // 2, plan.th
    hp = (th + 2) * HALO_W
    buf = _flat(img, base)
    wf, bf = _f32(sw).reshape(27, K), _f32(sb)
    th_n, tw_n = -(-hs // th), -(-ws // 16)
    for t in range(n_ * th_n * tw_n):
        n, rest = divmod(t, th_n * tw_n)
        t0, u0 = (rest // tw_n) * th, (rest % tw_n) * 16
        c0 = 2 * (u0 - 1)
        win, roff, cs = _stage(buf, base, n, h, w, 3, 2 * (t0 - 1), 2 * (th + 2) + 1, c0,
                               2 * HALO_W + 1)
        stem = np.zeros(hp * K, np.float32)
        for m in range(hp):
            hr, hc = divmod(m, HALO_W)
            i, j = t0 - 1 + hr, u0 - 1 + hc
            if not (0 <= i < hs and 0 <= j < ws):
                continue
            taps = _f32(_gather(win, roff, w, 3, 2 * hr, c0 + 2 * hc, cs, _norm_get))
            acc = np.zeros(K, np.float32)
            for k in range(27):
                acc = acc + taps[k] * wf[k]
            v = _rb(_act(acc + bf, relu6))
            for jc in range(8):
                p = m * K + ((jc ^ (m & 7)) << 2)
                stem[p:p + 4] = v[4 * jc:4 * jc + 4]
        yield n, t0, u0, stem


def b0_mirror(img: np.ndarray, wb, relu6, base, plan) -> np.ndarray:
    """stem_block0's bf16 kernel: uint8 images at byte `base`; wb the six
    weights' bf16 bits."""
    n_, h, w, _ = img.shape
    sw, sb, dw, db, pw, pb = wb
    cout = pw.shape[-1]
    hs, ws, th = h // 2, w // 2, plan.th
    bp = _load_b(pw)
    dwf, dbf, pbf = _f32(dw).reshape(9, K), _f32(db), _f32(pb)
    out = np.full((n_, hs, ws, cout), np.nan, np.float32)
    for n, t0, u0, stem in _b0_stem(img, sw, sb, relu6, base, plan):
        # the depthwise, a thread's column strip of th / 2 pixels and its 4
        # channels, into the pointwise's A panel
        a = np.zeros(-(-th * 16 // 64) * 64 * A_ROW, np.uint8)
        for t_id in range(256):
            j, strip = t_id & 7, t_id >> 3
            iw, ih0 = strip & 15, (strip >> 4) * (th // 2)
            for y in range(th // 2):
                acc = np.zeros(4, np.float32)
                for dy in range(3):
                    for dx in range(3):
                        q = (ih0 + y + dy) * HALO_W + iw + dx
                        p = q * K + ((j ^ (q & 7)) << 2)
                        acc = acc + stem[p:p + 4] * dwf[dy * 3 + dx, 4 * j:4 * j + 4]
                m = (ih0 + y) * 16 + iw
                v = _bits(_act(acc + dbf[4 * j:4 * j + 4], relu6))
                p = m * A_ROW + (((j >> 1) ^ (m & 7)) << 4) + (j & 1) * 8
                a[p:p + 8] = v.view(np.uint8)
        for m0 in range(0, th * 16, 64):
            d = _product(a, bp, m0, cout)
            for i in range(64):
                m = m0 + i
                ho, wo = t0 + m // 16, u0 + m % 16
                if m < th * 16 and ho < hs and wo < ws:
                    out[n, ho, wo] = _rb(_act(d[i] + pbf, relu6))
    return out


@pytest.mark.parametrize("n,h,w,cout,relu6,base", [
    (2, 32, 32, 32, True, 0),     # even sides, whole-row tiles
    (1, 33, 17, 16, False, 6),    # odd sides: TF-SAME pads (1, 1); a base 6 bytes in
    (2, 19, 26, 24, True, 10),    # odd rows, slices of 16 + 8 columns
])
def test_conv_mirror(n, h, w, cout, relu6, base):
    """The layout mirror of the bf16 stem_conv against stem_conv_plain and,
    on even sides, stem_conv_packed in interpret mode."""
    rng = np.random.default_rng(h * w + cout)
    x = _rb(rng.uniform(-1, 1, (n, h, w, 3)))
    x[:, -1] = 1
    x[:, :, -1] = 1
    wt, b = _rb(rng.normal(0, 0.8, (3, 3, 3, cout))), _rb(rng.normal(0, 0.2, (cout,)))
    plan = stem_plan(n, h, w, cout, False)
    got = conv_mirror(_bits(x), _bits(wt), _bits(b), relu6, base, plan)
    assert np.isfinite(got).all()
    tb = [torch.from_numpy(a).bfloat16() for a in (x, wt, b)]
    ref = stem_conv_plain(*tb, relu6).float().numpy()
    np.testing.assert_allclose(got, ref, **BF16_TOL)
    if relu6:
        assert 0 < (ref == 6).mean() < 1
    if h % 2 == 0 and w == h:
        jx = stem_conv_packed(*[jnp.asarray(a, jnp.bfloat16) for a in (x, wt, b)], cout, relu6,
                              interpret=True)
        np.testing.assert_allclose(got, np.asarray(jx, np.float32), **BF16_TOL)


@pytest.mark.parametrize("n,h,w,cout,relu6,base", [
    (1, 32, 32, 64, True, 0),    # 6 x 16 tiles: 3 tile rows (the last ragged), 2 columns
    (1, 20, 36, 16, False, 5),   # ragged tiles at both edges; a base 5 bytes in
])
def test_b0_mirror(n, h, w, cout, relu6, base):
    """The layout mirror of the bf16 stem_block0 against stem_block0_plain
    and, on square sides, unpack(stem_block0_fused) in interpret mode. The
    last input row and column are 255, beside the stem's pad."""
    rng = np.random.default_rng(h * w + cout)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img[:, -1] = 255
    img[:, :, -1] = 255
    wf = [_rb(rng.normal(0, s, shape)) for s, shape in (
        (0.4 * 3, (3, 3, 3, 32)), (0.2, (32,)), (0.5 * 3, (3, 3, 1, 32)), (0.2, (32,)),
        (3 * 32 ** -0.5, (32, cout)), (0.2, (cout,)))]
    plan = stem_plan(n, h, w, cout, True)
    got = b0_mirror(img, [_bits(a) for a in wf], relu6, base, plan)
    assert np.isfinite(got).all()
    # the stem, bit for bit (tile by tile, inside the stem grid)
    x = torch.from_numpy(img).float() * PREPROCESS_SCALE + PREPROCESS_OFFSET
    stem_ref = stem_conv_plain(x.bfloat16(), *[torch.from_numpy(a).bfloat16() for a in wf[:2]],
                               relu6).float().numpy()
    for n_i, t0, u0, stem in _b0_stem(img, _bits(wf[0]), _bits(wf[1]), relu6, base, plan):
        for hr in range(plan.th + 2):
            for hc in range(HALO_W):
                i, j = t0 - 1 + hr, u0 - 1 + hc
                if 0 <= i < h // 2 and 0 <= j < w // 2:
                    q = hr * HALO_W + hc
                    got_q = np.concatenate([stem[q * K + ((c ^ (q & 7)) << 2):][:4]
                                            for c in range(8)])
                    np.testing.assert_array_equal(got_q, stem_ref[n_i, i, j])
    ref = stem_block0_plain(torch.from_numpy(img), *[torch.from_numpy(a).bfloat16() for a in wf],
                            relu6).float().numpy()
    np.testing.assert_allclose(got, ref, **BF16_TOL)
    if h == w:
        jx = unpack(stem_block0_fused(jnp.asarray(img), *[jnp.asarray(a, jnp.bfloat16) for a in wf],
                                      cout, relu6, interpret=True), cout)
        np.testing.assert_allclose(got, np.asarray(jx, np.float32), **BF16_TOL)


# -- the float32 kernels (csrc/stem_f32.cuh) ------------------------------------------
#
# Their plan (`f32_stem_plan`, `f32_stem_smem_bytes`) pinned, and a NumPy
# mirror of their order of work: stem_conv's window staged row by row (16-byte
# granules where the row and its slot are 16-byte aligned, else single
# floats; the pad zero-filled), its 8-pixel strips read as float4 loads and
# taken column by column, the consumer groups' walk over the strips;
# stem_block0's units of chunks down a 16-column band, each chunk's uint8
# granules normalized into a float32 window, its new stem rows (6-pixel
# strips) into the stem tile's rows in turn, each warp's depthwise block
# sliding down its rows into the K-major depthwise tile and its pointwise
# micro-tiles (one or two rows of 4 pixels x channels 4q.. and Cout/2 +
# 4q..) over the weight's 4-column blocks. The stem and the depthwise are held bit for bit
# against the plain versions' stages; the outputs against the plain versions
# and the JAX package's kernels in interpret mode within
# tests/test_torch_stem.py's float32 tolerance (the pointwise's fmaf sums
# round otherwise).

from mobilenet_tpu_torch.ops.conv import apply_activation, dw_taps_f32  # noqa: E402
from mobilenet_tpu_torch.ops.preprocess import normalize  # noqa: E402
from mobilenet_tpu_torch.ops.stem import (  # noqa: E402
    F32_B0_TW, F32_CONV_P, F32StemPlan, _stem_taps_f32, f32_stem_plan, f32_stem_smem_bytes,
)

F32_TOL = dict(atol=3e-5, rtol=1e-5)  # tests/test_torch_stem.py's
B0_P, B0_HW = 6, F32_B0_TW + 2  # stem_block0's stem strip, stem columns a tile computes
B0_PITCH, B0_DP, B0_WB = 3 * (2 * B0_HW + 1) + 1, 16 * F32_B0_TW + 4, 4 * K + 4


@pytest.mark.parametrize("args,want", [
    # V1 1.0-224 stem_conv: 4 whole stem rows a tile at batch 256; at batch
    # 2 and 1 smaller tiles, so that they number one an SM at least
    ((256, 224, 224, 32, False), F32StemPlan(4, 112, 1, 7168, 2, 264, 48736)),
    ((2, 224, 224, 32, False), F32StemPlan(4, 32, 1, 224, 2, 224, 14176)),
    ((1, 224, 224, 32, False), F32StemPlan(2, 32, 1, 224, 2, 224, 7904)),
    # stem_block0 at 1.0-160 (the float32 route's size) and 1.0-224: 16 x 16
    # tiles, a unit 5 (7) tiles down its band at batch 256
    ((256, 160, 160, 64, True), F32StemPlan(16, 16, 5, 1280, 2, 264, 114736)),
    ((2, 160, 160, 64, True), F32StemPlan(4, 16, 1, 200, 2, 200, 70000)),
    ((1, 160, 160, 64, True), F32StemPlan(2, 16, 1, 200, 2, 200, 62544)),
    ((256, 224, 224, 64, True), F32StemPlan(16, 16, 7, 1792, 2, 264, 114736)),
    ((2, 224, 224, 64, True), F32StemPlan(8, 16, 1, 196, 2, 196, 84912)),
    ((1, 224, 224, 64, True), F32StemPlan(4, 16, 1, 196, 2, 196, 70000)),
    # the card tests' odd sides, ragged tiles, Cout 8-1024 and partial waves
    ((2, 37, 45, 32, False), F32StemPlan(1, 8, 1, 114, 2, 114, 1312)),
    ((1, 225, 224, 16, False), F32StemPlan(2, 32, 1, 228, 2, 228, 7904)),
    ((2, 225, 223, 32, False), F32StemPlan(4, 32, 1, 232, 2, 232, 14176)),
    ((1, 16, 16, 256, False), F32StemPlan(1, 8, 1, 8, 2, 8, 1312)),
    ((1, 640, 480, 256, False), F32StemPlan(4, 120, 1, 160, 2, 160, 52192)),
    ((16, 224, 224, 32, False), F32StemPlan(4, 112, 1, 448, 2, 264, 48736)),
    ((3, 40, 52, 16, True), F32StemPlan(2, 16, 1, 60, 2, 60, 56016)),
    ((6, 224, 224, 64, True), F32StemPlan(16, 16, 1, 294, 2, 264, 114736)),
    ((64, 160, 160, 64, True), F32StemPlan(16, 16, 5, 320, 2, 264, 114736)),
    ((1, 224, 224, 1024, True), F32StemPlan(4, 16, 1, 196, 1, 132, 200560)),
])
def test_f32_stem_plan_pinned(args, want):
    assert f32_stem_plan(*args) == want


@pytest.mark.parametrize("block0", [False, True])
def test_f32_stem_plan_smem_within_limit(block0):
    """Every float32 plan's shared memory stays within a block's 227 KB and
    its blocks an SM within the SM's 228 KB; its work covers the stem grid
    (stem_conv: tiles of tw a multiple of 8; stem_block0: units of cpu
    tiles down each 16-column band); stem_block0 refuses a Cout whose
    resident weight fits no tile (it raises, never falls back)."""
    couts = (8, 16, 24, 32, 64, 128, 256) if not block0 else (8, 16, 64, 128, 512, 1024)
    for n, h, w in ((1, 224, 224), (256, 224, 224), (256, 160, 160), (2, 37, 45), (1, 640, 480),
                    (3, 40, 52), (2, 2, 2)):
        if block0 and (h % 2 or w % 2):
            continue
        for cout in couts:
            p = f32_stem_plan(n, h, w, cout, block0)
            assert p.smem == f32_stem_smem_bytes(block0, p.th, p.tw, cout) <= SMEM_LIMIT
            assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= 233472
            assert 1 <= p.grid <= p.units
            hs, ws = (h // 2, w // 2) if block0 else (-(-h // 2), -(-w // 2))
            tiles_h, tiles_w = -(-hs // p.th), -(-ws // p.tw)
            assert p.units == n * tiles_w * -(-tiles_h // p.cpu) and p.cpu <= max(1, tiles_h)
            if block0:
                assert p.tw == F32_B0_TW and p.th in (16, 8, 4, 2)
            else:
                assert p.tw % F32_CONV_P == 0 and p.cpu == 1
    if block0:
        with pytest.raises(ValueError, match="shared memory"):
            f32_stem_plan(1, 224, 224, 1600, True)


def _act32(a, relu6):
    a = np.maximum(a, np.float32(0))
    return np.minimum(a, np.float32(6)) if relu6 else a


def _stem_strip(win, row, col, wt, P):
    """stem_strip<P>: the strip's three window rows as float4 loads from
    float `col` of window row `row`, the columns taken in order; each
    output's taps in (dy, dx, c) order, a float32 multiply then an add.
    wt (27, C) -> (P, C)."""
    nv = ((2 * P + 1) * 3 + 3) // 4
    acc = np.zeros((P, wt.shape[1]), np.float32)
    for dy in range(3):
        assert col % 4 == 0 and col + 4 * nv <= win.shape[1]
        v = win[row + dy, col:col + 4 * nv]
        for j in range(2 * P + 1):
            for dx in range(3):
                if (j - dx) % 2 or j < dx or (j - dx) // 2 >= P:
                    continue
                p = (j - dx) // 2
                for c in range(3):
                    acc[p] = acc[p] + v[3 * j + c] * wt[(dy * 3 + dx) * 3 + c]
    return acc


def f32_conv_mirror(x: np.ndarray, wt, b, relu6, base, plan, paths=None) -> np.ndarray:
    """stem_conv's float32 kernel: x (N, H, W, 3) float32 at byte `base` (a
    multiple of 4) of device memory; `paths` counts the rows staged by
    16-byte granules ("vec") and by single floats ("scalar")."""
    n_, h, w, _ = x.shape
    cout = wt.shape[-1]
    hs, ws, pt, pl = -(-h // 2), -(-w // 2), h % 2, w % 2
    th, tw, P = plan.th, plan.tw, F32_CONV_P
    wr, wc = 2 * th + 1, 2 * tw + 1
    pitch = 3 * wc + 1
    mem = np.full(base // 4 + x.size + 8, np.nan, np.float32)
    mem[base // 4:base // 4 + x.size] = x.ravel()
    wt = wt.reshape(27, cout)
    groups, sw = 256 // cout, tw // P
    out = np.full((n_, hs, ws, cout), np.nan, np.float32)
    tiles_h, tiles_w = -(-hs // th), -(-ws // tw)
    for t in range(n_ * tiles_h * tiles_w):
        n, rest = divmod(t, tiles_h * tiles_w)
        t0, u0 = (rest // tiles_w) * th, (rest % tiles_w) * tw
        r0, c0 = 2 * t0 - pt, 2 * u0 - pl
        cs, ce = max(c0, 0), min(c0 + wc, w)
        a, b_ = 3 * (cs - c0), 3 * (ce - c0)
        win = np.full((wr, pitch), np.nan, np.float32)
        for r in range(wr):
            hi = r0 + r
            row = 0 <= hi < h and a < b_
            s0 = base // 4 + (((n * h + (hi if row else 0)) * w + cs) * 3) - a  # float index
            if not row or ((s0 + a) % 4 == 0 and a % 4 == 0 and b_ % 4 == 0):
                for e in range(0, pitch, 4):  # 16-byte granules, zero-filled outside
                    win[r, e:e + 4] = mem[s0 + e:s0 + e + 4] if row and a <= e < b_ else 0
                if paths is not None and row:
                    paths["vec"] += 1
            else:
                for e in range(pitch):
                    win[r, e] = mem[s0 + e] if a <= e < b_ else 0
                if paths is not None:
                    paths["scalar"] += 1
        assert not np.isnan(win).any()
        # consumer group grp: strips grp, grp + groups, ... (row ih, column P su)
        seen = set()
        for grp in range(groups):
            ih, su = divmod(grp, sw)
            dih, du = divmod(groups, sw)
            while ih < th:
                seen.add((ih, su))
                u = P * su
                ho, wo = t0 + ih, u0 + u
                if ho < hs and wo < ws:
                    acc = _stem_strip(win, 2 * ih, 6 * u, wt, P)
                    for p in range(P):
                        if wo + p < ws:
                            out[n, ho, wo + p] = _act32(acc[p] + b, relu6)
                ih, su = ih + dih, su + du
                if su >= sw:
                    ih, su = ih + 1, su - sw
        assert seen == {(i, j) for i in range(th) for j in range(sw)}
    return out


def _fmaf(a, b, c):
    """fmaf emulated in float64: the product is exact there, the sum is
    rounded to float64 and then to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def f32_b0_mirror(img: np.ndarray, wf, relu6, base, plan):
    """stem_block0's float32 kernel: uint8 images at byte `base`; wf the six
    float32 weights. Returns the output and, per chunk, (n, t0, u0, its
    stem rows by stem-grid row, its depthwise tile)."""
    n_, h, w, _ = img.shape
    sw, sb, dw, db, pw, pb = wf
    cout = pw.shape[-1]
    hs, ws, th, cpu = h // 2, w // 2, plan.th, plan.cpu
    hh, wr = th + 2, 2 * (th + 2) + 1
    u8pitch = 16 * (-(-(2 * B0_HW + 1) * 3 // 16) + 1)
    buf = _flat(img, base)
    wt, dwt = sw.reshape(27, K), dw.reshape(9, K)
    # the pointwise weight in 4-column blocks of 32 rows, B0_WB floats apart
    pwb = np.full(cout // 4 * B0_WB, np.nan, np.float32)
    for k in range(K):
        for co in range(cout):
            pwb[(co >> 2) * B0_WB + 4 * k + (co & 3)] = pw[k, co]
    tiles_h, tiles_w = -(-hs // th), -(-ws // F32_B0_TW)
    segs = -(-tiles_h // cpu)
    assert plan.units == n_ * tiles_w * segs
    out = np.full((n_, hs, ws, cout), np.nan, np.float32)
    chunks = []
    for unit in range(plan.units):
        tj, rest = unit % tiles_w, unit // tiles_w
        sg, n = rest % segs, rest // segs
        stem = np.full((hh, B0_HW, K), np.nan, np.float32)  # its rows taken in turn
        for k in range(min(cpu, tiles_h - sg * cpu)):
            t0, u0 = (sg * cpu + k) * th, tj * F32_B0_TW
            srows = hh if k == 0 else th
            i0 = t0 - 1 if k == 0 else t0 + 1  # the stem row of window row 0
            r0, rows = 2 * i0, 2 * srows + 1
            c0 = 2 * (u0 - 1)
            assert rows <= wr
            u8, roff, cs = _stage(buf, base, n, h, w, 3, r0, rows, c0, 2 * B0_HW + 1)
            assert u8.shape[1] == u8pitch
            ce = min(c0 + 2 * B0_HW + 1, w)
            a, b_ = 3 * (cs - c0), 3 * (ce - c0)
            win = np.zeros((rows, B0_PITCH), np.float32)
            for r in range(rows):
                for e in range(B0_PITCH):
                    if roff[r] >= 0 and a <= e < b_:
                        v = np.float32(u8[r, roff[r] - a + e]) * np.float32(PREPROCESS_SCALE)
                        win[r, e] = v + np.float32(PREPROCESS_OFFSET)
            # 1. the new stem rows, 6-pixel strips by warp, into the rows in turn
            sbase = 0 if k == 0 else (k * th + 2) % hh
            for j in range(srows * (B0_HW // B0_P)):
                sr, hc = divmod(j, B0_HW // B0_P)
                hc *= B0_P
                acc = _stem_strip(win, 2 * sr, 6 * hc, wt, B0_P)
                row = i0 + sr
                for p in range(B0_P):
                    col = u0 - 1 + hc + p
                    inside = 0 <= row < hs and 0 <= col < ws
                    stem[(sbase + sr) % hh, hc + p] = _act32(acc[p] + sb, relu6) if inside else 0
            # 2-3. warp w: the depthwise of its block (columns u..u+3, rows
            # y0..y0+th/2-1), then its pointwise
            dws = np.full((K, B0_DP), np.nan, np.float32)
            dbase, rows_w = (k * th) % hh, th // 2
            for warp in range(8):
                y0, u = (warp >> 2) * rows_w, 4 * (warp & 3)
                acc = np.zeros((rows_w, 4, K), np.float32)
                for yr in range(rows_w + 2):
                    v = stem[(dbase + y0 + yr) % hh, u:u + 6]
                    for dy in range(3):
                        y = yr - dy
                        if not 0 <= y < rows_w:
                            continue
                        for dx in range(3):
                            for p in range(4):
                                acc[y, p] = acc[y, p] + v[p + dx] * dwt[dy * 3 + dx]
                    if yr >= 2:
                        m = (y0 + yr - 2) * F32_B0_TW + u
                        dws[:, m:m + 4] = _act32(acc[yr - 2] + db, relu6).T
                # jobs of rj rows x 4 pixels x channels 4q.. and Cout/2 + 4q..
                cg, half = cout // 8, cout // 2
                rj = 2 if th // 4 * cg >= 32 else 1
                for job in range(rows_w // rj * cg):
                    px, q = (y0 + rj * (job // cg)) * F32_B0_TW + u, job % cg
                    wsel = np.concatenate([pwb[q * B0_WB:][:4 * K].reshape(K, 4),
                                           pwb[(q + cg) * B0_WB:][:4 * K].reshape(K, 4)], 1)
                    cols = np.r_[4 * q:4 * q + 4, half + 4 * q:half + 4 * q + 4]
                    for r in range(rj):
                        pr = px + r * F32_B0_TW
                        assert not np.isnan(dws[:, pr:pr + 4]).any()  # the warp's own block
                        acc_p = np.zeros((4, 8), np.float32)
                        for kk in range(K):
                            acc_p = _fmaf(dws[kk, pr:pr + 4][:, None], wsel[kk][None, :], acc_p)
                        ho, wo = t0 + pr // F32_B0_TW, u0 + pr % F32_B0_TW
                        for i in range(4):
                            if ho < hs and wo + i < ws:
                                out[n, ho, wo + i, cols] = _act32(acc_p[i] + pb[cols], relu6)
            rows_abs = {t0 - 1 + (r - dbase) % hh: stem[r].copy() for r in range(hh)}
            chunks.append((n, t0, u0, rows_abs, dws))
    return out, chunks


@pytest.mark.parametrize("n,h,w,cout,relu6,base", [
    (2, 32, 32, 32, True, 0),     # even sides: rows by 16-byte granules
    (1, 33, 17, 16, False, 4),    # odd sides: TF-SAME pads (1, 1); single floats
    (2, 19, 26, 24, True, 8),     # odd rows, a base 8 bytes in: 10 groups of 24 channels
    (1, 16, 16, 256, True, 16),   # Cout 256: one group of the 256 consumers
])
def test_f32_conv_mirror(n, h, w, cout, relu6, base):
    """The float32 stem_conv mirror, bit for bit against stem_conv_plain
    and, on even square sides, within the float32 tolerance of
    stem_conv_packed in interpret mode."""
    rng = np.random.default_rng(h * w + cout)
    x = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    x[:, -1] = 1
    x[:, :, -1] = 1
    wt = rng.normal(0, 0.8, (3, 3, 3, cout)).astype(np.float32)
    b = rng.normal(0, 0.2, (cout,)).astype(np.float32)
    plan = f32_stem_plan(n, h, w, cout, False)
    paths = {"vec": 0, "scalar": 0}
    got = f32_conv_mirror(x, wt, b, relu6, base, plan, paths)
    assert np.isfinite(got).all()
    assert paths["vec"] > 0 if (w % 4 == 0 and base % 16 == 0) else paths["scalar"] > 0
    ref = stem_conv_plain(*[torch.from_numpy(a) for a in (x, wt, b)], relu6).numpy()
    np.testing.assert_array_equal(got, ref)
    if relu6:
        assert 0 < (ref == 6).mean() < 1
    if h % 2 == 0 and w == h:
        jx = stem_conv_packed(*[jnp.asarray(a) for a in (x, wt, b)], cout, relu6, interpret=True)
        np.testing.assert_allclose(got, np.asarray(jx, np.float32), **F32_TOL)


@pytest.mark.parametrize("n,h,w,cout,relu6,base,th,cpu", [
    (1, 64, 64, 64, True, 0, 16, 2),    # two 16 x 16 tiles down each band: the stem rows reused
    (1, 36, 72, 16, False, 5, 8, 3),    # 8-row tiles, a ragged last tile and band; base 5 bytes in
    (2, 20, 36, 8, True, 3, 4, 2),      # a unit of 2 tiles, then one of 1 (3 tile rows); Cout 8
])
def test_f32_b0_mirror(n, h, w, cout, relu6, base, th, cpu):
    """The float32 stem_block0 mirror: its stem rows and depthwise tiles bit
    for bit against the plain version's stages, its output within the
    float32 tolerance of stem_block0_plain and, on square sides,
    unpack(stem_block0_fused) in interpret mode. The last input row and
    column are 255, beside the stem's pad."""
    rng = np.random.default_rng(h * w + cout)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img[:, -1] = 255
    img[:, :, -1] = 255
    wf = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
        (0.4 * 3, (3, 3, 3, 32)), (0.2, (32,)), (0.5 * 3, (3, 3, 1, 32)), (0.2, (32,)),
        (3 * 32 ** -0.5, (32, cout)), (0.2, (cout,)))]
    hs, ws = h // 2, w // 2
    tiles_h, bands = -(-hs // th), n * -(-ws // F32_B0_TW)
    plan = F32StemPlan(th, F32_B0_TW, cpu, bands * -(-tiles_h // cpu), 2, 1,
                       f32_stem_smem_bytes(True, th, F32_B0_TW, cout))
    got, chunks = f32_b0_mirror(img, wf, relu6, base, plan)
    assert np.isfinite(got).all()
    tw = [torch.from_numpy(a) for a in wf]
    y = apply_activation(_stem_taps_f32(normalize(torch.from_numpy(img)), tw[0]) + tw[1], relu6)
    d = apply_activation(dw_taps_f32(y, tw[2], 1) + tw[3], relu6).numpy()
    y = y.numpy()
    for n_i, t0, u0, rows, dws in chunks:
        for i, stem_row in rows.items():  # stem rows t0 - 1 .. t0 + th
            for hc in range(B0_HW):
                j = u0 - 1 + hc
                want = y[n_i, i, j] if 0 <= i < hs and 0 <= j < ws else np.zeros(K, np.float32)
                np.testing.assert_array_equal(stem_row[hc], want)
        for m in range(th * F32_B0_TW):
            i, j = t0 + m // F32_B0_TW, u0 + m % F32_B0_TW
            if i < hs and j < ws:
                np.testing.assert_array_equal(dws[:, m], d[n_i, i, j])
    ref = stem_block0_plain(torch.from_numpy(img), *tw, relu6).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    if h == w:
        jx = unpack(stem_block0_fused(jnp.asarray(img), *[jnp.asarray(a) for a in wf], cout,
                                      relu6, interpret=True), cout)
        np.testing.assert_allclose(got, np.asarray(jx, np.float32), **F32_TOL)
