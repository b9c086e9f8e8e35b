"""The standalone depthwise kernels' plan (`ops/depthwise.dw_plan`,
`csrc/depthwise_ring.cuh`, shared by `depthwise` and `depthwise_i8`) and a
NumPy mirror of the int8 arithmetic they share with the fused int8 block
(`csrc/int8_tile.cuh`), on the CPU.

At MobileNet-V1's 13 depthwise layer shapes for alpha 0.25-1.4 and
resolution 96-224, at batch 1, 2 and 256, in int8, bf16 and float32 (and at
odd sides at stride 2): every plan's shared memory is within a block's
limit, and the kernel's walk (blocks on a channel slice stepping over its
bands; a consumer thread's vector and items; a segment sliding down its
rows) covers every output pixel and every 8 bytes of its channels exactly
once. The window ring's handshakes, stepped role by role, finish at every
slot count the plan takes, with the TMA producer and with the cp.async one
(32 arrivals a fill). The mirror copies the kernels' int8 order of work: the
4 x 4 byte transposes, dp4a over taps 0-3, 4-7 and 8 from bias + 0x4B400000,
the magic conversion where a 16-channel group's biases are within 2^21 (else
the int32 sum converted), the requant's clamp and the magic rounding; it
equals `quant/ops.depthwise_i8`, the plain version, on seeded inputs with
biases beyond 2^21, six_q 100 and 127, ReLU without 6, and C = 8, 24, 40."""

import numpy as np
import pytest
import torch

from mobilenet_tpu_torch.config import BLOCK_DEFS, STEM_CHANNELS, scaled_channels
from mobilenet_tpu_torch.ops.depthwise import (
    CONSUMERS, MAX_SLOTS, MAX_VECS, VEC, dw_plan, dw_slices, dw_smem_bytes,
)
from mobilenet_tpu_torch.ops.separable_block import H100_SMS, SMEM_LIMIT
from mobilenet_tpu_torch.quant import ops as qops

ALPHAS = (0.25, 0.5, 0.75, 1.0, 1.4)
RESOLUTIONS = (96, 128, 160, 192, 224)
ELEMS = (1, 2, 4)  # int8, bf16, float32


def v1_dw_shapes(alpha, res):
    """(h, c, stride) of each distinct depthwise layer of V1 alpha-res that
    the kernels take (C a multiple of 8: alpha 1.4's 44, 89, 179, ...
    channels raise in the wrappers, as they did before)."""
    shapes, h, c = [], res // 2, scaled_channels(STEM_CHANNELS, alpha)
    for stride, cout in BLOCK_DEFS:
        if (h, c, stride) not in shapes and c % 8 == 0:
            shapes.append((h, c, stride))
        h, c = -(-h // stride), scaled_channels(cout, alpha)
    return shapes


def geo(n, h, w, c, elem, stride, p):
    """The kernel's `make_geo` (the fields the walk reads)."""
    ho, wo = -(-h // stride), -(-w // stride)
    cb = c * elem
    return dict(ho=ho, wo=wo, cb=cb, pix=p.nv * VEC, nslices=-(-(-(-cb // VEC)) // p.nv),
                bands_h=-(-ho // p.th), bands_w=-(-wo // p.tw), nseg=-(-p.th // p.seg),
                lanes=CONSUMERS // p.nv)


def band_pattern(g, p, slice_, rows, cols):
    """Coverage counts (rows, cols, 8-byte granules of the slice) of one
    unit: each consumer thread's vector and items, each item a segment of
    output rows at one column, as `consume` walks them."""
    cov = np.zeros((p.th, p.tw, p.nv * 2), np.int64)
    for t in range(CONSUMERS):
        v, lane = t % p.nv, t // p.nv
        c0b = slice_ * g["pix"] + v * VEC
        nbytes = max(0, min(VEC, g["cb"] - c0b))
        if lane >= g["lanes"] or nbytes == 0:
            continue
        assert nbytes in (8, 16)
        for it in range(lane, g["nseg"] * p.tw, g["lanes"]):
            si, ow = divmod(it, p.tw)
            r0, r1 = si * p.seg, min(rows, si * p.seg + p.seg)
            if ow >= cols or r0 >= r1:
                continue
            cov[r0:r1, ow, 2 * v:2 * v + nbytes // 8] += 1
    return cov[:rows, :cols]


def check_walk(n, h, w, c, elem, stride, sms=H100_SMS):
    """The plan's shared memory, and that its units cover every output
    pixel and 8 bytes of channels once."""
    p = dw_plan(n, h, w, c, elem, stride, sms)
    assert 1 <= p.nv <= MAX_VECS and 1 <= p.ws <= MAX_SLOTS and 1 <= p.seg <= p.th
    assert (p.th - 1) * stride + 3 <= 256 and (p.tw - 1) * stride + 3 <= 256
    assert dw_smem_bytes(elem, stride, p.th, p.tw, p.nv, p.ws) <= SMEM_LIMIT
    g = geo(n, h, w, c, elem, stride, p)
    assert (g["nslices"], p.nv) == dw_slices(c, elem) or p.nv < dw_slices(c, elem)[1]
    bands = n * g["bands_h"] * g["bands_w"]
    per = max(1, min(bands, sms // g["nslices"]))
    # each slice's bands, one block's walk each: b0, b0 + per, ...
    seen = np.zeros((g["nslices"], bands), np.int64)
    for blk in range(per * g["nslices"]):
        seen[blk % g["nslices"], blk // g["nslices"]::per] += 1
    assert (seen == 1).all()
    # the bands tile each image's output rows and columns once
    oh0 = np.arange(g["bands_h"]) * p.th
    wo0 = np.arange(g["bands_w"]) * p.tw
    assert (np.minimum(p.th, g["ho"] - oh0) > 0).all() and (np.minimum(p.tw, g["wo"] - wo0) > 0).all()
    assert np.minimum(p.th, g["ho"] - oh0).sum() == g["ho"]
    assert np.minimum(p.tw, g["wo"] - wo0).sum() == g["wo"]
    # inside a unit: the consumers cover its rows x cols x the slice's bytes within C once
    for s in range(g["nslices"]):
        valid = np.clip(g["cb"] - s * g["pix"] - np.arange(p.nv * 2) * 8, 0, 8) // 8
        for rows in {min(p.th, g["ho"] - r) for r in oh0}:
            for cols in {min(p.tw, g["wo"] - q) for q in wo0}:
                cov = band_pattern(g, p, s, rows, cols)
                assert (cov == valid[None, None, :]).all(), (s, rows, cols)
    return p


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_plan_covers_v1_layers(alpha, res):
    for h, c, stride in v1_dw_shapes(alpha, res):
        for n in (1, 2, 256):
            for elem in ELEMS:
                check_walk(n, h, h, c, elem, stride)


@pytest.mark.parametrize("n,h,w,c,stride", [
    (2, 7, 7, 24, 2), (3, 9, 13, 40, 2), (1, 15, 15, 8, 2), (2, 10, 10, 24, 1),
    (1, 300, 300, 32, 1), (1, 600, 17, 16, 2), (2, 14, 14, 1000, 1), (256, 7, 7, 2048, 1),
])
@pytest.mark.parametrize("elem", ELEMS)
def test_plan_covers_edge_shapes(n, h, w, c, stride, elem):
    """Odd sides at stride 2, a half vector (int8 at C % 16 == 8), a window
    wider than a TMA box (column tiles), slices that do not divide C."""
    check_walk(n, h, w, c, elem, stride)


def test_plan_pins_v1_224():
    """V1 1.0-224 at batch 256: int8 slices of up to 256 bytes, bf16 halved
    where a band would hold fewer than 3 rows; four slots; at batch 2 bands
    cut to a few rows, so that half the SMs or more have a unit."""
    assert tuple(dw_plan(256, 112, 112, 32, 1, 1)) == (13, 112, 13, 2, 4)
    assert tuple(dw_plan(256, 56, 56, 128, 2, 1)) == (5, 56, 5, 8, 4)
    assert tuple(dw_plan(256, 7, 7, 1024, 1, 1)) == (7, 7, 4, 16, 4)
    assert tuple(dw_plan(2, 112, 112, 32, 1, 1)) == (2, 112, 2, 2, 4)
    for h, c, s in v1_dw_shapes(1.0, 224):
        p = dw_plan(2, h, h, c, 1, s)
        units = 2 * -(-(-(-h // s)) // p.th) * -(-c // (VEC * p.nv))
        assert units >= H100_SMS // 2 or p.th == 1


# -- the window ring's handshakes ---------------------------------------------------


def ring_walk(units, slots, warps=CONSUMERS // 32, fills=1):
    """Steps the producer (or its `fills` lanes, each arriving once a unit:
    the cp.async form) and the consumer warps through the ring's mbarrier
    phases; True if every role finishes, False at a deadlock. A slot's fill
    completes once `fills` arrivals land; it is freed once all warps arrive."""
    filled = [0] * slots
    freed = [0] * slots
    got = [0] * slots   # fill arrivals in the current phase
    left = [0] * slots  # warp arrivals in the current phase

    def producer():
        for k in range(units):
            s = k % slots
            while freed[s] < k // slots:
                yield False
            got[s] += 1
            if got[s] == fills:
                got[s], filled[s] = 0, filled[s] + 1
            yield True

    def consumer():
        for k in range(units):
            s = k % slots
            while filled[s] < k // slots + 1:
                yield False
            assert freed[s] == k // slots, "a slot freed out of phase"
            left[s] += 1
            if left[s] == warps:
                left[s], freed[s] = 0, freed[s] + 1
            yield True

    live = [producer() for _ in range(fills)] + [consumer() for _ in range(warps)]
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


@pytest.mark.parametrize("slots", range(1, MAX_SLOTS + 1))
@pytest.mark.parametrize("fills", [1, 32])
def test_ring_progresses(slots, fills):
    for units in (1, slots, 3 * slots + 1):
        assert ring_walk(units, slots, fills=fills)


def test_plan_slot_counts():
    """The slot counts the plan takes at the V1 shapes are 1..MAX_SLOTS (the
    ring's stepping above covers each)."""
    seen = set()
    for alpha in ALPHAS:
        for h, c, stride in v1_dw_shapes(alpha, 224):
            for elem in ELEMS:
                seen.add(dw_plan(256, h, h, c, elem, stride).ws)
    assert seen <= set(range(1, MAX_SLOTS + 1))


# -- the shared int8 stage: a NumPy mirror ----------------------------------------------

MAGIC_I = 0x4B400000
MAGIC_F = np.float32(12582912.0)
SMALL_BIAS = 1 << 21


def taps_same(x, stride):
    """The nine TF-SAME taps of x (N, H, W, C) int8, tap dy * 3 + dx, each
    (N, Ho, Wo, C) int32 (zeros off the image)."""
    n, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    th = max((ho - 1) * stride + 3 - h, 0)
    tw = max((wo - 1) * stride + 3 - w, 0)
    xp = np.pad(x.astype(np.int32), ((0, 0), (th // 2, th - th // 2), (tw // 2, tw - tw // 2),
                                     (0, 0)))
    return [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]


def words(b4):
    """Four int8 byte planes (..., 4) -> uint32 words (byte k from plane k)."""
    u = b4.astype(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def dp4a(a, b, c):
    """__dp4a(signed): c + the sum of the four signed byte products, int32."""
    sa = a.view(np.uint32)[..., None] >> np.array([0, 8, 16, 24], np.uint32) & 0xff
    sb = b.view(np.uint32)[..., None] >> np.array([0, 8, 16, 24], np.uint32) & 0xff
    sa = sa.astype(np.uint8).view(np.int8).astype(np.int64)
    sb = sb.astype(np.uint8).view(np.int8).astype(np.int64)
    s = c.astype(np.int64) + (sa * sb).sum(-1)
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def mirror_dw_i8(x, w, b, m, six_q, stride, relu6):
    """The kernels' int8 depthwise (int8_tile.cuh) in NumPy."""
    n, h, wd, c = x.shape
    v = taps_same(x, stride)                         # 9 x (N, Ho, Wo, C)
    wt = w.reshape(9, c).astype(np.int32)
    # the transposed words: a channel's taps 0-3 and 4-7 (tap 0 in the low
    # byte), its tap 8 in byte e of the weight word (e: its lane in the quad)
    x03 = words(np.stack(v[0:4], -1)).view(np.int32)
    x47 = words(np.stack(v[4:8], -1)).view(np.int32)
    lane = np.arange(c) % 4
    # tap 8's input word is the 4-channel word of the channel's quad
    v8 = v[8].reshape(*v[8].shape[:-1], c // 4, 4)
    x8q = np.repeat(words(v8), 4, -1).view(np.int32)
    w03 = words(np.stack([wt[t] for t in range(4)], -1)).view(np.int32)
    w47 = words(np.stack([wt[t] for t in range(4, 8)], -1)).view(np.int32)
    w8 = ((wt[8].astype(np.uint32) & 0xff) << (8 * lane).astype(np.uint32)).view(np.int32)
    bias = (b.astype(np.int64) + MAGIC_I).astype(np.uint32).view(np.int32)
    acc = dp4a(x03, np.broadcast_to(w03, x03.shape), np.broadcast_to(bias, x03.shape))
    acc = dp4a(x47, np.broadcast_to(w47, x47.shape), acc)
    acc = dp4a(x8q, np.broadcast_to(w8, x8q.shape), acc)
    # the conversion: magic where the 16-channel group's biases are small
    groups = -(-c // 16)
    small = np.array([np.all(np.abs(b[16 * j:16 * j + 16].astype(np.int64)) <= SMALL_BIAS)
                      for j in range(groups)])
    small = np.repeat(small, 16)[:c]
    f_magic = acc.view(np.float32) - MAGIC_F
    f_int = (acc.astype(np.int64) - MAGIC_I).astype(np.int32).astype(np.float32)
    f = np.where(small, f_magic, f_int).astype(np.float32)
    hi = np.float32(min(np.float32(six_q), 127.0) if relu6 else 127.0)
    q = np.minimum(np.maximum(f * m.astype(np.float32), np.float32(0)), hi).astype(np.float32)
    r = (q + MAGIC_F).astype(np.float32).view(np.uint32) & 0xff
    return r.astype(np.uint8).view(np.int8)


def _operands(rng, n, h, w, c, big_bias):
    x = rng.integers(-128, 128, (n, h, w, c)).astype(np.int8)
    wt = rng.integers(-128, 128, (3, 3, 1, c)).astype(np.int8)
    b = rng.integers(-60000, 60000, (c,)).astype(np.int32)
    if big_bias:  # one 16-channel group beyond 2^21: its sums convert by __int2float_rn
        b[: min(c, 16)] += np.int32(3 << 21) * rng.choice([-1, 1], min(c, 16)).astype(np.int32)
    m = rng.uniform(2e-4, 2e-3, (c,)).astype(np.float32)
    if big_bias:
        m[: min(c, 16)] = rng.uniform(2e-6, 3e-5, min(c, 16)).astype(np.float32)
    return x, wt, b, m


@pytest.mark.parametrize("c", [8, 24, 40, 64])
@pytest.mark.parametrize("stride,h,w", [(1, 9, 9), (2, 9, 9), (2, 8, 10), (1, 5, 12)])
@pytest.mark.parametrize("six_q,relu6", [(127.0, True), (100.0, True), (127.0, False)])
@pytest.mark.parametrize("big_bias", [False, True])
def test_mirror_equals_plain(c, stride, h, w, six_q, relu6, big_bias):
    rng = np.random.default_rng(c * 131 + h * 7 + w + stride + int(six_q) + big_bias)
    x, wt, b, m = _operands(rng, 2, h, w, c, big_bias)
    got = mirror_dw_i8(x, wt, b, m, six_q, stride, relu6)
    ref = qops.depthwise_i8(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                            torch.from_numpy(m), six_q, stride, relu6).numpy()
    np.testing.assert_array_equal(got, ref)
    # the requant's range is exercised: zeros, saturation and values between
    assert (ref == 0).any() and (ref > 0).any()
    if big_bias:
        assert (np.abs(b[:16].astype(np.int64)) > SMALL_BIAS).any()


def test_mirror_saturates_at_six_q():
    """At six_q 100 the ReLU6 bound clips where 127 would not."""
    rng = np.random.default_rng(5)
    x, wt, b, m = _operands(rng, 1, 6, 6, 24, False)
    m *= 8
    a = mirror_dw_i8(x, wt, b, m, 100.0, 1, True)
    z = mirror_dw_i8(x, wt, b, m, 127.0, 1, True)
    assert a.max() == 100 and z.max() == 127 and (a <= 100).all()
