"""The int8 MobileNet-V3 bottleneck's Hopper tile (`csrc/v3_i8_wgmma.cuh`) on
the CPU: its plan (`v3_i8_wgmma_plan`, the fits-function of every int8 call)
at every block of V3-Large, V3-Large-minimalistic and V3-Small 1.0-224, and
a mirror of the tile's unit walk in torch on the plan's geometry (units of
an output tile x a part of Cout; the input window, padded to 16 channels,
with zeros outside the image; 128-channel chunks of E expanded in 64-column
halves with a ragged tail, zeroed outside the image; the depthwise from the
kernel's dp4a table; the requants by the magic number with their 2^22
guards; the stored pre-gate tensor, the image's gate once, the gated pass
2; the saturating residual), held EXACTLY against `v3_block_i8_plain` and
against the JAX package's `v3_block_pallas_i8`, `packed_block_i8_named`,
`packed_block_i8_named_s2` and `packed_block_i8_named_s2_se` in interpret
mode; with the ReLU6 requant (a per-layer upper bound) on MobileNet-V2's
blocks, against `inverted_residual_i8` (the V2 block's plain version),
`quant/ops.requantize`, V2's oracle sequence and the JAX package's
`inverted_residual_pallas_i8` and `expand_block_packed_s2_i8`, at six_q 127
and at a recalibrated bound below it. The card tests (tests/test_torch_cuda.py) hold the kernel itself and
its shared-memory arithmetic against this module's plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack
from mobilenet_tpu.quant.pallas_block_packed_i8 import (
    packed_block_i8_named, packed_block_i8_named_s2, packed_block_i8_named_s2_se,
    packed_expand_i8_named,
)
from mobilenet_tpu.quant import oracle as jax_oracle
from mobilenet_tpu.quant.pallas_expand_s2_i8 import expand_block_packed_s2_i8
from mobilenet_tpu.quant.pallas_ir_i8 import inverted_residual_pallas_i8
from mobilenet_tpu.quant.pallas_ir_v3_i8 import v3_block_pallas_i8
from mobilenet_tpu.quant.v2 import _res_add, pw_i8_linear
from mobilenet_tpu_torch import V2Config, V3Config
from mobilenet_tpu_torch.ops import v3_block_i8 as v3_block_i8_mod
from mobilenet_tpu_torch.ops.inverted_residual_i8 import inverted_residual_i8
from mobilenet_tpu_torch.ops.v3_block_i8 import (
    FULL, GATED, I8W_SMEM_LIMIT, I8W_TM, POOL, V3I8Plan, dw_table, kernel_weights,
    requant_bound, v3_block_i8, v3_block_i8_plain, v3_i8_kernel_weights, v3_i8_wgmma_plan,
    v3_i8_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.quant import ops as qops
from mobilenet_tpu_torch.quant.model import device_layer
from mobilenet_tpu_torch.quant.quantize import ACT_HIDDEN_SCALE, _quant_layer
from mobilenet_tpu_torch.quant.v3 import _quant_named, device_layer_v3

WGMMA_N = (8, 16, 32, 64, 128)
MAGIC_I, MAGIC_F = 0x4B400000, 12582912.0  # the bits of 1.5 * 2^23, and its value
CONFIGS = {"large": V3Config("large", 1.0, 224), "large_min": V3Config("large", 1.0, 224,
                                                                        minimalistic=True),
           "small": V3Config("small", 1.0, 224)}


def _blocks(cfg):
    """(index, input side, block def) of every block at 1.0-224."""
    out, h = [], cfg.resolution // 2
    for i, bd in enumerate(cfg.block_defs):
        out.append((i, h, bd))
        h = -(-h // bd.stride)
    return out


BLOCK_CASES = [(name, batch, i) for name, cfg in CONFIGS.items() for batch in (256, 1)
               for i in range(len(cfg.block_defs))]


def _plan_of(name, batch, i):
    _, h, bd = _blocks(CONFIGS[name])[i]
    return h, bd, v3_i8_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                   bd.se_mid, not bd.has_expand)


def _slices(cw):
    """The kernel's output slices of a part (make_geo's nbig and nsmall)."""
    nbig = 2 if cw >= 128 else 1 if cw >= 64 else 0
    small = (cw - 64 * nbig) // 8
    return ([64 * nbig] if nbig else []) + [8 * b for b in (4, 2, 1) if small & b]


@pytest.mark.parametrize("name,batch,i", BLOCK_CASES,
                         ids=[f"{n}-{b}-b{i:02d}" for n, b, i in BLOCK_CASES])
def test_plan_fits_the_card(name, batch, i):
    """Every int8 block of the three 1.0-224 variants has a plan at batch 256
    and 1: a tile of at most 128 outputs of one image, window sides within a
    TMA box, each pass it launches within 227 KB, whole parts of Cout, ring
    slots the kernel takes; its slices are s8 wgmma widths with no padded
    column."""
    h, bd, p = _plan_of(name, batch, i)
    assert p is not None
    ho = -(-h // bd.stride)
    assert 1 <= p.th <= ho and 1 <= p.tw <= ho and p.th * p.tw <= I8W_TM
    assert (p.th - 1) * bd.stride + bd.kernel <= 256 and (p.tw - 1) * bd.stride + bd.kernel <= 256
    assert p.split * p.cw == bd.cout and p.cw % 8 == 0
    assert 1 <= p.ws <= 4 and 2 <= p.bs <= 4
    for mode in ((POOL, GATED) if bd.se_mid else (FULL,)):
        assert v3_i8_wgmma_smem_bytes(p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                      p.cw, p.ws, p.bs, not bd.has_expand,
                                      mode) <= I8W_SMEM_LIMIT
    widths = _slices(p.cw)
    assert sum(widths) == p.cw and all(w in WGMMA_N for w in widths)
    assert len(widths) == len(set(widths)) and widths == sorted(widths, reverse=True)


def _units(n, ho, wo, plan, pool):
    """The kernel's unit walk (v3_i8_wgmma.cuh unit_of): (image, tile origin,
    first column) of every unit of a pass; pass 1 does not split Cout."""
    tiles_w, tiles_h = -(-wo // plan.tw), -(-ho // plan.th)
    split = 1 if pool else plan.split
    for u in range(n * tiles_h * tiles_w * split):
        t, part = divmod(u, split)
        img, ti = divmod(t, tiles_h * tiles_w)
        tr, tc = divmod(ti, tiles_w)
        yield img, tr * plan.th, tc * plan.tw, part * plan.cw


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch", [2, 1])
def test_units_cover_every_output_once(name, batch):
    """The full pass's and pass 2's units cover every output pixel and
    channel exactly once; pass 1's (SE blocks) every output pixel of every
    image once."""
    for i, h, bd in _blocks(CONFIGS[name]):
        p = v3_i8_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                             bd.se_mid, not bd.has_expand)
        ho = -(-h // bd.stride)
        seen = np.zeros((batch, ho, ho, bd.cout), np.int32)
        for img, oy, ox, c0 in _units(batch, ho, ho, p, False):
            seen[img, oy:oy + p.th, ox:ox + p.tw, c0:c0 + p.cw] += 1
        assert (seen == 1).all(), f"b{i:02d}"
        pooled = np.zeros((batch, ho, ho), np.int32)
        for img, oy, ox, c0 in _units(batch, ho, ho, p, True):
            assert c0 == 0
            pooled[img, oy:oy + p.th, ox:ox + p.tw] += 1
        assert (pooled == 1).all(), f"b{i:02d}"


def test_smem_mirror_by_hand():
    """v3_i8_wgmma_smem_bytes at V3-L b13's 7x7 tile (SE: pass 1 and pass
    2) and b00's identity 8x16 tile: 1 KB alignment, 1 KB of barriers, the
    16 KB A panel, Z (MP x 144), weight stages (expand boxes, projection
    boxes in the full pass only, the depthwise table, four 512-byte vectors,
    rounded up to 1 KB), windows (MP x 128 a 128-chunk of Cin; the full pass:
    + 2 KB, the part's projection bias and multiplier); pass 2: four stages
    of a 16 KB z tile, the projection boxes, the gate and the part's 2 KB."""
    # b13 pass 1: Cin 160 -> two 16 KB expand boxes, 7 table rows at k5; MP 128
    stage = -(-(2 * 16384 + 7 * 512 + 4 * 512) // 1024) * 1024
    want = 2048 + 16384 + 128 * 144 + 2 * stage + 3 * (2 * 128 * 128)
    assert v3_i8_wgmma_smem_bytes(7, 7, 160, 960, 160, 5, 1, 160, 3, 2, False, POOL) == want
    # b13 pass 2: 160 columns = two 64-row boxes + four 8-row boxes
    gated = -(-(16384 + 2 * 8192 + 4 * 1024 + 512 + 2048) // 1024) * 1024
    assert v3_i8_wgmma_smem_bytes(7, 7, 160, 960, 160, 5, 1, 160, 3, 2, False,
                                  GATED) == 2048 + 4 * gated
    # b00 (identity, full): no Z, no expand boxes; a 10 x 18 window -> MP 192
    stage = -(-(2 * 1024 + 3 * 512 + 4 * 512) // 1024) * 1024
    assert v3_i8_wgmma_smem_bytes(8, 16, 16, 16, 16, 3, 1, 16, 4, 4, True,
                                  FULL) == 2048 + 16384 + 4 * stage + 4 * (192 * 128 + 2048)


def test_no_plan_raises():
    """A shape that no plan takes raises at the call (naming the plan), on
    the CPU as on the card: the wrapper never falls back to another tile."""
    assert v3_i8_wgmma_plan(1, 7, 7, 16, 64, 24, 3, 2, 0, False) is None  # odd input at s2
    assert v3_i8_wgmma_plan(1, 8, 8, 256, 256, 24, 3, 1, 0, True) is None  # identity past 128
    q = _layers(5, 16, 64, 24, 3, 0, False)
    dev = {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}
    x = torch.zeros((1, 7, 7, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="v3_i8_wgmma_plan"):
        v3_block_i8(x, dev["exp"], dev["dw"], dev["prj"], k=3, stride=2, act="relu")


def test_plan_spreads_batch_1():
    """At batch 1 the 14^2 and 7^2 blocks have one to four whole-image tiles;
    the plan gives them at least as many units as at batch 256, and more
    than the SMs' worth of one image's tiles where Cout splits."""
    for i, h, bd in _blocks(CONFIGS["large"]):
        if h > 14:
            continue
        units = {}
        for batch in (1, 256):
            p = v3_i8_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                 bd.se_mid, False)
            ho = -(-h // bd.stride)
            units[batch] = -(-ho // p.th) * -(-ho // p.tw) * p.split
        assert units[1] >= units[256] and units[1] >= 4, f"b{i:02d}"


# The plans of every block at 1.0-224 (V2: its expanded blocks 1-16) at batch
# 256 and 1, as the card's measurements in PERF.md were taken on them: a
# change to the time model or to its tie band that moves a plan shows here.
# (th, tw, split, cw, ws, bs) of each block, in order.
PINNED_PLANS = {
    ("large", 256): [(8, 16, 1, 16, 4, 4), (8, 14, 1, 24, 1, 3), (2, 56, 1, 24, 3, 3),
                     (7, 14, 1, 40, 1, 2), (4, 28, 1, 40, 3, 3), (4, 28, 1, 40, 3, 3),
                     (7, 14, 1, 80, 1, 2), (7, 14, 1, 80, 3, 3), (7, 14, 1, 80, 3, 3),
                     (7, 14, 1, 80, 3, 3), (7, 14, 1, 112, 4, 4), (7, 14, 1, 112, 4, 4),
                     (7, 7, 1, 160, 3, 2), (7, 7, 1, 160, 3, 2), (7, 7, 1, 160, 3, 2)],
    ("large", 1): [(8, 16, 1, 16, 4, 4), (4, 8, 1, 24, 4, 3), (1, 28, 1, 24, 4, 4),
                   (4, 4, 1, 40, 4, 4), (4, 4, 1, 40, 4, 4), (4, 4, 1, 40, 4, 4),
                   (1, 14, 5, 16, 4, 4), (1, 14, 5, 16, 4, 4), (1, 14, 5, 16, 4, 4),
                   (1, 14, 5, 16, 4, 4), (1, 14, 7, 16, 4, 4), (1, 14, 7, 16, 4, 4),
                   (2, 7, 20, 8, 4, 4), (2, 7, 20, 8, 3, 2), (2, 7, 20, 8, 3, 2)],
    ("large_min", 256): [(8, 16, 1, 16, 4, 4), (8, 14, 1, 24, 1, 3), (2, 56, 1, 24, 3, 3),
                         (6, 14, 1, 40, 2, 2), (4, 28, 1, 40, 4, 3), (4, 28, 1, 40, 4, 3),
                         (7, 14, 1, 80, 1, 2), (7, 14, 1, 80, 3, 3), (7, 14, 1, 80, 3, 3),
                         (7, 14, 1, 80, 3, 3), (7, 14, 1, 112, 3, 3), (5, 14, 1, 112, 4, 3),
                         (7, 7, 1, 160, 2, 2), (7, 7, 1, 160, 2, 2), (7, 7, 1, 160, 2, 2)],
    ("large_min", 1): [(8, 16, 1, 16, 4, 4), (4, 8, 1, 24, 4, 3), (1, 28, 1, 24, 4, 4),
                       (4, 6, 1, 40, 4, 4), (4, 4, 1, 40, 4, 4), (4, 4, 1, 40, 4, 4),
                       (1, 14, 5, 16, 4, 4), (1, 14, 5, 16, 4, 4), (1, 14, 5, 16, 4, 4),
                       (1, 14, 5, 16, 4, 4), (1, 14, 7, 16, 4, 4), (1, 14, 7, 16, 4, 4),
                       (2, 7, 20, 8, 4, 4), (2, 7, 20, 8, 4, 3), (2, 7, 20, 8, 4, 3)],
    ("small", 256): [(2, 56, 1, 16, 2, 4), (6, 14, 1, 24, 2, 2), (4, 28, 1, 24, 4, 3),
                     (7, 14, 1, 40, 1, 2), (7, 14, 1, 40, 3, 3), (7, 14, 1, 40, 3, 3),
                     (7, 14, 1, 48, 3, 3), (7, 14, 1, 48, 3, 3), (7, 7, 1, 96, 3, 2),
                     (7, 7, 1, 96, 4, 4), (7, 7, 1, 96, 4, 4)],
    ("small", 1): [(2, 56, 2, 8, 2, 4), (4, 6, 3, 8, 4, 4), (3, 7, 3, 8, 4, 4),
                   (2, 7, 5, 8, 4, 4), (1, 14, 5, 8, 4, 4), (1, 14, 5, 8, 4, 4),
                   (1, 14, 6, 8, 4, 4), (1, 14, 6, 8, 4, 4), (2, 7, 12, 8, 4, 4),
                   (2, 7, 12, 8, 4, 4), (2, 7, 12, 8, 4, 4)],
    # b11-b12 (the 11th and 12th here) on 7x14: 0.146 ms against 5x14's 0.183
    # on an H100 at a model gap of 0.26%, inside the tie band
    ("v2", 256): [(8, 14, 1, 24, 1, 3), (2, 56, 1, 24, 3, 3), (6, 14, 1, 32, 2, 2),
                  (4, 28, 1, 32, 4, 3), (4, 28, 1, 32, 4, 3), (7, 14, 1, 64, 1, 3),
                  (7, 14, 1, 64, 3, 3), (7, 14, 1, 64, 3, 3), (7, 14, 1, 64, 3, 3),
                  (7, 14, 1, 96, 3, 3), (7, 14, 1, 96, 3, 3), (7, 14, 1, 96, 3, 3),
                  (7, 7, 1, 160, 2, 2), (7, 7, 1, 160, 2, 2), (7, 7, 1, 160, 2, 2),
                  (7, 7, 2, 160, 2, 2)],
    ("v2", 1): [(3, 14, 1, 24, 3, 3), (4, 8, 1, 24, 4, 4), (4, 4, 2, 16, 4, 4),
                (4, 4, 2, 16, 4, 4), (4, 4, 2, 16, 4, 4), (1, 14, 8, 8, 4, 4),
                (1, 14, 8, 8, 4, 4), (1, 14, 8, 8, 4, 4), (1, 14, 8, 8, 4, 4),
                (1, 14, 6, 16, 4, 4), (1, 14, 6, 16, 4, 4), (1, 14, 6, 16, 4, 4),
                (2, 7, 20, 8, 4, 4), (2, 7, 20, 8, 4, 3), (2, 7, 20, 8, 4, 3),
                (2, 7, 20, 16, 4, 3)],
}


@pytest.mark.parametrize("name,batch", list(PINNED_PLANS))
def test_plans_are_pinned(name, batch):
    if name == "v2":
        got, h = [], 112
        for t, cin, cout, stride in V2Config(1.0, 224).block_defs:
            if t > 1:
                got.append(v3_i8_wgmma_plan(batch, h, h, cin, t * cin, cout, 3, stride, 0,
                                            False))
            h //= stride
    else:
        got = [v3_i8_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                bd.se_mid, not bd.has_expand) for _, h, bd in
               _blocks(CONFIGS[name])]
    assert [tuple(p) for p in got] == PINNED_PLANS[name, batch]


def test_tie_band_is_around_the_lowest_cost(monkeypatch):
    """Candidates tie only within TIE of the lowest cost, so ties cannot
    chain upward: with the band widened to 5%, the plan of V2 0.5-224's
    b07-b09 shape at batch 1 (a walk of pairwise ties would end on 14x2, 7
    units, beyond 5% of the lowest cost) is the candidate with the fewest
    units among those within 5% of the lowest, computed here from the time
    model by hand."""
    monkeypatch.setattr(v3_block_i8_mod, "TIE", 0.05)
    v3_i8_wgmma_plan.cache_clear()
    try:
        n, h, cin, e, cout = 1, 14, 32, 192, 32
        cands = []
        for th in range(1, h + 1):
            for tw in range(1, min(h, I8W_TM // th) + 1):
                cyc, _, steps = v3_block_i8_mod._unit_cycles(th, tw, cin, e, 3, 1, False)
                tiles = n * -(-h // th) * -(-h // tw)
                for cw in (8, 16, 32):
                    fit = next((f for f in v3_block_i8_mod.I8W_RINGS if v3_i8_wgmma_smem_bytes(
                        th, tw, cin, e, cout, 3, 1, cw, *f, False, FULL) <= I8W_SMEM_LIMIT),
                        None)
                    units = tiles * (cout // cw)
                    cost = -(-units // 132) * (cyc + cw * steps * v3_block_i8_mod.PRJ_COL)
                    cost *= 1.1 if fit[0] == 1 else 1.0
                    cands.append(((units, tiles * th * tw - n * h * h, -th * tw, cost),
                                  (th, tw, cout // cw, cw, *fit)))
        low = min(c[0][-1] for c in cands)
        want = min(c for c in cands if c[0][-1] <= 1.05 * low)[1]
        got = tuple(v3_i8_wgmma_plan(n, h, h, cin, e, cout, 3, 1, 0, False))
        assert got == want and got[:3] != (14, 2, 1)
    finally:
        v3_i8_wgmma_plan.cache_clear()


# -- the kernel's weight forms --------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
def test_dw_table_holds_the_taps(k):
    """Row q of the depthwise table holds taps 4q..4q+3 of each channel in
    its bytes (tap 4q low); the last row the last tap in byte e % 4."""
    w = torch.from_numpy(np.random.default_rng(k).integers(-128, 128, (k, k, 1, 40))
                         .astype(np.int8))
    t = dw_table(w)
    assert t.shape == (k * k // 4 + 1, 40) and t.dtype == torch.int32
    b = t.view(torch.int8).reshape(t.shape[0], 40, 4)
    taps = w.reshape(k * k, 40)
    for q in range(k * k // 4):
        assert torch.equal(b[q].t(), taps[4 * q:4 * q + 4])
    lane = torch.arange(40) % 4
    assert torch.equal(b[-1][torch.arange(40), lane], taps[-1])
    assert int(b[-1].abs().sum()) == int(taps[-1].abs().sum())


def test_kernel_weights_are_made_once():
    """`v3_i8_kernel_weights` adds the K-major copies (zero columns up to 16)
    and the table as "wt"; `kernel_weights` then returns those very
    tensors."""
    q = _layers(9, 40, 72, 24, 5, 0, False)
    blk = {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}
    v3_i8_kernel_weights(blk)
    assert blk["exp"]["wt"].shape == (72, 48) and blk["prj"]["wt"].shape == (24, 80)
    assert torch.equal(blk["exp"]["wt"][:, :40], blk["exp"]["w"].t())
    assert not blk["exp"]["wt"][:, 40:].any() and not blk["prj"]["wt"][:, 72:].any()
    kw = kernel_weights(blk["exp"], blk["dw"], blk["prj"])
    assert all(kw[n] is blk[n]["wt"] for n in ("exp", "dw", "prj"))


@pytest.mark.parametrize("se", [0, 8])
def test_launch_arguments_read_the_uploaded_forms(se):
    """What a launch keeps per key (`_prepare_i8`): the layers' uploaded
    forms and factors in the C entry's order, x's padded channels, the SE
    scratch, and the per-layer bounds; a layer with no form raises (the
    card never makes one per call)."""
    q = _layers(11, 24, 144, 40, 3, se, False)
    blk = {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}
    v3_i8_kernel_weights(blk)
    x = torch.zeros((2, 14, 14, 24), dtype=torch.int8)
    args = (x, blk["exp"], blk["dw"], blk["prj"], blk.get("se1"), blk.get("se2"))
    kw = dict(k=3, stride=1, act="hswish", residual=False)
    call = v3_block_i8_mod._prepare_i8("t", *args, **kw)
    assert call.cx == 32 and call.out_shape == (2, 14, 14, 40)
    assert call.scratch == ((2 * 144, 2 * 144, 2 * 196 * 144) if se else (0, 0, 0))
    want = [blk["exp"]["wt"], blk["exp"]["b"], blk["exp"]["a"], blk["dw"]["wt"],
            blk["dw"]["b"], blk["dw"]["a"], blk["prj"]["wt"], blk["prj"]["b"], blk["prj"]["m"]]
    if se:
        want += [blk["se1"]["w"], blk["se1"]["b"], blk["se1"]["m"], blk["se2"]["w"],
                 blk["se2"]["b"], blk["se2"]["a"]]
    assert call.weights == tuple(t.data_ptr() for t in want) + (0,) * (0 if se else 6)
    assert call.dims[-4:] == (blk["exp"]["m6"], blk["dw"]["m6"], qops._f32(1 / 196),
                              qops._f32(1 / 6))
    del blk["dw"]["wt"]
    with pytest.raises(ValueError, match="v3_i8_kernel_weights"):
        v3_block_i8_mod._prepare_i8("t", *args, **kw)


def test_call_key_sees_what_the_launch_reads():
    """Two calls share a kept launch only when `_call_key` is equal: a new
    input of the same shape shares it; another shape of x, another tensor
    in a layer, another six_q or another option does not."""
    q = {k: _quant_layer(rng.normal(0, sc, shape).astype(np.float32),
                         rng.normal(0, 0.1, (shape[ax],)).astype(np.float32), ax,
                         np.float32(0.05), ACT_HIDDEN_SCALE)
         for rng in [np.random.default_rng(2)]
         for k, shape, ax, sc in (("exp", (16, 96), 1, 0.25), ("dw", (3, 3, 1, 96), 3, 0.3),
                                  ("prj", (96, 24), 1, 0.1))}
    layers = [device_layer(q[k], "cpu") for k in ("exp", "dw", "prj")]
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    opts = (3, 1, "relu6", False)

    def key(x=x, layers=layers, opts=opts):
        return v3_block_i8_mod._call_key(x, (*layers, None, None), opts)

    assert key() == key(x=torch.ones((1, 8, 8, 16), dtype=torch.int8))
    assert key() != key(x=torch.zeros((2, 8, 8, 16), dtype=torch.int8))
    assert key() != key(opts=(3, 1, "relu6", True))
    moved = [dict(layers[0]), layers[1], dict(layers[2], b=layers[2]["b"].clone())]
    assert key() != key(layers=moved)
    assert key() != key(layers=[dict(layers[0], six_q=100.37), *layers[1:]])


# -- the unit walk in torch ------------------------------------------------------


def _i8(bits: torch.Tensor) -> torch.Tensor:
    """The low byte of int32 words, as int8."""
    return (((bits & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def f32_of(v: torch.Tensor, magic) -> torch.Tensor:
    """float32 of int32 sums: the magic-number conversion where `magic`
    (exact while |v| < 2^22), else the correctly rounded one."""
    fast = (v.to(torch.int32) + MAGIC_I).view(torch.float32) - MAGIC_F
    return torch.where(torch.as_tensor(magic), fast, v.to(torch.int32).float())


def requant(v, mult, m6, act, magic) -> torch.Tensor:
    """The kernel's requant of int32 sums (bias included), in float32: the
    named act in the folded order, clamped before the rounding (relu and
    relu6 to [0, m6], the layer's upper bound: 127, or float32 min(six_q,
    127); the others to [-128, 127]), rounded by adding 1.5 * 2^23; the low
    byte of its bits."""
    f = f32_of(v, magic)
    if act == "hswish":
        a = f * mult
        y = (a * (a + 3.0).clamp(0.0, 6.0)) * m6
    else:
        y = f * mult
    y = y.clamp(0.0, m6) if act in ("relu", "relu6") else y.clamp(-128.0, 127.0)
    return _i8((y + MAGIC_F).view(torch.int32))


def _table_taps(table, k):
    """The (k*k, E) taps back out of the kernel's dp4a table."""
    b = table.view(torch.int8).reshape(table.shape[0], -1, 4)
    e = b.shape[1]
    rows = [b[q].t() for q in range(k * k // 4)]
    return torch.cat(rows + [b[-1][torch.arange(e), torch.arange(e) % 4][None]])[:k * k]


def unit_walk_i8(x, exp, dw, prj, *, k, stride, act, se1=None, se2=None, residual=False,
                 plan):
    """The tile's computation, unit by unit on `plan`'s geometry, in torch:
    the kernel's weight forms (`kernel_weights`); each unit stages its
    (th-1)s+k x (tw-1)s+k window of x padded to 16 channels (zeros outside
    the image), expands it in 128-channel chunks of E, 64 columns at a time
    (int32 sums + bias, the requant, zero outside the image and past E), runs
    the depthwise of its outputs from the table (+ bias, the requant), and
    either projects its part (int32 sums over the chunks, + bias, the
    linear requant, the saturating residual from the window) or, with SE,
    stores the pre-gate tensor and adds its sums to the image's; pass 2 gates
    that tensor per unit and projects it (the residual from x). Every output
    element is written by exactly one unit."""
    n, h, w, cin = x.shape
    identity = exp is None
    e, cout = int(dw["w"].shape[-1]), int(prj["w"].shape[-1])
    cx, ep = -(-cin // 16) * 16, -(-e // 16) * 16
    kw = kernel_weights(exp, dw, prj)
    pad = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    ho, wo = -(-h // stride), -(-w // stride)
    ph, pw = (plan.th - 1) * stride + k, (plan.tw - 1) * stride + k
    xin = torch.nn.functional.pad(x, (0, cx - cin)).to(torch.int32)
    big = torch.zeros((n, h + ph + 2 * k, w + pw + 2 * k, cx), dtype=torch.int32)
    big[:, k:k + h, k:k + w] = xin
    taps = _table_taps(kw["dw"], k).to(torch.int32)
    mult = "a" if act == "hswish" else "m"
    dbias = dw["b"].to(torch.int32)
    dmagic = (dbias.abs() <= 2 ** 21).reshape(-1, 8).all(1).repeat_interleave(8)
    chunks = -(-e // 128)

    def tile_z(img, oy0, ox0):
        iy0, ix0 = oy0 * stride - pad, ox0 * stride - pad
        win = big[img, k + iy0:k + iy0 + ph, k + ix0:k + ix0 + pw]
        if identity:
            return win[..., :e], win
        inside = (((torch.arange(ph) + iy0 >= 0) & (torch.arange(ph) + iy0 < h))[:, None]
                  & ((torch.arange(pw) + ix0 >= 0) & (torch.arange(pw) + ix0 < w))[None, :])
        z = torch.zeros((ph, pw, chunks * 128), dtype=torch.int8)
        room = 2 ** 22 - cx * 2 ** 14
        for c0 in range(0, chunks * 128, 64):  # a chunk's 64-column halves
            if c0 >= e:
                continue
            cols = slice(c0, min(c0 + 64, e))
            acc = (win.reshape(-1, cx).long() @ kw["exp"][cols].long().t()).to(torch.int32)
            b = exp["b"][cols]
            magic = bool((b.abs() < room).all())
            q = requant(acc + b, exp[mult][cols], requant_bound(exp, act), act, magic)
            z[..., cols] = torch.where(inside[..., None], q.reshape(ph, pw, -1),
                                       torch.zeros((), dtype=torch.int8))
        return z[..., :e], win

    def tile_dw(z):
        acc = dbias.expand(plan.th, plan.tw, e).clone()
        for t in range(k * k):
            dy, dx = divmod(t, k)
            tap = z[dy:dy + (plan.th - 1) * stride + 1:stride,
                    dx:dx + (plan.tw - 1) * stride + 1:stride].to(torch.int32)
            acc = acc + tap * taps[t]
        return requant(acc, dw[mult], requant_bound(dw, act), act, dmagic)

    def extent(oy0, ox0):
        return min(plan.th, ho - oy0), min(plan.tw, wo - ox0)

    def project(a, c0, win, xres):
        """a (th, tw, E) int8 -> the part's (th, tw, cw) int8 outputs."""
        cols = slice(c0, c0 + plan.cw)
        acc = torch.zeros((plan.th * plan.tw, plan.cw), dtype=torch.int64)
        for c in range(chunks):  # int32 sums over the chunks (exact in any order)
            ch = slice(128 * c, min(128 * (c + 1), e))
            acc += a.reshape(-1, e)[:, ch].long() @ kw["prj"][cols, ch].long().t()
        b = prj["b"][cols]
        magic = bool((b.abs().long() < 2 ** 22 - e * 2 ** 14).all())
        o = requant(acc.to(torch.int32) + b, prj["m"][cols], 0.0, "linear", magic)
        o = o.reshape(plan.th, plan.tw, -1)
        if residual:
            r = xres[..., cols] if xres is not None else \
                win[pad:pad + plan.th, pad:pad + plan.tw, cols]
            o = (o.to(torch.int32) + r).clamp(-128, 127).to(torch.int8)
        return o

    out = torch.full((n, ho, wo, cout), -999, dtype=torch.int16)

    def put(img, oy0, ox0, c0, o):
        th, tw = extent(oy0, ox0)
        dst = out[img, oy0:oy0 + th, ox0:ox0 + tw, c0:c0 + plan.cw]
        assert (dst == -999).all(), "an output element written twice"
        dst.copy_(o[:th, :tw])

    if se1 is None:
        for img, oy0, ox0, c0 in _units(n, ho, wo, plan, False):
            z, win = tile_z(img, oy0, ox0)
            put(img, oy0, ox0, c0, project(tile_dw(z), c0, win, None))
    else:
        zs = torch.zeros((n, ho, wo, ep), dtype=torch.int8)  # pass 1's pre-gate tensor
        sums = torch.zeros((n, e), dtype=torch.int64)
        for img, oy0, ox0, _ in _units(n, ho, wo, plan, True):
            z, _ = tile_z(img, oy0, ox0)
            y = tile_dw(z)
            th, tw = extent(oy0, ox0)
            zs[img, oy0:oy0 + th, ox0:ox0 + tw, :e] = y[:th, :tw]
            sums[img] += y[:th, :tw].long().sum((0, 1))
        # the gate step, once an image (integer products exact in any order)
        pq = (sums.to(torch.int32).float() * np.float32(1.0 / (ho * wo))).round()
        pq = pq.clamp(-128, 127)
        g1 = pq.long() @ se1["w"].long() + se1["b"]
        g1 = (g1.to(torch.int32).float() * se1["m"]).round().clamp(0, 127)
        a2 = (g1.long() @ se2["w"].long() + se2["b"]).to(torch.int32).float() * se2["a"]
        gate = (a2 + 3.0).clamp(0.0, 6.0) * np.float32(1.0 / 6.0)
        zpad = torch.zeros((n, ho + plan.th, wo + plan.tw, ep), dtype=torch.int8)
        zpad[:, :ho, :wo] = zs
        xpad = torch.zeros((n, h + plan.th, w + plan.tw, cx), dtype=torch.int32)
        xpad[:, :h, :w] = xin  # the residual (stride 1: x at the output pixel)
        for img, oy0, ox0, c0 in _units(n, ho, wo, plan, False):  # pass 2
            zt = zpad[img, oy0:oy0 + plan.th, ox0:ox0 + plan.tw, :e]
            a = _i8(((zt.float() * gate[img]).clamp(-128.0, 127.0) + MAGIC_F)
                    .view(torch.int32))
            xr = xpad[img, oy0:oy0 + plan.th, ox0:ox0 + plan.tw] if residual else None
            put(img, oy0, ox0, c0, project(a, c0, None, xr))
    assert not (out == -999).any(), "an output element never written"
    return out.to(torch.int8)


def _layers(seed, cin, e, cout, k, se, identity, prj_gain=1.0):
    """QLayerN's of one block, quantized from random float weights with
    non-zero biases at fixed scales (input 0.05, expansion and depthwise
    0.06, SE mid 0.03, the projection at the input's scale / prj_gain)."""
    rng = np.random.default_rng(seed)

    def lay(shape, axis, s_in, s_out, scale, b_scale, **kw):
        wt = rng.normal(0, scale, shape).astype(np.float32)
        b = rng.normal(0, b_scale, (shape[axis],)).astype(np.float32)
        return _quant_named(wt, b, axis, s_in, s_out, **kw)

    s_x, s_e, s_d, s_g = 0.05, 0.06, 0.06, 0.03
    q = {"dw": lay((k, k, 1, e), 3, s_x if identity else s_e, s_d, 0.3, 0.2, k_taps=k * k),
         "prj": lay((e, cout), 1, s_d, s_x / prj_gain, e ** -0.5, 0.2)}
    if not identity:
        q["exp"] = lay((cin, e), 1, s_x, s_e, 1.5 * cin ** -0.5, 0.3)
    if se:
        q["se1"] = lay((e, se), 1, s_d, s_g, e ** -0.5, 0.3)
        q["se2"] = lay((se, e), 1, s_g, 1.0, se ** -0.5, 0.3)
    return q


def _jax(layer):
    return {"w": jnp.asarray(layer.w_i8), "b": jnp.asarray(layer.bias_i32),
            "a": jnp.asarray(layer.a), "inv_s": float(layer.inv_s)}


def _dev(q):
    return {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}


def _walk(x, dev, plan, **kw):
    return unit_walk_i8(torch.from_numpy(x), dev.get("exp"), dev["dw"], dev["prj"],
                        se1=dev.get("se1"), se2=dev.get("se2"), plan=plan, **kw).numpy()


# (n, h, cin, e, cout, k, stride, se, act, residual, identity, forced plan or None)
WALKS = [
    (2, 8, 16, 16, 16, 3, 1, 0, "relu", True, True, None),         # V3-L b00: identity
    (2, 8, 16, 64, 24, 3, 2, 0, "relu", False, False, None),       # b01: expansion at s2
    (2, 8, 24, 72, 24, 3, 1, 0, "relu", True, False, None),        # b02: Cin 24, E tail
    (2, 8, 24, 72, 40, 5, 2, 24, "relu", False, False, None),      # b03: k5 s2 SE
    (1, 6, 40, 120, 40, 5, 1, 32, "relu", True, False, None),      # b04: Cin 40, SE + res
    (2, 8, 40, 240, 80, 3, 2, 0, "hswish", False, False, None),    # b06: two chunks
    (1, 5, 80, 200, 80, 3, 1, 0, "hswish", True, False, None),     # b07: odd side
    (1, 4, 160, 960, 160, 5, 1, 240, "hswish", True, False, None),  # b13: Cin 160, 8 chunks
    (2, 8, 16, 16, 16, 3, 2, 8, "relu", False, True, None),        # V3-S b00: identity s2 SE
    (1, 6, 48, 144, 48, 5, 1, 40, "hswish", True, False, None),    # V3-S b07
    # forced plans: ragged tiles at both edges, Cout parts off 16 columns
    (2, 9, 40, 120, 40, 5, 1, 32, "hswish", True, False, V3I8Plan(2, 4, 5, 8, 2, 2)),
    (1, 10, 24, 72, 40, 5, 2, 24, "relu", False, False, V3I8Plan(3, 2, 5, 8, 1, 2)),
    (2, 7, 80, 200, 80, 3, 1, 0, "hswish", True, False, V3I8Plan(4, 3, 2, 40, 1, 2)),
    (1, 11, 16, 16, 16, 3, 1, 0, "relu", True, True, V3I8Plan(4, 5, 2, 8, 2, 2)),
]


def _plan(n, h, cin, e, cout, k, stride, se, identity, forced):
    return forced or v3_i8_wgmma_plan(n, h, h, cin, e, cout, k, stride, se, identity)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity,forced", WALKS)
def test_unit_walk_is_the_block(n, h, cin, e, cout, k, stride, se, act, residual, identity,
                                forced):
    """The unit walk equals `v3_block_i8_plain` (the wrapper's CPU version)
    bit for bit: windows, the padding of the expanded tensor, the chunks and
    their tails, the tile edges, the Cout parts, the stored pre-gate tensor
    and the gate cover the block exactly."""
    q = _layers(n * h + cin + e + k, cin, e, cout, k, se, identity)
    dev = _dev(q)
    x = np.random.default_rng(e + h).integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    kw = dict(k=k, stride=stride, act=act, residual=residual)
    got = _walk(x, dev, _plan(n, h, cin, e, cout, k, stride, se, identity, forced), **kw)
    want = v3_block_i8(torch.from_numpy(x), dev.get("exp"), dev["dw"], dev["prj"],
                       se1=dev.get("se1"), se2=dev.get("se2"), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity,forced",
                         [w for w in WALKS if not w[10]])
def test_unit_walk_vs_v3_block_pallas_i8(n, h, cin, e, cout, k, stride, se, act, residual,
                                         identity, forced):
    """The unit walk against the JAX package's `v3_block_pallas_i8` in
    interpret mode (the folded requant), exactly."""
    q = _layers(n + h + e, cin, e, cout, k, se, identity)
    x = np.random.default_rng(cin + k).integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    kw = dict(k=k, stride=stride, act=act, residual=residual)
    want = v3_block_pallas_i8(jnp.asarray(x), _jax(q["exp"]), _jax(q["dw"]), _jax(q["prj"]),
                              se1=_jax(q["se1"]) if se else None,
                              se2=_jax(q["se2"]) if se else None, interpret=True, fold=True,
                              **kw)
    got = _walk(x, _dev(q), _plan(n, h, cin, e, cout, k, stride, se, identity, forced), **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_unit_walk_saturating_residual():
    """Inputs at the rails and a projection driven past the int8 range: the
    walk's residual saturates at both rails, equal to the JAX kernel."""
    q = _layers(3, 40, 120, 40, 5, 32, False, prj_gain=8.0)
    x = np.where(np.random.default_rng(4).random((1, 6, 6, 40)) < 0.5, 120, -120).astype(np.int8)
    kw = dict(k=5, stride=1, act="hswish", residual=True)
    want = v3_block_pallas_i8(jnp.asarray(x), _jax(q["exp"]), _jax(q["dw"]), _jax(q["prj"]),
                              se1=_jax(q["se1"]), se2=_jax(q["se2"]), interpret=True,
                              fold=True, **kw)
    got = _walk(x, _dev(q), v3_i8_wgmma_plan(1, 6, 6, 40, 120, 40, 5, 1, 32, False), **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got == 127).any() and (got == -128).any()


def test_unit_walk_vs_packed_block_i8_named():
    """V3-Large block 0 (identity, stride 1, residual): the JAX package's
    lane-packed named-act kernel with the residual added as quant/v3.py adds
    it, against the walk."""
    q = _layers(11, 16, 16, 16, 3, 0, True)
    x = np.random.default_rng(12).integers(-128, 128, (2, 8, 16, 16)).astype(np.int8)
    xp = pack(jnp.asarray(x, jnp.bfloat16), 16)
    d, p = q["dw"], q["prj"]
    yp = packed_block_i8_named(xp, jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32),
                               jnp.asarray(d.a), jnp.asarray(p.w_i8), jnp.asarray(p.bias_i32),
                               jnp.asarray(p.a), 16, 16, "relu", float(d.inv_s),
                               float(p.inv_s), out_dtype="bfloat16", interpret=True, fold=True)
    yp = jnp.clip(yp.astype(jnp.float32) + xp.astype(jnp.float32), -128, 127)
    want = np.asarray(yp.astype(jnp.float32)).reshape(2, 8, 16, 16).astype(np.int8)
    got = _walk(x, _dev(q), V3I8Plan(3, 5, 2, 8, 2, 2), k=3, stride=1, act="relu",
                residual=True)
    np.testing.assert_array_equal(got, want)


def test_unit_walk_vs_packed_block_i8_named_s2():
    """V3-Large block 1 (112^2 x 16 -> E64 -> 24 at stride 2; 8 x 16 here):
    the JAX package's XLA expansion, then its lane-packed stride-2 kernel,
    against the walk's own expansion."""
    q = _layers(13, 16, 64, 24, 3, 0, False)
    x = np.random.default_rng(14).integers(-128, 128, (2, 8, 16, 16)).astype(np.int8)
    ex, d, p = q["exp"], q["dw"], q["prj"]
    ye = packed_expand_i8_named(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ex.w_i8),
                                jnp.asarray(ex.bias_i32), jnp.asarray(ex.a), ex.inv_s, "relu")
    pad = ((0, 0), (0, 128 - 24))
    yp = packed_block_i8_named_s2(
        pack(ye, 64), jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32), jnp.asarray(d.a),
        jnp.pad(jnp.asarray(p.w_i8), pad), jnp.pad(jnp.asarray(p.bias_i32), pad[1]),
        jnp.pad(jnp.asarray(p.a), pad[1]), 64, 128, "relu", float(d.inv_s), float(p.inv_s),
        out_dtype="int8", interpret=True, fold=True)
    want = np.asarray(yp).reshape(2, 4, 8, 128)[..., :24]
    got = _walk(x, _dev(q), V3I8Plan(3, 3, 3, 8, 2, 2), k=3, stride=2, act="relu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fold", [True, False])
def test_unit_walk_vs_packed_block_i8_named_s2_se(fold):
    """V3-Small block 0 (identity, k 3, stride 2, SE 8, relu): the JAX
    package's lane-packed kernel with the in-kernel quantized SE against the
    walk's stored pre-gate tensor and gated pass 2."""
    q = _layers(21, 16, 16, 16, 3, 8, True)
    x = np.random.default_rng(22).integers(-128, 128, (2, 16, 16, 16)).astype(np.int8)
    d, p, s1, s2 = q["dw"], q["prj"], q["se1"], q["se2"]
    r2 = (128 // 16) // 2
    cout_p = -(-16 // (128 // r2)) * (128 // r2)
    pad = (0, cout_p - 16)
    yp = packed_block_i8_named_s2_se(
        pack(jnp.asarray(x, jnp.bfloat16), 16), jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32),
        jnp.asarray(d.a), jnp.asarray(s1.w_i8), jnp.asarray(s1.bias_i32), jnp.asarray(s1.a),
        jnp.asarray(s2.w_i8), jnp.asarray(s2.bias_i32), jnp.asarray(s2.a),
        jnp.pad(jnp.asarray(p.w_i8), ((0, 0), pad)), jnp.pad(jnp.asarray(p.bias_i32), pad),
        jnp.pad(jnp.asarray(p.a), pad), 16, cout_p, "relu", float(d.inv_s), float(s1.inv_s),
        float(p.inv_s), out_dtype="int8", interpret=True, fold=fold)
    yp = np.asarray(yp)
    want = yp.reshape(yp.shape[0], yp.shape[1], -1, cout_p)[..., :16]
    got = _walk(x, _dev(q), V3I8Plan(4, 3, 2, 8, 2, 2), k=3, stride=2, act="relu")
    np.testing.assert_array_equal(got, want)


def test_magic_conversion_and_its_guard():
    """f32 by the magic number is exact below 2^22 and wrong beyond; with
    biases large enough to break it the walk's guards (expansion: |b| <
    2^22 - Cx * 2^14 a 64-column half; depthwise: |b| <= 2^21 a group of 8;
    projection: |b| < 2^22 - E * 2^14 a part) take the exact conversion and
    the walk still equals the plain version; clamping before the rounding
    equals clamping after."""
    v = torch.tensor([0, 1, -1, 2 ** 22 - 1, -(2 ** 22) + 1, 3, -7], dtype=torch.int32)
    assert torch.equal(f32_of(v, True), v.float())
    big = torch.tensor([2 ** 22 + 1, 2 ** 23 + 3], dtype=torch.int32)
    assert not torch.equal(f32_of(big, True), big.float())
    y = torch.linspace(-300.0, 300.0, 2401)
    after = y.round().clamp(-128, 127)
    before = _i8((y.clamp(-128.0, 127.0) + MAGIC_F).view(torch.int32)).float()
    assert torch.equal(before, after)
    dev = _dev(_layers(31, 24, 72, 24, 3, 0, False))
    for name, big, room in (("exp", 3_700_000, 2 ** 22 - 32 * 2 ** 14),
                            ("dw", 2_200_000, 2 ** 21), ("prj", 3_100_000, 2 ** 22 - 72 * 2 ** 14)):
        dev[name]["b"][::5] = big  # past the guard: the exact conversion there
        dev[name]["b"][1::5] = -big
        dev[name]["m"][::5] /= 1000.0
        dev[name]["a"][::5] /= 1000.0
        assert big > room
    x = np.random.default_rng(32).integers(-128, 128, (1, 6, 6, 24)).astype(np.int8)
    kw = dict(k=3, stride=1, act="relu", residual=True)
    got = _walk(x, dev, v3_i8_wgmma_plan(1, 6, 6, 24, 72, 24, 3, 1, 0, False), **kw)
    want = v3_block_i8_plain(torch.from_numpy(x), dev["exp"], dev["dw"], dev["prj"], **kw)
    np.testing.assert_array_equal(got, want.numpy())


# -- MobileNet-V2: the ReLU6 requant ----------------------------------------------


def _v2_layers(seed, cin, e, cout, six_q):
    """A V2 int8 block's QuantLayers (quant/quantize._quant_layer, as
    quant/v2.quantize_v2 makes them: the expansion and depthwise at the fixed
    6/127 scale, the projection into a bottleneck scale of 0.05) with six_q
    set to `six_q` (127, or a recalibrated bound below it)."""
    rng = np.random.default_rng(seed)

    def lay(shape, axis, s_in, s_out, scale, **kw):
        return _quant_layer((rng.normal(0, 1, shape) * scale).astype(np.float32),
                            rng.normal(0, 0.1, (shape[axis],)).astype(np.float32), axis,
                            s_in, s_out, **kw)

    s_x = np.float32(0.05)
    q = {"exp": lay((cin, e), 1, s_x, ACT_HIDDEN_SCALE, 2.0 * cin ** -0.5),
         "dw": lay((3, 3, 1, e), 3, ACT_HIDDEN_SCALE, ACT_HIDDEN_SCALE, 0.3,
                   dw_bias_bound=True),
         "prj": lay((e, cout), 1, ACT_HIDDEN_SCALE, s_x, e ** -0.5)}
    q["exp"].six_q = q["dw"].six_q = np.float32(six_q)
    return q


def _v2_case(seed, n, h, cin, e, cout, six_q):
    q = _v2_layers(seed, cin, e, cout, six_q)
    x = np.random.default_rng(seed + 1).integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    return q, x, {name: device_layer(layer, "cpu") for name, layer in q.items()}


def _v2_oracle(q, x, stride, residual):
    """V2's oracle sequence (the JAX package's quant/oracle and quant/v2)."""
    e, d, p = q["exp"], q["dw"], q["prj"]
    z = jax_oracle.pw_i8(x, e.w_i8, e.bias_i32, e.m, e.six_q)
    z = jax_oracle.dw3x3_i8(z, d.w_i8, d.bias_i32, d.m, d.six_q, stride)
    y = pw_i8_linear(z, p.w_i8, p.bias_i32, p.m)
    return _res_add(y, x) if residual else y


# (n, h, cin, e, cout, stride, residual, forced plan or None): V2's block classes
V2_WALKS = [
    (2, 8, 16, 96, 24, 2, False, None),      # b01: Cin 16 at stride 2
    (2, 7, 24, 144, 24, 1, True, None),      # b02: Cin 24 (padded), residual, odd side
    (1, 6, 32, 192, 64, 2, False, None),     # b06
    (1, 6, 96, 576, 160, 2, False, None),    # b13: the JAX package's V3 bridge
    (1, 4, 160, 960, 320, 1, False, None),   # b16: E tail, Cout 320 in parts
    (2, 9, 8, 48, 8, 1, True, V3I8Plan(4, 2, 1, 8, 2, 2)),  # alpha 0.35: ragged tiles
]


@pytest.mark.parametrize("six_q", [127.0, 100.37])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual,forced", V2_WALKS)
def test_unit_walk_relu6_is_the_v2_block(six_q, n, h, cin, e, cout, stride, residual, forced):
    """The unit walk with the ReLU6 bound equals the V2 block's plain version
    (`inverted_residual_i8` on CPU tensors) and V2's oracle sequence bit for
    bit; at six_q 100.37 the bound is reached."""
    q, x, dev = _v2_case(n * h + e, n, h, cin, e, cout, six_q)
    plan = forced or v3_i8_wgmma_plan(n, h, h, cin, e, cout, 3, stride, 0, False)
    got = _walk(x, dev, plan, k=3, stride=stride, act="relu6", residual=residual)
    t = torch.from_numpy
    ex, d, p = q["exp"], q["dw"], q["prj"]
    want = inverted_residual_i8(t(x), t(ex.w_i8), t(ex.bias_i32), t(ex.m), float(ex.six_q),
                                t(d.w_i8), t(d.bias_i32), t(d.m), float(d.six_q), t(p.w_i8),
                                t(p.bias_i32), t(p.m), stride, residual).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _v2_oracle(q, x, stride, residual))
    z = jax_oracle.pw_i8(x, ex.w_i8, ex.bias_i32, ex.m, ex.six_q)
    assert int(z.max()) == min(round(six_q), 127)


@pytest.mark.parametrize("six_q", [127.0, 100.37])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual,forced", [
    w for w in V2_WALKS if w[1] * w[0] <= 16])
def test_unit_walk_relu6_vs_inverted_residual_pallas_i8(six_q, n, h, cin, e, cout, stride,
                                                        residual, forced):
    """The unit walk with the ReLU6 bound against the JAX package's
    `inverted_residual_pallas_i8` in interpret mode (as its own tests run
    it), exactly."""
    q, x, dev = _v2_case(cin + e + h, n, h, cin, e, cout, six_q)
    ex, d, p = q["exp"], q["dw"], q["prj"]
    j = jnp.asarray
    want = inverted_residual_pallas_i8(
        j(x), j(ex.w_i8), j(ex.bias_i32), ex.m, float(ex.six_q), j(d.w_i8), j(d.bias_i32),
        d.m, float(d.six_q), j(p.w_i8), j(p.bias_i32), p.m, stride, residual, interpret=True)
    plan = forced or v3_i8_wgmma_plan(n, h, h, cin, e, cout, 3, stride, 0, False)
    got = _walk(x, dev, plan, k=3, stride=stride, act="relu6", residual=residual)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_unit_walk_relu6_vs_expand_block_packed_s2_i8():
    """V2 block 1's class (16 -> 24, E 96, stride 2) against the JAX
    package's lane-packed stride-2 expand block, called as its V2 route
    calls it (relu with a = m and inv_s = 1.0: six_q 127, Cout padded 24 ->
    32, the input carried as bf16 integers)."""
    q, x, dev = _v2_case(41, 2, 8, 16, 96, 24, 127.0)
    ex, d, p = q["exp"], q["dw"], q["prj"]
    j = jnp.asarray
    pad = 8
    out = expand_block_packed_s2_i8(
        pack(j(x).astype(jnp.bfloat16), 16), j(ex.w_i8), j(ex.bias_i32), j(ex.m), j(d.w_i8),
        j(d.bias_i32), j(d.m), j(np.pad(p.w_i8, ((0, 0), (0, pad)))),
        j(np.pad(p.bias_i32, (0, pad))), j(np.pad(p.m, (0, pad))), 16, "relu", 1.0, 1.0, 1.0,
        out_dtype="int8", interpret=True, fold=True)
    want = np.asarray(out).reshape(2, 4, 4, 32)[..., :24]
    got = _walk(x, dev, V3I8Plan(3, 2, 3, 8, 2, 2), k=3, stride=2, act="relu6")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("six_q", [127.0, 100.37, 6.5])
def test_relu6_bound_is_requantize(six_q):
    """The kernel's ReLU6 requant (a clamp to [0, float32 min(six_q, 127)]
    before the magic-number rounding) equals `quant/ops.requantize`'s
    clamp(rint(clamp(f32(acc) * m, 0, six_q)), -128, 127) on sums over the
    whole range, both conversions; so does a bound past 127."""
    rng = np.random.default_rng(int(six_q * 100))
    v = torch.from_numpy(rng.integers(-(2 ** 21), 2 ** 21, 4096).astype(np.int32))
    m = torch.from_numpy(rng.uniform(1e-5, 2e-4, 4096).astype(np.float32))
    layer = {"m": m, "six_q": six_q}
    want = qops.requantize(v, m, six_q, True)
    for magic in (True, False):
        got = requant(v, m, requant_bound(layer, "relu6"), "relu6", magic)
        assert torch.equal(got, want)
    assert int(want.max()) == min(round(six_q), 127) and int(want.min()) == 0
    big = {"m": m, "six_q": 300.0}
    assert torch.equal(requant(v, m, requant_bound(big, "relu6"), "relu6", True),
                       qops.requantize(v, m, 300.0, True))
