"""The bf16 MobileNet-V3 bottleneck's Hopper tile (`csrc/v3_wgmma.cuh`) on
the CPU: its plan (`v3_wgmma_plan`, the fits-function of every bf16 call)
at every block of V3-Large, V3-Large-minimalistic and V3-Small 1.0-224, and
a mirror of the tile's unit walk in torch on the plan's geometry (units of
an output tile x a part of Cout, the input window with zeros outside the
image, the expanded tensor zeroed outside the image before the depthwise,
64-channel chunks of E with a ragged tail, the per-tile squeeze-excite sums
in tile order, the residual from the window), held against
`v3_block_plain` and against the JAX package's `v3_block_pallas` and
`se_block_packed` in interpret mode. The card tests (tests/test_torch_cuda.py)
hold the kernel itself and its shared-memory arithmetic against this
module's plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack
from mobilenet_tpu.ops.pallas_ir_v3 import v3_block_pallas
from mobilenet_tpu.ops.pallas_se_packed import se_block_packed, se_packed_geometry
from mobilenet_tpu_torch import V3Config
from mobilenet_tpu_torch.block_times import v3_library
from mobilenet_tpu_torch.ops.conv import apply_act_named
from mobilenet_tpu_torch.ops.v3_block import (
    SMEM_MAX, V3W_SMEM_LIMIT, V3W_TM, V3WPlan, v3_block, v3_block_plain, v3_wgmma_plan,
    v3_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_chain import SHAPE_BYTES, v3_chain, v3_chain_fits

F32_TOL = dict(atol=2e-5, rtol=1e-5)
# the port's bf16 kernel tolerance (tests/test_torch_v3_block.py)
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)
WGMMA_N = (8, 16, 32, 64, 128)

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
    plan = v3_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                         bd.se_mid, not bd.has_expand)
    return h, bd, plan


def _slices(cw):
    """The kernel's output slices of a part (make_geo's nbig and nsmall): a
    128- or 64-column slice while the part is that wide, then the binary
    digits of the rest."""
    nbig = 2 if cw >= 128 else 1 if cw >= 64 else 0
    small = (cw - 64 * nbig) // 8
    return ([64 * nbig] if nbig else []) + [8 * b for b in (4, 2, 1) if small & b]


@pytest.mark.parametrize("name,batch,i", BLOCK_CASES,
                         ids=[f"{n}-{b}-b{i:02d}" for n, b, i in BLOCK_CASES])
def test_plan_fits_the_card(name, batch, i):
    """Every bf16 block of the three 1.0-224 variants has a plan at batch
    256 and 1: a tile of at most 128 outputs of one image, window sides
    within a TMA box, shared memory within 227 KB less the chain's reserve
    for a stage's shape, whole parts of Cout, ring slots the kernel takes."""
    h, bd, p = _plan_of(name, batch, i)
    assert p is not None
    ho = -(-h // bd.stride)
    assert 1 <= p.th <= ho and 1 <= p.tw <= ho and p.th * p.tw <= V3W_TM
    assert (p.th - 1) * bd.stride + bd.kernel <= 256 and (p.tw - 1) * bd.stride + bd.kernel <= 256
    assert p.split * p.cw == bd.cout and p.cw % 8 == 0
    assert 1 <= p.ws <= 4 and 2 <= p.bs <= 4
    smem = v3_wgmma_smem_bytes(p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, p.cw,
                               p.ws, p.bs, not bd.has_expand)
    assert smem <= V3W_SMEM_LIMIT and smem + SHAPE_BYTES <= SMEM_MAX
    # the chain's gate step keeps pooled, hidden and the products' segment
    # sums (8 x Se, 4 x E floats) in the tile's memory (v3_wgmma.cuh gate_floats)
    if bd.se_mid:
        assert (5 * bd.cexp + 9 * bd.se_mid) * 4 <= smem - 2048


@pytest.mark.parametrize("name,batch,i", BLOCK_CASES,
                         ids=[f"{n}-{b}-b{i:02d}" for n, b, i in BLOCK_CASES])
def test_plan_slices_are_wgmma_widths(name, batch, i):
    """A part's slices are wgmma N widths that add up to the part exactly:
    no column of a slice is padding."""
    _, _, p = _plan_of(name, batch, i)
    widths = _slices(p.cw)
    assert sum(widths) == p.cw and all(w in WGMMA_N for w in widths)
    assert len(widths) == len(set(widths)) and widths == sorted(widths, reverse=True)


def _units(n, ho, wo, plan, pool):
    """The kernel's unit walk (v3_wgmma.cuh unit_of): (image, tile origin,
    first column) of every unit of a pass; pass 1 does not split Cout."""
    tiles_w, tiles_h = -(-wo // plan.tw), -(-ho // plan.th)
    split = 1 if pool else plan.split
    for u in range(n * tiles_h * tiles_w * split):
        t, part = divmod(u, split)
        img, ti = divmod(t, tiles_h * tiles_w)
        tr, tc = divmod(ti, tiles_w)
        yield img, ti, tr * plan.th, tc * plan.tw, part * plan.cw


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch", [2, 1])
def test_units_cover_every_output_once(name, batch):
    """Pass 2's units cover every output pixel and channel exactly once;
    pass 1's (SE blocks) every output pixel of every image once, each in a
    tile of its own image."""
    for i, h, bd in _blocks(CONFIGS[name]):
        p = v3_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                          bd.se_mid, not bd.has_expand)
        ho = -(-h // bd.stride)
        seen = np.zeros((batch, ho, ho, bd.cout), np.int32)
        for img, _, oy, ox, c0 in _units(batch, ho, ho, p, False):
            seen[img, oy:oy + p.th, ox:ox + p.tw, c0:c0 + p.cw] += 1
        assert (seen == 1).all(), f"b{i:02d}"
        pooled = np.zeros((batch, ho, ho), np.int32)
        for img, _, oy, ox, c0 in _units(batch, ho, ho, p, True):
            assert c0 == 0
            pooled[img, oy:oy + p.th, ox:ox + p.tw] += 1
        assert (pooled == 1).all(), f"b{i:02d}"


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch", [256, 1])
def test_chains_fit_the_new_plan(name, batch):
    """Every run the chain knobs form (blocks 1 to the last) fits one
    cooperative launch on the bf16 plans: the chain never loses a stage to
    the new tile's shared memory."""
    cfg = CONFIGS[name]
    h = cfg.resolution // 2 // cfg.block_defs[0].stride
    shapes = [(bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid)
              for bd in cfg.block_defs[1:]]
    assert v3_chain_fits(batch, h, h, shapes, 2)


# -- the unit walk in torch ------------------------------------------------------


def _gate(pooled, dtype, se):
    """The SE FCs of the kernel's gate step: round(pooled) -> f32 FC + b1,
    relu, rounded -> f32 FC + b2 -> hard sigmoid, in f32."""
    w1, b1, w2, b2 = se
    g = (pooled.to(dtype).float() @ w1.float() + b1.float()).clamp_min(0).to(dtype).float()
    g = g @ w2.float() + b2.float()
    return (g + 3.0).clamp(0, 6) * (1.0 / 6.0)


def unit_walk(x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, *, k, stride, act, se_w1=None,
              se_b1=None, se_w2=None, se_b2=None, residual=False, plan):
    """The tile's computation, unit by unit on `plan`'s geometry, in torch:
    each unit stages its (th-1)s+k x (tw-1)s+k input window (zeros outside
    the image, as TMA fills), expands it in chunks of 64 channels of E (f32
    product + bias, act, rounded; the window pixels outside the image set to
    zero: TF-SAME pads the expanded tensor), runs the depthwise of its tile's
    outputs (f32 taps in dy-then-dx order, + bias, act), and either sums them
    per channel (pass 1) or gates, rounds and projects the part's columns
    (f32 over the chunks, + bias, rounded, + the residual taken from the
    window, rounded). Every output element is written by exactly one unit."""
    dt = x.dtype
    n, h, w, cin = x.shape
    e, cout = dw_w.shape[-1], prj_w.shape[-1]
    identity = exp_w is None
    pad = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    ho, wo = -(-h // stride), -(-w // stride)
    ph, pw = (plan.th - 1) * stride + k, (plan.tw - 1) * stride + k
    tiles = -(-ho // plan.th) * -(-wo // plan.tw)
    # room for any window: pad and the far edge of the last tile
    big = torch.zeros((n, h + ph + 2 * k, w + pw + 2 * k, cin), dtype=dt)
    big[:, k:k + h, k:k + w] = x
    wts = dw_w.reshape(k, k, e).float()

    def tile_act(img, oy0, ox0):
        iy0, ix0 = oy0 * stride - pad, ox0 * stride - pad
        win = big[img, k + iy0:k + iy0 + ph, k + ix0:k + ix0 + pw]
        inside = (((torch.arange(ph) + iy0 >= 0) & (torch.arange(ph) + iy0 < h))[:, None]
                  & ((torch.arange(pw) + ix0 >= 0) & (torch.arange(pw) + ix0 < w))[None, :])
        if identity:
            z = win
        else:
            z = torch.cat([apply_act_named(win.float() @ exp_w[:, c:c + 64].float()
                                           + exp_b[c:c + 64].float(), act).to(dt)
                           for c in range(0, e, 64)], dim=-1)
            z = torch.where(inside[..., None], z, torch.zeros((), dtype=dt))
        acc = torch.zeros((plan.th, plan.tw, e))
        for dy in range(k):
            for dx in range(k):
                tap = z[dy:dy + (plan.th - 1) * stride + 1:stride,
                        dx:dx + (plan.tw - 1) * stride + 1:stride]
                acc = acc + tap.float() * wts[dy, dx]
        return apply_act_named(acc + dw_b.float(), act), win

    def extent(oy0, ox0):
        return min(plan.th, ho - oy0), min(plan.tw, wo - ox0)

    gate = None
    if se_w1 is not None:  # pass 1: per-tile sums, then each image's gate once
        sums = torch.zeros((n, tiles, e))
        for img, ti, oy0, ox0, _ in _units(n, ho, wo, plan, True):
            y, _ = tile_act(img, oy0, ox0)
            th, tw = extent(oy0, ox0)
            sums[img, ti] = y[:th, :tw].reshape(-1, e).sum(0)
        pooled = torch.stack([sum(sums[img, t] for t in range(tiles)) for img in range(n)])
        gate = _gate(pooled * (1.0 / (ho * wo)), dt, (se_w1, se_b1, se_w2, se_b2))
    out = torch.full((n, ho, wo, cout), float("nan"), dtype=dt)
    for img, _, oy0, ox0, c0 in _units(n, ho, wo, plan, False):
        y, win = tile_act(img, oy0, ox0)
        if gate is not None:
            y = y * gate[img]
        a = y.to(dt).float()
        cols = slice(c0, c0 + plan.cw)
        o = (a.reshape(-1, e) @ prj_w[:, cols].float() + prj_b[cols].float()).to(dt)
        o = o.reshape(plan.th, plan.tw, -1)
        if residual:  # the staged window holds the block's input at each output pixel
            o = (o + win[pad:pad + plan.th, pad:pad + plan.tw, cols]).to(dt)
        th, tw = extent(oy0, ox0)
        dst = out[img, oy0:oy0 + th, ox0:ox0 + tw, cols]
        assert torch.isnan(dst.float()).all(), "an output element written twice"
        dst.copy_(o[:th, :tw])
    assert not torch.isnan(out.float()).any(), "an output element never written"
    return out


def _make(seed, n, h, cin, e, cout, k, se_mid, identity=False, dtype=torch.float32):
    """Operands made with numpy from a seed, SE biases non-zero."""
    rng = np.random.default_rng(seed)

    def r(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    kw = {"x": r((n, h, h, cin), 0.7), "exp_w": r((cin, e), cin ** -0.5),
          "exp_b": r((e,), 0.2), "dw_w": r((k, k, 1, e), 0.25), "dw_b": r((e,), 0.2),
          "prj_w": r((e, cout), e ** -0.5), "prj_b": r((cout,), 0.2)}
    if identity:
        kw["exp_w"] = kw["exp_b"] = None
    if se_mid:
        kw.update(se_w1=r((e, se_mid), e ** -0.5), se_b1=r((se_mid,), 0.3),
                  se_w2=r((se_mid, e), se_mid ** -0.5), se_b2=r((e,), 0.3))
    return kw


# (n, h, cin, e, cout, k, stride, se, act, residual, identity, forced plan or None)
WALKS = [
    (2, 10, 16, 16, 16, 3, 1, 0, "relu", True, True, None),        # V3-L b00: identity
    (2, 12, 16, 16, 16, 3, 2, 8, "relu", False, True, None),       # V3-S b00: identity s2 SE
    (2, 12, 16, 64, 24, 3, 2, 0, "relu", False, False, None),      # V3-L b01: k3 s2
    (2, 12, 24, 72, 40, 5, 2, 24, "relu", False, False, None),     # b03: k5 s2, E tail 8
    (2, 9, 40, 120, 40, 5, 1, 32, "relu", True, False, None),      # b04: SE, residual, odd side
    (1, 7, 80, 200, 80, 3, 1, 0, "hswish", True, False, None),     # b07: E tail 8, two slices
    (2, 7, 48, 144, 48, 5, 1, 40, "hswish", True, False, None),    # V3-S b07
    (1, 8, 24, 88, 24, 3, 1, 0, "relu6", True, False, None),       # relu6, E tail 24
    # forced plans: ragged tiles at both edges, Cout split into parts
    (2, 9, 40, 120, 40, 5, 1, 32, "hswish", True, False, V3WPlan(2, 4, 5, 8, 2, 2)),
    (1, 10, 24, 72, 40, 5, 2, 24, "relu", False, False, V3WPlan(3, 2, 5, 8, 1, 2)),
    (2, 7, 160, 960, 160, 5, 1, 240, "hswish", True, False, V3WPlan(4, 3, 2, 80, 1, 2)),
    (1, 11, 16, 16, 16, 3, 1, 0, "relu", True, True, V3WPlan(4, 5, 2, 8, 2, 2)),
]


def _walk_plan(kw, n, h, k, stride, se, identity, forced):
    if forced is not None:
        return forced
    cin, e, cout = kw["x"].shape[-1], kw["dw_w"].shape[-1], kw["prj_w"].shape[-1]
    return v3_wgmma_plan(n, h, h, cin, e, cout, k, stride, se, identity)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity,forced", WALKS)
def test_unit_walk_is_the_block(n, h, cin, e, cout, k, stride, se, act, residual, identity,
                                forced):
    """In float32 (every rounding the identity) the unit walk equals
    `v3_block_plain` to the sums' reassociation: the windows, the padding of
    the expanded tensor, the E chunks and tails, the tile edges and the
    Cout parts cover the block exactly."""
    kw = _make(n * h + cin + e, n, h, cin, e, cout, k, se, identity)
    opts = dict(k=k, stride=stride, act=act, residual=residual)
    plan = _walk_plan(kw, n, h, k, stride, se, identity, forced)
    got = unit_walk(**kw, **opts, plan=plan)
    torch.testing.assert_close(got, v3_block_plain(**kw, **opts), **F32_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity,forced",
                         WALKS[:10] + WALKS[11:])
def test_unit_walk_vs_pallas_bf16(n, h, cin, e, cout, k, stride, se, act, residual, identity,
                                  forced):
    """In bf16 the unit walk against the JAX package's `v3_block_pallas`
    (interpret mode) at the port's kernel tolerance, and against the plain
    version the wrapper runs on CPU tensors."""
    kw = _make(n * h + cin + e + 1, n, h, cin, e, cout, k, se, identity, torch.bfloat16)
    opts = dict(k=k, stride=stride, act=act, residual=residual)
    plan = _walk_plan(kw, n, h, k, stride, se, identity, forced)
    got = unit_walk(**kw, **opts, plan=plan).float()
    jx = {a: None if v is None else jnp.asarray(v.float().numpy(), jnp.bfloat16)
          for a, v in kw.items()}
    want = v3_block_pallas(jx.pop("x"), jx.pop("exp_w"), jx.pop("exp_b"), jx.pop("dw_w"),
                           jx.pop("dw_b"), jx.pop("prj_w"), jx.pop("prj_b"), interpret=True,
                           **jx, **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **BF16_TOL)
    torch.testing.assert_close(got, v3_block(**kw, **opts).float(), **BF16_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,k,se_mid,act,residual", [
    (2, 8, 24, 88, 24, 3, 0, "relu", True),        # V3-S b02
    (2, 6, 40, 240, 40, 5, 64, "hswish", True),    # b04 and b05
    (1, 6, 48, 144, 48, 5, 40, "hswish", True),    # b07
])
def test_unit_walk_vs_se_block_packed(n, h, cin, e, cout, k, se_mid, act, residual):
    """In float32 the unit walk against the JAX package's lane-packed SE
    block (interpret mode), the kernel V3-Small's blocks 2 and 4-7 run on
    the TPU."""
    kw = _make(n * h + cin + e + 2, n, h, cin, e, cout, k, se_mid)
    cp, _, cout_p, _ = se_packed_geometry(cin, e, cout, h, k, 1)
    jx = {a: jnp.asarray(v.numpy()) for a, v in kw.items()}
    xin = jnp.pad(jx["x"], ((0, 0), (0, 0), (0, 0), (0, cp - cin)))
    ew = jnp.pad(jx["exp_w"], ((0, cp - cin), (0, 0)))
    se = (jx["se_w1"], jx["se_b1"], jx["se_w2"], jx["se_b2"]) if se_mid else (None,) * 4
    out = se_block_packed(pack(xin, cp), ew, jx["exp_b"], jx["dw_w"], jx["dw_b"], *se,
                          jx["prj_w"], jx["prj_b"], cp, k, act, residual, se_mid,
                          interpret=True)
    want = np.asarray(out.reshape(n, h, h, cout_p)[..., :cout], np.float32)
    plan = v3_wgmma_plan(n, h, h, cin, e, cout, k, 1, se_mid, False)
    got = unit_walk(**kw, k=k, stride=1, act=act, residual=residual, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 12, 24, 72, 40, 5, 2, 24, "relu", False, False),
    (2, 9, 40, 120, 40, 5, 1, 32, "hswish", True, False),
    (2, 12, 16, 16, 16, 3, 2, 8, "relu", False, True),
    (1, 8, 24, 88, 24, 3, 1, 0, "relu6", True, False),
])
def test_library_yardstick_is_the_block(n, h, cin, e, cout, k, stride, se, act, residual,
                                        identity):
    """`block_times.v3_library`, the unfused library sequence timed beside
    the kernel, computes the block (float32)."""
    kw = _make(n + h + e, n, h, cin, e, cout, k, se, identity)
    opts = dict(k=k, stride=stride, act=act, residual=residual)
    torch.testing.assert_close(v3_library(**kw, **opts)(), v3_block_plain(**kw, **opts),
                               **F32_TOL)


def test_smem_mirror_by_hand():
    """v3_wgmma_smem_bytes at V3-L b13's 7x7 tile: 1 KB alignment, 1 KB of
    barriers, the 16 KB A panel, Z of 128 rows x 144 bytes, weight stages of
    3 expand boxes + a 128-wide box pair + 4 eight-column boxes + 25 x 128
    bytes of depthwise weight + 512 bytes of biases and gate (48 KB), and
    windows of 3 chunks x 128 rows x 128 bytes + 1 KB; none of Z and the
    expand boxes for the identity."""
    stage = 3 * 8192 + 2 * 8192 + 4 * 1024 + 25 * 128 + 512
    stage = -(-stage // 1024) * 1024
    assert stage == 48 * 1024
    want = 2048 + 16384 + 128 * 144 + 2 * stage + 2 * (3 * 128 * 128 + 1024)
    assert v3_wgmma_smem_bytes(7, 7, 160, 960, 160, 5, 1, 160, 2, 2, False) == want
    ident = v3_wgmma_smem_bytes(8, 16, 16, 16, 16, 3, 1, 16, 2, 2, True)
    assert ident == 2048 + 16384 + 2 * 4096 + 2 * (192 * 128 + 1024)


def test_bf16_without_a_plan_raises():
    """A bf16 shape that no plan takes raises at the call (naming the plan),
    on the CPU as on the card: the wrapper never falls back to another
    tile. Float32 takes its own tile's plan."""
    kw = _make(3, 1, 4, 2048, 2048, 64, 3, 0, dtype=torch.bfloat16)
    assert v3_wgmma_plan(1, 4, 4, 2048, 2048, 64, 3, 1, 0, False) is None
    with pytest.raises(ValueError, match="v3_wgmma_plan"):
        v3_block(**kw, k=3, stride=1, act="relu")
    with pytest.raises(ValueError, match="v3_wgmma_plan"):
        v3_chain(kw["x"], [dict({a: v for a, v in kw.items() if a != "x"}, k=3, stride=1,
                                act="relu", residual=False)] * 2)
    odd = _make(4, 1, 7, 16, 64, 24, 3, 0, dtype=torch.bfloat16)
    assert v3_wgmma_plan(1, 7, 7, 16, 64, 24, 3, 2, 0, False) is None  # odd input at stride 2
    with pytest.raises(ValueError, match="v3_wgmma_plan"):
        v3_block(**odd, k=3, stride=2, act="relu")


def test_plan_prefers_waves_at_batch_1():
    """At batch 1 the late 7^2 and 14^2 blocks have one to four whole-image
    tiles; the plan spreads them over more units (smaller tiles or Cout
    parts) than at batch 256, so that more SMs hold work."""
    cfg = CONFIGS["large"]
    for i, h, bd in _blocks(cfg):
        if h > 14:
            continue
        units = {}
        for batch in (1, 256):
            p = v3_wgmma_plan(batch, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                              bd.se_mid, False)
            ho = -(-h // bd.stride)
            units[batch] = -(-ho // p.th) * -(-ho // p.tw) * p.split
        assert units[1] >= units[256], f"b{i:02d}"
        assert units[1] >= 4, f"b{i:02d}"
