"""The port's MobileNet-V3 bottleneck kernel (its plain version, which the
wrapper runs on CPU tensors) against the JAX package's `v3_block_pallas` in
interpret mode, at the shape classes of the JAX package's own kernel tests
(tests/test_pallas_ir_v3.py): k 3 and 5 at both strides, the squeeze-excite
gate with non-zero SE biases, relu / hswish / relu6, the identity expansion,
the residual and expanded widths that end in a partial 32-channel chunk;
and against `se_block_packed` (interpret mode), the lane-packed stride-1
bottleneck the JAX package runs V3-Small's blocks 2 and 4-7 on, which the
port's kernel takes too. Also the float32 tile's plan (`v3_plan`, the
kernel's fits-function, with mirrors of its unit walk, thread maps and
shared memory at every V2, V3 and minimalistic block) and its rings'
mbarrier handshakes, stepped role by role at every slot count the plan
takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack
from mobilenet_tpu.ops.pallas_ir_v3 import v3_block_pallas
from mobilenet_tpu.ops.pallas_se_packed import se_block_packed, se_packed_geometry
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import V2Config, V3Config
from mobilenet_tpu_torch.ops.v3_block import (
    F32_CONSUMERS, KE, MAX_NJ, MAX_TM, V3F_RINGS, V3F_SMEM_LIMIT, V3W_SMEM_LIMIT, v3_block,
    v3_block_plain, v3_plan, v3_smem_bytes, v3_wgmma_plan, v3_wgmma_smem_bytes, v3f_quads,
    v3f_split,
)

# float32: the JAX kernel tests' own tolerance (tests/test_pallas_ir_v3.py:83).
F32_TOL = dict(atol=3e-5, rtol=1e-5)
# bfloat16: the port's kernel tolerance (tests/test_torch_ir_block.py): a
# last-bit difference in an f32 sum moves a bf16 rounding by one step.
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _make(seed, n, h, cin, e, cout, k, se_mid, identity=False):
    """The JAX kernel tests' operands (`_make`), SE biases non-zero."""
    rng = np.random.default_rng(seed)

    def r(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrs = {"x": r((n, h, h, cin), 0.5), "exp_w": r((cin, e), cin ** -0.5),
            "exp_b": r((e,), 0.1), "dw_w": r((k, k, 1, e), 0.2), "dw_b": r((e,), 0.1),
            "prj_w": r((e, cout), e ** -0.5), "prj_b": r((cout,), 0.1)}
    if identity:
        arrs["exp_w"] = arrs["exp_b"] = None
    if se_mid:
        arrs.update(se_w1=r((e, se_mid), e ** -0.5), se_b1=r((se_mid,), 0.1),
                    se_w2=r((se_mid, e), se_mid ** -0.5), se_b2=r((e,), 0.1))
    return arrs


def _run(arrs, dtype, **kw):
    jdt, tdt = _DT[dtype]
    jx = {a: None if v is None else jnp.asarray(v, jdt) for a, v in arrs.items()}
    want = v3_block_pallas(jx.pop("x"), jx.pop("exp_w"), jx.pop("exp_b"), jx.pop("dw_w"),
                           jx.pop("dw_b"), jx.pop("prj_w"), jx.pop("prj_b"), interpret=True,
                           **jx, **kw)
    tx = {a: None if v is None else torch.from_numpy(v).to(tdt) for a, v in arrs.items()}
    got = v3_block(**tx, **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se_mid,act,residual", [
    (2, 14, 64, 384, 64, 3, 1, 0, "relu", True),
    (2, 28, 24, 72, 40, 5, 2, 24, "relu", False),        # V3-L b03 class; E 72: a tail chunk
    (2, 14, 40, 120, 40, 5, 1, 32, "relu", True),        # V3-L b04: SE + residual
    (2, 14, 112, 672, 160, 5, 2, 168, "hswish", False),  # V3-L b12
    (2, 8, 160, 960, 160, 5, 1, 240, "hswish", True),    # V3-L b13 class
    (2, 14, 80, 184, 80, 3, 1, 0, "hswish", True),       # V3-L b08
    (2, 9, 48, 144, 48, 5, 1, 40, "hswish", True),       # odd spatial at stride 1
    (2, 16, 16, 64, 24, 3, 2, 0, "relu", False),         # V3-L b01 class (k 3 s2)
    (1, 10, 24, 72, 24, 3, 1, 24, "relu6", True),        # relu6, SE at k 3
])
def test_vs_pallas(dtype, n, h, cin, e, cout, k, stride, se_mid, act, residual):
    arrs = _make(n * h + cin + e, n, h, cin, e, cout, k, se_mid)
    got, want = _run(arrs, dtype, k=k, stride=stride, act=act, residual=residual)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_expand_no_activation(dtype):
    """V3-Large block 0: no expansion conv. The identity must not activate
    (the stem's hswish output is negative in places)."""
    arrs = _make(11, 2, 16, 16, 16, 16, 3, 0, identity=True)
    arrs["x"] = (arrs["x"] * 2).astype(np.float32)
    assert (arrs["x"] < 0).any()
    got, want = _run(arrs, dtype, k=3, stride=1, act="relu", residual=True)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_se_biases_and_gate_reach_the_output():
    """Seeded weights carry zero SE biases; the block's b1 and b2 and the
    gate itself must each move the output."""
    arrs = _make(5, 2, 8, 24, 72, 40, 5, 24)
    t = {a: torch.from_numpy(v) for a, v in arrs.items()}
    kw = dict(k=5, stride=1, act="relu")
    with_b = v3_block_plain(**t, **kw)
    t0 = dict(t, se_b1=torch.zeros_like(t["se_b1"]), se_b2=torch.zeros_like(t["se_b2"]))
    assert not torch.allclose(with_b, v3_block_plain(**t0, **kw), atol=1e-3)
    no_se = {a: v for a, v in t.items() if not a.startswith("se_")}
    assert not torch.allclose(with_b, v3_block_plain(**no_se, **kw), atol=1e-3)


@pytest.mark.parametrize("variant,mini", [("large", False), ("large", True)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_v3_block_has_a_tile(variant, mini, itemsize):
    """Every V3-Large (and -minimalistic) block at 1.0-224 has a tile at
    batch 1 and 256 in each dtype's kernel (itemsize 2: the bf16 tile's
    `v3_wgmma_plan`; 4: the float32 tile's `v3_plan`) within its shared-
    memory limit; float32: within the output cap and the projection's
    MAX_NJ channel quads a thread, and the batch-1 tiles no larger than the
    batch-256 ones."""
    cfg = V3Config(variant, 1.0, 224, minimalistic=mini)
    h = 112
    for bd in cfg.block_defs:
        ident = not bd.has_expand
        if itemsize == 2:
            for n in (1, 256):
                p = v3_wgmma_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                  bd.se_mid, ident)
                assert v3_wgmma_smem_bytes(p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel,
                                           bd.stride, p.cw, p.ws, p.bs, ident) <= V3W_SMEM_LIMIT
        else:
            plans = [v3_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                             bd.se_mid, ident) for n in (1, 256)]
            for p in plans:
                assert v3_smem_bytes(p.th, p.tw, h, h, bd.cin, bd.cexp, bd.cout, bd.se_mid,
                                     bd.kernel, bd.stride, p.ws, p.bs, ident) <= V3F_SMEM_LIMIT
                assert p.th * p.tw <= MAX_TM
                assert v3f_quads(p.th * p.tw, bd.cout)[0] <= MAX_NJ
            assert plans[0].th * plans[0].tw <= plans[1].th * plans[1].tw
        h //= bd.stride


def test_smem_grows_with_k_and_se():
    """The float32 tile's shared memory: k 5 stages more taps; SE adds the
    gate (960 f32) and hidden row (240 f32) and widens each of the two
    weight stages to hold pass 2's pre-gate rows (52 x 36 f32 after the 40
    KB of expand and projection weights: 48512 bytes, not 42368)."""
    base = v3_smem_bytes(7, 7, 7, 7, 160, 960, 160, 0, 3, 1, 2, 2)
    assert v3_smem_bytes(7, 7, 7, 7, 160, 960, 160, 0, 5, 1, 2, 2) > base
    assert v3_smem_bytes(7, 7, 7, 7, 160, 960, 160, 240, 3, 1, 2, 2) == \
        base + 3840 + 1024 + 2 * (48512 - 42368)
    assert v3_plan(1, 6, 5, 16, 64, 16, 3, 2, 0) is None  # odd input at stride 2
    assert v3_plan(1, 8, 8, 16, 64, 16, 7, 1, 0) is None  # no k 7


# -- the float32 tile's plan and its mirrors ------------------------------------------------


def _blocks(model, alpha, res):
    """(h, cin, e, cout, k, stride, se, identity) of every expanded block the
    float32 tile runs: V2's blocks 1-16, every V3 (minimalistic) block."""
    out = []
    if model == "v2":
        h = res // 2
        for t, cin, cout, stride in V2Config(alpha, res).block_defs:
            if t > 1:
                out.append((h, cin, t * cin, cout, 3, stride, 0, False))
            h = -(-h // stride)
        return out
    variant, mini = {"v3l": ("large", False), "v3s": ("small", False),
                     "v3l-min": ("large", True), "v3s-min": ("small", True)}[model]
    h = res // 2
    for bd in V3Config(variant, alpha, res, minimalistic=mini).block_defs:
        out.append((h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid,
                    not bd.has_expand))
        h = -(-h // bd.stride)
    return out


def _tiles(p, h, w, k, stride):
    """v3_f32.cuh unit_of over one image's tiles: (oy0, ox0, iy0, ix0, ry0,
    rx0, rh, rw), the tile's output origin, window origin and staged region."""
    ho, wo = -(-h // stride), -(-w // stride)
    pad = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    ph, pw = (p.th - 1) * stride + k, (p.tw - 1) * stride + k
    for oy0 in range(0, ho, p.th):
        for ox0 in range(0, wo, p.tw):
            iy0, ix0 = oy0 * stride - pad, ox0 * stride - pad
            ry0, rx0 = max(0, -iy0), max(0, -ix0)
            yield (oy0, ox0, iy0, ix0, ry0, rx0, min(ph, h - iy0) - ry0, min(pw, w - ix0) - rx0)


def check_f32_plan(n, h, cin, e, cout, k, stride, se, identity):
    """One block's float32 plan against the kernel's rules: it exists, fits
    its shared memory, and its tiles cover every output once; every staged
    region holds the in-image taps of its tile's outputs inside the window
    buffer; the projection's thread map covers each (pixel quad, channel
    quad) once; the expansion's K split partitions Cin."""
    p = v3_plan(n, h, h, cin, e, cout, k, stride, se, identity)
    assert p is not None, (n, h, cin, e, cout, k, stride, se)
    assert (p.ws, p.bs) in V3F_RINGS and p.th * p.tw <= MAX_TM
    assert v3_smem_bytes(p.th, p.tw, h, h, cin, e, cout, se, k, stride, p.ws, p.bs,
                         identity) <= V3F_SMEM_LIMIT
    ho = -(-h // stride)
    pad = (k - 1) // 2 if stride == 1 else (k - 2) // 2
    ph, pw = (p.th - 1) * stride + k, (p.tw - 1) * stride + k
    wpix = ph * pw if identity else min(ph, h) * min(pw, h)
    cover = np.zeros((ho, ho), np.int32)
    for oy0, ox0, iy0, ix0, ry0, rx0, rh, rw in _tiles(p, h, h, k, stride):
        cover[oy0:oy0 + p.th, ox0:ox0 + p.tw] += 1
        assert rh >= 1 and rw >= 1 and rh * rw <= wpix
        oy1, ox1 = min(ho, oy0 + p.th), min(ho, ox0 + p.tw)
        ty = np.arange(oy0 * stride - pad, (oy1 - 1) * stride - pad + k)
        tx = np.arange(ox0 * stride - pad, (ox1 - 1) * stride - pad + k)
        ty, tx = ty[(ty >= 0) & (ty < h)] - iy0, tx[(tx >= 0) & (tx < h)] - ix0
        assert ty.min() >= ry0 and ty.max() < ry0 + rh and tx.min() >= rx0
        assert tx.max() < rx0 + rw
    assert (cover == 1).all()
    nj, cqt = v3f_quads(p.th * p.tw, cout)
    pq, cq = -(-p.th * p.tw // 4), cout // 4
    assert nj <= MAX_NJ and pq * cqt <= F32_CONSUMERS
    quads = np.zeros((pq, cq), np.int32)
    for t in range(pq * cqt):
        for j in range(nj):
            if t % cqt + j * cqt < cq:
                quads[t // cqt, t % cqt + j * cqt] += 1
    assert (quads == 1).all()
    kc, items = v3f_split(wpix, cin, identity)
    assert kc in (1, 2, 4) and (kc == 1 or items <= F32_CONSUMERS // kc)
    steps = cin // 4
    bounds = [4 * (g * steps // kc) for g in range(kc + 1)]
    assert bounds[0] == 0 and bounds[-1] == cin and all(a < b for a, b in zip(bounds, bounds[1:]))
    return p


@pytest.mark.parametrize("model", ["v2", "v3l", "v3s", "v3l-min", "v3s-min"])
@pytest.mark.parametrize("alpha", [0.35, 1.0, 1.4])
def test_f32_plan_covers_every_block(model, alpha):
    """`check_f32_plan` at every block of the model at 96 and 224 pixels,
    batch 1, 2 and 256."""
    for res in (96, 224):
        for n in (1, 2, 256):
            for blk in _blocks(model, alpha, res):
                check_f32_plan(n, *blk)


@pytest.mark.parametrize("case", [
    (2, 13, 24, 72, 24, 3, 1, 0, False),    # odd sides at stride 1, Cin 24
    (2, 14, 40, 120, 48, 5, 2, 32, False),  # k 5 at stride 2 with SE, Cin 40
    (1, 9, 16, 40, 16, 5, 1, 8, False),     # E not a multiple of the 32-channel chunk
    (2, 11, 24, 24, 24, 3, 1, 0, True),     # the identity expansion, the residual's shape
    (1, 300, 16, 96, 24, 3, 2, 0, False),   # a wide image: many tiles a row
])
def test_f32_plan_edge_shapes(case):
    check_f32_plan(*case)


# -- the float32 tile's rings, stepped role by role -------------------------------------------


class Bar:
    """An mbarrier: `count` arrivals complete a phase; wait(parity) passes
    once the phase of that parity has completed (the current phase's parity
    differs)."""

    def __init__(self, count):
        self.count, self.left, self.done = count, count, 0

    def arrive(self):
        self.left -= 1
        if self.left == 0:
            self.left, self.done = self.count, self.done + 1

    def passed(self, parity):
        return self.done % 2 != parity


class Ring:
    """v3_f32.cuh Ring: the next slot and its parity, a parity bit a slot."""

    def __init__(self):
        self.cur = self.par = 0

    def next(self, slots):
        s = self.cur
        self.cur = 0 if s + 1 == slots else s + 1
        parity = (self.par >> s) & 1
        self.par ^= 1 << s
        return s, parity


def ring_walk(passes, lanes=4, consumers=3):
    """Steps the producer warp's lanes and the consumer threads (a few of
    each: the barriers count them) through v3_f32.cuh's rings over a
    sequence of passes, each (units, chunks, ws, bs, window): the window
    ring a unit when `window`, the weight ring a chunk. Every fill is
    tagged and every read checks its tag; returns False at a deadlock."""
    bars = {r: [(Bar(lanes), Bar(consumers)) for _ in range(4)] for r in ("w", "b")}
    slot_tag = {r: [None] * 4 for r in ("w", "b")}

    def producer(lane):
        wr, br = Ring(), Ring()
        for pi, (units, chunks, ws, bs, window) in enumerate(passes):
            wr.cur = br.cur = 0
            for u in range(units):
                seq = [("w", ws, (pi, u))] if window else []
                seq += [("b", bs, (pi, u, c)) for c in range(chunks)]
                for ring, slots, tag in seq:
                    s, parity = (wr if ring == "w" else br).next(slots)
                    full, empty = bars[ring][s]
                    while not empty.passed(parity ^ 1):
                        yield False
                    slot_tag[ring][s] = tag
                    full.arrive()
                    yield True

    def consumer():
        wr, br = Ring(), Ring()
        for pi, (units, chunks, ws, bs, window) in enumerate(passes):
            wr.cur = br.cur = 0
            for u in range(units):
                if window:
                    s_w, parity = wr.next(ws)
                    while not bars["w"][s_w][0].passed(parity):
                        yield False
                    assert slot_tag["w"][s_w] == (pi, u)
                for c in range(chunks):
                    s, parity = br.next(bs)
                    while not bars["b"][s][0].passed(parity):
                        yield False
                    assert slot_tag["b"][s] == (pi, u, c)
                    bars["b"][s][1].arrive()
                    yield True
                if window:
                    bars["w"][s_w][1].arrive()
                yield True

    live = [producer(i) for i in range(lanes)] + [consumer() for _ in range(consumers)]
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


@pytest.mark.parametrize("ws,bs", V3F_RINGS)
def test_f32_rings_progress(ws, bs):
    """Every (window, weight) slot count the plan takes: a block without SE
    (one pass), an SE block (pass 1 on both rings, pass 2 on the weight
    ring alone), and units and chunks below, at and past the slot counts."""
    for units in (1, ws + 1, 3):
        for chunks in (1, bs, 2 * bs + 1):
            assert ring_walk([(units, chunks, ws, bs, True)])
            assert ring_walk([(units, chunks, ws, bs, True), (units, chunks, ws, bs, False)])


def test_f32_plan_slot_counts():
    """The ring slots the plan takes at V2's, V3-L's and V3-S's 1.0-224
    blocks are among V3F_RINGS (each stepped above), and include two
    windows for most blocks."""
    seen = [check_f32_plan(n, *blk)[2:] for model in ("v2", "v3l", "v3s")
            for blk in _blocks(model, 1.0, 224) for n in (1, 256)]
    assert set(seen) <= set(V3F_RINGS)
    assert sum(ws == 2 for ws, _ in seen) > len(seen) // 2


def test_wrapper_rejects_what_no_kernel_takes():
    arrs = _make(1, 1, 8, 16, 64, 16, 3, 16)
    t = {a: torch.from_numpy(v) for a, v in arrs.items()}
    with pytest.raises(ValueError):
        v3_block(**t, k=3, stride=2, act="relu", residual=True)  # residual at stride 2
    with pytest.raises(ValueError):
        v3_block(**dict(t, se_b2=None), k=3, stride=1, act="relu")  # SE half given
    with pytest.raises(ValueError):
        v3_block(**t, k=5, stride=1, act="relu")  # 3x3 weights at k 5
    with pytest.raises(ValueError):
        v3_block(**t, k=3, stride=1, act="hsigmoid")
    with pytest.raises(ValueError):
        v3_block(**dict(t, x=t["x"][:, :7].contiguous()), k=3, stride=2, act="relu")  # odd, s2


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.mark.parametrize("n,h,cin,e,cout,k,se_mid,act,residual", [
    (2, 8, 24, 88, 24, 3, 0, "relu", True),        # V3-S b02 (28² x 24 in the network)
    (2, 6, 40, 240, 40, 5, 64, "hswish", True),    # b04 and b05 (14² x 40)
    (2, 6, 40, 120, 48, 5, 32, "hswish", False),   # b06
    (1, 6, 48, 144, 48, 5, 40, "hswish", True),    # b07
])
def test_vs_se_block_packed(n, h, cin, e, cout, k, se_mid, act, residual):
    """The port's V3 kernel against the JAX package's lane-packed SE block
    at V3-Small's B15 shapes (stride 1, small spatial), on the same inputs
    with non-zero SE biases: float32 within 1e-4; bf16 at the anchored
    routing gate (golden.routing_bf16_atol, and the port no farther in RMS
    from the float32 block than 1.5x the JAX kernel + 6e-2): the two round
    at different places (the JAX kernel keeps the expansion in float32 and
    adds the residual before its one rounding)."""
    arrs = _make(n * h + cin + e, n, h, cin, e, cout, k, se_mid)
    cp, _, cout_p, _ = se_packed_geometry(cin, e, cout, h, k, 1)
    ref32 = v3_block_plain(**{a: torch.from_numpy(v) for a, v in arrs.items()}, k=k, stride=1,
                           act=act, residual=residual).numpy()
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = _DT[dtype]
        jx = {a: jnp.asarray(v, jdt) for a, v in arrs.items()}
        xin = jnp.pad(jx["x"], ((0, 0), (0, 0), (0, 0), (0, cp - cin)))
        ew = jnp.pad(jx["exp_w"], ((0, cp - cin), (0, 0)))
        se = ((jx["se_w1"], jx["se_b1"], jx["se_w2"], jx["se_b2"]) if se_mid
              else (None,) * 4)
        out = se_block_packed(pack(xin, cp), ew, jx["exp_b"], jx["dw_w"], jx["dw_b"], *se,
                              jx["prj_w"], jx["prj_b"], cp, k, act, residual, se_mid,
                              interpret=True)
        want = np.asarray(out.reshape(n, h, h, cout_p)[..., :cout], np.float32)
        got = v3_block(**{a: torch.from_numpy(v).to(tdt) for a, v in arrs.items()}, k=k,
                       stride=1, act=act, residual=residual).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
            continue
        atol = golden.routing_bf16_atol(float(np.abs(want).max()), _rms(got - want), got.size)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        assert _rms(got - ref32) <= golden.ROUTING_ANCHOR_FACTOR * _rms(want - ref32) + \
            golden.ROUTING_BF16_ATOL
