"""The port's V3 chain kernel's plain version (which the wrapper runs on CPU
tensors) against the JAX package's `v3_chain_pallas` in interpret mode at
the shape classes of the JAX package's own chain tests
(tests/test_pallas_chain_v3.py CASES: a stride-2 entry, SE, k 5, hswish and
residuals inside one run, an odd final side); the wrapper's rejections; the
chain knobs' segmentation at 1.0-224 from shapes alone; and the chained
forward_v3 against the port's per-block route and the JAX package's chained
forward; and the float32 chain's rings stepped role by role across its
stages' passes, on the plans each stage has alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.checkpoints.v3 import fold_bn_v3 as jax_fold_bn_v3
from mobilenet_tpu.checkpoints.v3 import init_params_v3 as jax_init_params_v3
from mobilenet_tpu.models import mobilenet_v3 as jax_v3
from mobilenet_tpu.ops import pallas_chain_v3 as jax_chain
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import V3Config
from mobilenet_tpu_torch.checkpoints import from_jax_params_v3
from mobilenet_tpu_torch.models import mobilenet_v3
from mobilenet_tpu_torch.ops import v3_chain as v3_chain_mod
from mobilenet_tpu_torch.ops.v3_block import v3_plan
from mobilenet_tpu_torch.ops.v3_chain import v3_chain, v3_chain_fits, v3_chain_plain
from test_torch_v3_block import ring_walk

# float32: the port's V3 kernel tests' tolerance (tests/test_torch_v3_block.py).
F32_TOL = dict(atol=3e-5, rtol=1e-5)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TENSORS = ("exp_w", "exp_b", "dw_w", "dw_b", "prj_w", "prj_b", "se_w1", "se_b1", "se_w2",
           "se_b2")

# (name, h, cin, blocks: (cin, e, cout, k, stride, act, se, residual)), the
# JAX package's chain test cases
CASES = [
    ("s2_entry_then_res", 8, 8, [
        (8, 24, 16, 3, 2, "hswish", 0, False),
        (16, 40, 16, 3, 1, "hswish", 0, True),
    ]),
    ("se_k5_mix", 8, 8, [
        (8, 24, 16, 3, 1, "relu", 0, False),
        (16, 32, 16, 5, 1, "relu", 8, True),
        (16, 40, 24, 3, 1, "hswish", 16, False),
    ]),
    ("v3_14sq_analog", 8, 10, [
        (10, 30, 12, 3, 2, "hswish", 0, False),
        (12, 28, 12, 3, 1, "hswish", 0, True),
        (12, 36, 20, 3, 1, "hswish", 12, False),
        (20, 48, 20, 3, 1, "hswish", 16, True),
    ]),
    ("odd_final_wpad", 10, 8, [
        (8, 24, 16, 5, 2, "hswish", 8, False),
        (16, 32, 16, 5, 1, "hswish", 8, True),
    ]),
]


def _blocks(rng, shapes):
    """numpy block dicts: the JAX chain tests' uniform(-1, 1) x 0.5 operands."""
    out = []
    for cin, e, cout, k, stride, act, se, residual in shapes:
        def arr(*shape):
            return (rng.uniform(-1, 1, shape) * 0.5).astype(np.float32)

        b = dict(exp_w=arr(cin, e), exp_b=arr(e), dw_w=arr(k, k, 1, e), dw_b=arr(e),
                 prj_w=arr(e, cout), prj_b=arr(cout), k=k, stride=stride, act=act,
                 residual=residual)
        if se:
            b.update(se_w1=arr(e, se), se_b1=arr(se), se_w2=arr(se, e), se_b2=arr(e))
        out.append(b)
    return out


def _convert(blocks, fn):
    return [{key: fn(v) if key in TENSORS else v for key, v in b.items()} for b in blocks]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.mark.parametrize("name,h,cin,shapes", CASES, ids=[c[0] for c in CASES])
def test_vs_v3_chain_pallas(name, h, cin, shapes):
    """float32 within F32_TOL of the JAX chain; bf16 at the anchored routing
    gate (golden.routing_bf16_atol, and no farther in RMS from the port's
    float32 chain than 1.5x the JAX chain + 6e-2): the two round the
    expansion and the SE pool at different places."""
    rng = np.random.default_rng(sum(map(ord, name)))
    blocks = _blocks(rng, shapes)
    x = rng.uniform(-1, 1, (4, h, h, cin)).astype(np.float32)
    ref32 = v3_chain_plain(torch.from_numpy(x), _convert(blocks, torch.from_numpy)).numpy()
    kernel_widths = all(c % 8 == 0 for s in shapes for c in s[:3])
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = _DT[dtype]
        want = np.asarray(jax_chain.v3_chain_pallas(
            jnp.asarray(x, jdt), _convert(blocks, lambda a: jnp.asarray(a, jdt)),
            interpret=True), np.float32)
        tx = torch.from_numpy(x).to(tdt)
        tblocks = _convert(blocks, lambda a: torch.from_numpy(a).to(tdt))
        got = v3_chain_plain(tx, tblocks)
        if kernel_widths:  # the wrapper takes it, and on CPU tensors runs the plain version
            torch.testing.assert_close(v3_chain(tx, tblocks), got, atol=0, rtol=0)
        got = got.float().numpy()
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32_TOL)
            continue
        atol = golden.routing_bf16_atol(float(np.abs(want).max()), _rms(got - want), got.size)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        assert _rms(got - ref32) <= golden.ROUTING_ANCHOR_FACTOR * _rms(want - ref32) + \
            golden.ROUTING_BF16_ATOL


def test_wrapper_rejects_what_no_chain_takes():
    rng = np.random.default_rng(3)
    blocks = _convert(_blocks(rng, CASES[1][3]), torch.from_numpy)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32))
    torch.testing.assert_close(v3_chain(x, blocks), v3_chain_plain(x, blocks), atol=0, rtol=0)
    with pytest.raises(ValueError, match="2 to 15 blocks"):
        v3_chain(x, blocks[:1])  # a single block
    with pytest.raises(ValueError, match="residual"):
        v3_chain(x, [dict(blocks[0], stride=2, residual=True)] + blocks[1:])  # s2 residual
    odd = x[:, :7, :7].contiguous()
    s2 = _convert(_blocks(rng, CASES[3][3]), torch.from_numpy)
    with pytest.raises(ValueError, match="v3_plan"):
        v3_chain(odd, s2)  # stride 2 on an odd side: no tile plan
    fits = [(cin, e, cout, k, stride, se) for cin, e, cout, k, stride, _, se, _ in CASES[3][3]]
    assert not v3_chain_fits(2, 7, 7, fits, 4)
    assert v3_chain_fits(2, 8, 8, fits, 4)
    assert not v3_chain_fits(2, 8, 8, fits[:1], 4)
    with pytest.raises(ValueError, match="Cin=24"):  # block 3 does not take block 2's output
        v3_chain(x, blocks + blocks[1:2])


def test_wrapper_keeps_checks_per_key(monkeypatch):
    """The wrapper makes its checks and tables once per key (the weights'
    addresses, every shape, stride and dtype, the options) and keeps at most
    PLANS_KEPT: a repeated call, or one on a new input of the same shape,
    adds no entry; a changed option, a replaced weight or another input
    shape is a new key and is checked again."""
    monkeypatch.setattr(v3_chain_mod, "_PLANS", {})
    monkeypatch.setattr(v3_chain_mod, "PLANS_KEPT", 3)
    plans = v3_chain_mod._PLANS
    rng = np.random.default_rng(4)
    blocks = _convert(_blocks(rng, CASES[1][3]), torch.from_numpy)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32))
    want = v3_chain_plain(x, blocks)
    for xi in (x, x, x.clone()):
        torch.testing.assert_close(v3_chain(xi, blocks), want, atol=0, rtol=0)
    assert len(plans) == 1
    with pytest.raises(ValueError, match="residual"):
        v3_chain(x, [dict(blocks[0], stride=2, residual=True)] + blocks[1:])
    with pytest.raises(ValueError, match="weight shapes"):
        v3_chain(x, blocks[:-1] + [dict(blocks[-1], prj_b=blocks[-1]["prj_b"][:-1].clone())])
    assert len(plans) == 1
    v3_chain(x[:1], blocks)
    v3_chain(x, blocks[:2])
    assert len(plans) == 3
    v3_chain(x[1:], blocks[:2])
    assert len(plans) == 1  # past PLANS_KEPT it starts over


@pytest.mark.parametrize("variant,stop", [("large", 15), ("small", 11)])
def test_greedy_segmentation_at_224(monkeypatch, variant, stop):
    """With the knob on, the greedy run is blocks 1 to the last (block 0 has
    no expansion) at batch 256 and 1 and both itemsizes; explicit ranges
    chain exactly those runs; off, nothing chains. Shapes alone."""
    cfg = V3Config(variant, 1.0, 224)
    routing = mobilenet_v3._routing_v3(cfg, "auto", 256)
    knob = "CHAIN_V3_SMALL" if variant == "small" else "CHAIN_V3"
    assert mobilenet_v3.chain_runs(cfg, routing, 256, 112, 112, 2) == {}
    monkeypatch.setattr(mobilenet_v3, knob, True)
    for batch in (256, 1):
        for item in (2, 4):
            assert mobilenet_v3.chain_runs(cfg, routing, batch, 112, 112, item) == {1: stop}
    assert mobilenet_v3.chain_runs(cfg, ("plain",) * 3 + ("fused",) * (stop - 3),
                                   256, 112, 112, 2) == {3: stop}
    monkeypatch.setattr(mobilenet_v3, knob, ((2, 6), (8, 9), (9, stop)))
    assert mobilenet_v3.chain_runs(cfg, routing, 256, 112, 112, 2) == {2: 6, 9: stop}
    for value in (True, False, ((2, 6), (8, 9), (9, stop))):
        monkeypatch.setattr(jax_v3, knob, value)
        assert [mobilenet_v3._chain_stop(i, value) for i in range(stop)] == [
            jax_v3._chain_ranges(i, variant) for i in range(stop)]


def test_knobs_default_off():
    assert mobilenet_v3.CHAIN_V3 is False and mobilenet_v3.CHAIN_V3_SMALL is False


def test_chained_forward_vs_per_block_and_jax(monkeypatch):
    """V3-Large 1.0-96, batch 2, float32, CHAIN_V3 on: one chain over blocks
    1-14, logits equal to the per-block route's bit for bit, and within 1e-4
    of the JAX package's forward_v3 with its CHAIN_V3 forced on, whose chain
    a spy sees taken (the tolerance of tests/test_pallas_chain_v3.py); no
    chain under collect=True."""
    cfg = V3Config("large", 1.0, 96)
    jcfg = jax_v3.V3Config(variant="large", alpha=1.0, resolution=96, compute_dtype="float32")
    tree = jax_fold_bn_v3(jax_init_params_v3(jcfg, seed=0), eps=jcfg.bn_eps)
    params = from_jax_params_v3(tree, "cpu", torch.float32, cfg)
    x = np.random.default_rng(23).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    base = mobilenet_v3.forward_v3(params, torch.from_numpy(x), cfg, dw_backend="fused")

    runs, real = [], mobilenet_v3.v3_chain
    monkeypatch.setattr(mobilenet_v3, "v3_chain",
                        lambda y, blocks: runs.append(len(blocks)) or real(y, blocks))
    monkeypatch.setattr(mobilenet_v3, "CHAIN_V3", True)
    got = mobilenet_v3.forward_v3(params, torch.from_numpy(x), cfg, dw_backend="fused")
    assert runs == [14]
    torch.testing.assert_close(got, base, atol=0, rtol=0)
    mobilenet_v3.forward_v3(params, torch.from_numpy(x), cfg, collect=True)
    assert runs == [14]

    jruns, jreal = [], jax_chain.v3_chain_pallas
    monkeypatch.setattr(jax_chain, "v3_chain_pallas",
                        lambda y, blocks, **kw: jruns.append(len(blocks)) or jreal(y, blocks,
                                                                                    **kw))
    monkeypatch.setattr(jax_v3, "CHAIN_V3", True)
    ref = np.asarray(jax_v3.forward_v3(tree, jnp.asarray(x), jcfg, dw_backend="fused"))
    assert jruns and max(jruns) >= 2
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", ["large", "small"])
@pytest.mark.parametrize("n", [1, 256])
def test_f32_chain_rings_progress(variant, n):
    """The float32 chain (blocks 1 to the last at 1.0-224) runs every
    stage's passes on one pair of rings whose slot counts change from stage
    to stage (each stage's own `v3_plan`): a stage without SE one pass on
    both rings, an SE stage pass 1 on both and pass 2 on the weight ring
    alone. Stepped role by role (a few units and chunks a pass), every fill
    reaches the read meant for it and no role waits forever."""
    cfg = V3Config(variant, 1.0, 224)
    h = 112 // cfg.block_defs[0].stride
    passes, slots = [], set()
    for bd in cfg.block_defs[1:]:
        p = v3_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid)
        slots.add((p.ws, p.bs))
        units = min(3, n * -(-(-(-h // bd.stride)) // p.th) * -(-(-(-h // bd.stride)) // p.tw))
        chunks = min(-(-bd.cexp // 32), 2 * p.bs + 1)
        passes.append((units, chunks, p.ws, p.bs, True))
        if bd.se_mid:
            passes.append((units, chunks, p.ws, p.bs, False))
        h = -(-h // bd.stride)
    assert ring_walk(passes)
    assert len(slots) > 1 or n == 1  # the slot counts do change between stages
