"""The port's MobileNet-V3 against the JAX package: the config table of Large,
Small and minimalistic, the seeded weights bit for bit, the tree conversion,
every per-layer tap of the plain route against the JAX package's "xla" route
and the NumPy oracle, the V3-Small golden fixture, the fused route (the
kernel's plain version per block) against the JAX fused route, the bf16
fused route against the bf16 plain route, the routing, and the pipeline,
the float gate and the server on the CPU."""

import asyncio
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.checkpoints.v3 import fold_bn_v3 as jax_fold_bn_v3
from mobilenet_tpu.checkpoints.v3 import init_params_v3 as jax_init_params_v3
from mobilenet_tpu.models import mobilenet_v3 as jax_v3
from mobilenet_tpu.oracle import numpy_ref as jax_numpy_ref
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import InferencePipeline, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import (
    fold_bn_v3, from_jax_params_v2, from_jax_params_v3, init_params_v3, load_npz, save_npz,
)
from mobilenet_tpu_torch.models import mobilenet_v3
from mobilenet_tpu_torch.oracle import numpy_ref
from mobilenet_tpu_torch.runtime import eval as teval
from mobilenet_tpu_torch.runtime.serving import build_server, config_from_variant, selftest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mnv3s_1.0_96_seed0.npz")
VARIANTS = {"large": ("large", False), "large_min": ("large", True), "small": ("small", False)}
RES = 64


def _cfgs(name, res=RES, alpha=1.0):
    variant, mini = VARIANTS[name]
    return (V3Config(variant, alpha, res, minimalistic=mini),
            jax_v3.V3Config(variant, alpha, res, minimalistic=mini))


def _tree(seed, jcfg):
    return jax_fold_bn_v3(jax_init_params_v3(jcfg, seed), eps=jcfg.bn_eps)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, np.asarray(tree)


def _x(seed, n, res=RES):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_config_matches_jax(name):
    for alpha in (0.75, 1.0, 1.25):
        for res in (96, 224):
            ours, ref = _cfgs(name, res, alpha)
            assert [dataclasses.astuple(b) for b in ours.block_defs] == [
                dataclasses.astuple(b) for b in ref.block_defs]
            assert [b.has_res for b in ours.block_defs] == [b.has_res for b in ref.block_defs]
            for attr in ("stem_channels", "last_conv_channels", "last_point_channels",
                         "head_act", "final_spatial"):
                assert getattr(ours, attr) == getattr(ref, attr), attr
            assert ours.variant_name() == ref.variant_name()
    for bad in (dict(variant="medium"), dict(resolution=100), dict(alpha=0.0),
                dict(compute_dtype="float16")):
        with pytest.raises(ValueError):
            V3Config(**bad)


@pytest.mark.parametrize("name,seed", [("large", 0), ("large_min", 3), ("small", 1)])
def test_seeded_weights_bit_identical(name, seed):
    cfg, jcfg = _cfgs(name, 224)
    raw = list(_leaves(init_params_v3(cfg, seed)))
    assert [(k, a.dtype, a.tobytes()) for k, a in raw] == [
        (k, a.dtype, a.tobytes()) for k, a in _leaves(jax_init_params_v3(jcfg, seed))]
    ours = list(_leaves(fold_bn_v3(init_params_v3(cfg, seed), eps=cfg.bn_eps)))
    ref = list(_leaves(_tree(seed, jcfg)))
    assert [k for k, _ in ours] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_from_jax_params_v3_roundtrip_and_checks(tmp_path):
    cfg, jcfg = _cfgs("large")
    tree = _tree(1, jcfg)
    path = str(tmp_path / "v3.npz")
    save_npz(path, tree)
    back = load_npz(path)
    params = from_jax_params_v3(back, "cpu", torch.float32, cfg)
    assert [(k, a.tobytes()) for k, a in _leaves(params)] == [
        (k, a.tobytes()) for k, a in _leaves(tree)]
    assert "exp" not in params["blocks"][0] and "se" in params["blocks"][3]
    with pytest.raises(ValueError):  # another config: the minimalistic table
        from_jax_params_v3(back, "cpu", torch.float32, _cfgs("large_min")[0])
    with pytest.raises(ValueError):  # a V3 tree is not a V2 tree, and back
        from_jax_params_v2(back, "cpu", torch.float32, V2Config(1.0, 96))
    with pytest.raises(ValueError):
        from_jax_params_v3({k: v for k, v in back.items() if k != "head"}, "cpu",
                           torch.float32, cfg)


@pytest.mark.parametrize("name", ["large", "large_min"])
def test_plain_route_taps_vs_jax_and_oracle(name):
    """Every float32 tap of the plain route against the JAX package's "xla"
    route (forward_v3(collect=True)) and against the port's NumPy oracle,
    at golden.V3_TOL."""
    cfg, jcfg = _cfgs(name)
    tree = _tree(0, jcfg)
    x = _x(1, 2)
    params = from_jax_params_v3(tree, "cpu", torch.float32, cfg)
    _, acts = mobilenet_v3.forward_v3(params, torch.from_numpy(x), cfg, collect=True)
    acts = {k: v.numpy() for k, v in acts.items()}
    _, ref = jax_v3.forward_v3(tree, jnp.asarray(x), jcfg, dw_backend="xla", collect=True)
    _, ora = numpy_ref.forward_all_v3(tree, x, cfg)
    assert list(acts) == list(ref) == list(ora)
    assert any(k.endswith("_se") for k in ora) != cfg.minimalistic
    for want in ({k: np.asarray(v) for k, v in ref.items()}, ora):
        golden.assert_all_match(golden.compare_activations(
            acts, want, tols={k: golden.V3_TOL for k in want}))


def test_oracle_is_the_jax_oracle():
    """The port's copy of forward_all_v3 gives the JAX package's taps bit
    for bit."""
    cfg, jcfg = _cfgs("large")
    tree, x = _tree(2, jcfg), _x(2, 1)
    _, ours = numpy_ref.forward_all_v3(tree, x, cfg)
    _, ref = jax_numpy_ref.forward_all_v3(tree, x, jcfg)
    assert list(ours) == list(ref)
    for k in ref:
        assert np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("collect", [False, True])
def test_golden_fixture_small(collect):
    """V3-Small's committed fixture (seed 0, 1.0-96) on its plain route, at
    golden.V3_TOL, with and without the taps; the SE tap's sum within the
    same gate."""
    data = np.load(GOLDEN)
    cfg, jcfg = _cfgs("small", 96)
    params = from_jax_params_v3(_tree(0, jcfg), "cpu", torch.float32, cfg)
    out = mobilenet_v3.forward_v3(params, torch.from_numpy(data["x"]), cfg,
                                  dw_backend="plain", collect=collect)
    logits = out[0] if collect else out
    atol, rtol = golden.V3_TOL
    np.testing.assert_allclose(logits.numpy(), data["logits"], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), data["logits"].argmax(-1))
    if collect:
        se = out[1]["block04_se"].double()
        assert abs(float(se.sum()) - float(data["block04_se_sum"])) <= atol * se.numel()


@pytest.mark.parametrize("name", ["large", "large_min"])
def test_fused_route_vs_jax_fused(name):
    """float32 logits of the port's fused route (one v3_block per block, its
    plain version on CPU tensors, and the fused head) against the JAX
    package's fused route with its Pallas kernels in interpret mode, batch 2
    at 96, at the JAX package's own gate (tests/test_pallas_ir_v3.py
    test_model_fused_matches_xla)."""
    cfg, jcfg = _cfgs(name, 96)
    tree = _tree(0, jcfg)
    x = _x(7, 2, 96)
    params = from_jax_params_v3(tree, "cpu", torch.float32, cfg)
    got = mobilenet_v3.forward_v3(params, torch.from_numpy(x), cfg, dw_backend="fused")
    ref = jax_v3.forward_v3(tree, jnp.asarray(x), jcfg, dw_backend="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_bf16_fused_route_vs_plain_route():
    """bf16 logits of the fused route against the bf16 plain route at the
    JAX package's V2/V3 routing gate (golden.routing_bf16_atol with its
    extreme-value term; a top-1 flip only between near-tied classes), and
    no farther in RMS from the float32 oracle than 1.5x the plain route's
    distance + 6e-2 (cli._verify_routing's anchor); SE biases made
    non-zero, as the seeded set has none."""
    cfg, jcfg = _cfgs("large", 96)
    tree = _tree(4, jcfg)
    rng = np.random.default_rng(8)
    for blk in tree["blocks"]:
        for b in ("b1", "b2"):
            if "se" in blk:
                blk["se"][b] = (rng.standard_normal(blk["se"][b].shape) * 0.2).astype(np.float32)
    x = _x(9, 4, 96)
    params = from_jax_params_v3(tree, "cpu", torch.bfloat16, cfg)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mobilenet_v3.forward_v3(params, xb, cfg, dw_backend="auto").float().numpy()
    ref = mobilenet_v3.forward_v3(params, xb, cfg, dw_backend="plain").float().numpy()
    ora = np.asarray(numpy_ref.forward_all_v3(tree, x, cfg)[0], np.float32)
    atol = golden.routing_bf16_atol(float(np.abs(ref).max()), _rms(got - ref), got.size)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    srt = np.sort(ref, -1)
    flips = got.argmax(-1) != ref.argmax(-1)
    assert not (flips & (srt[:, -1] - srt[:, -2] >= atol)).any()
    assert _rms(got - ora) <= golden.ROUTING_ANCHOR_FACTOR * _rms(ref - ora) + \
        golden.ROUTING_BF16_ATOL


def test_fused_route_runs_one_kernel_per_block(monkeypatch):
    """The fused route sends every block to v3_block (block 0 with the
    identity expansion, SE and residual as the table says) and the head to
    fused_head with conv_last, head and fc; "mixed" runs plain ops for the
    first two blocks."""
    cfg, jcfg = _cfgs("large")
    params = from_jax_params_v3(_tree(4, jcfg), "cpu", torch.float32, cfg)
    calls = []
    real_block, real_head = mobilenet_v3.v3_block, mobilenet_v3.fused_head

    def block(x, exp_w, *a, **kw):
        calls.append(("v3", exp_w is None, kw["k"], kw["stride"], kw["act"],
                      kw["se_w1"] is not None, kw["residual"]))
        return real_block(x, exp_w, *a, **kw)

    monkeypatch.setattr(mobilenet_v3, "v3_block", block)
    monkeypatch.setattr(mobilenet_v3, "fused_head", lambda x, conv, post: calls.append(
        ("head", conv[2], [p[2] for p in post])) or real_head(x, conv, post))
    x = torch.from_numpy(_x(5, 1))
    fused = mobilenet_v3.forward_v3(params, x, cfg, dw_backend="auto")
    assert calls[-1] == ("head", "hswish", ["hswish", "linear"])
    assert calls[:-1] == [("v3", not b.has_expand, b.kernel, b.stride, b.act, b.se_mid > 0,
                           b.has_res) for b in cfg.block_defs]
    calls.clear()
    mixed = mobilenet_v3.forward_v3(params, x, cfg, dw_backend="mixed")
    assert [c[0] for c in calls] == ["v3"] * 13 + ["head"]
    torch.testing.assert_close(mixed, fused, atol=1e-3, rtol=1e-3)


def test_routing_resolves_as_jax():
    """"mixed" and the per-block tuple resolve as the JAX package's
    _routing_v3 does ("xla" is the port's "plain"); "auto" is fused at
    every batch, on Large and on Small."""
    to_port = {"xla": "plain", "fused": "fused"}
    for name in ("large", "small"):
        cfg, jcfg = _cfgs(name, 224)
        n = len(cfg.block_defs)
        assert mobilenet_v3.mixed_b1_routing(cfg) == tuple(
            to_port[r] for r in jax_v3.mixed_b1_routing(jcfg))
        assert mobilenet_v3._routing_v3(cfg, None, 1) == ("plain",) * n
        assert mobilenet_v3._routing_v3(cfg, "plain", 8) == ("plain",) * n
    cfg, jcfg = _cfgs("large", 224)
    n = len(cfg.block_defs)
    assert mobilenet_v3._routing_v3(cfg, "mixed", 8) == tuple(
        to_port[r] for r in jax_v3._routing_v3(jcfg, "mixed", 8))
    assert mobilenet_v3._routing_v3(cfg, "auto", 256) == ("fused",) * n
    assert mobilenet_v3._routing_v3(cfg, "auto", 1) == ("fused",) * n
    tup = ("plain", "fused") * 7 + ("fused",)
    assert mobilenet_v3._routing_v3(cfg, tup, 1) == tuple(
        to_port[r] for r in jax_v3._routing_v3(
            jcfg, tuple("xla" if r == "plain" else r for r in tup), 1))
    for bad in ("xla", ("fused",) * (n - 1), ("fused",) * (n - 1) + ("pallas",)):
        with pytest.raises(ValueError):
            mobilenet_v3._routing_v3(cfg, bad, 1)
    small, jsmall = _cfgs("small", 224)
    assert mobilenet_v3._routing_v3(small, "auto", 1) == ("fused",) * 11
    assert mobilenet_v3._routing_v3(small, "auto", 256) == ("fused",) * 11
    assert mobilenet_v3._routing_v3(small, "mixed", 1) == ("plain",) * 4 + ("fused",) * 7
    tup = ("fused",) + ("plain",) * 10
    assert mobilenet_v3._routing_v3(small, tup, 1) == tuple(
        to_port[r] for r in jax_v3._routing_v3(
            jsmall, tuple("xla" if r == "plain" else r for r in tup), 1))


def test_pipeline_gate_and_server_on_cpu(capsys):
    """InferencePipeline(V3Config) serves uint8 batches with the JAX
    pipeline's top-1 and its taps match the plain forward's; verify_layers
    passes every tap on the CPU; a V3 server's selftest has 0 errors; a
    V3-Small int8 server builds on its fused route."""
    from mobilenet_tpu.runtime.pipeline import InferencePipeline as JaxPipeline

    cfg, jcfg = _cfgs("large")
    pipe = InferencePipeline(cfg, device="cpu", seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (3, RES, RES, 3), np.uint8)
    probs = pipe.run_batch(frames)
    assert probs.shape == (3, 1000) and np.allclose(probs.sum(-1), 1, atol=1e-5)
    ref = JaxPipeline(jcfg, seed=0).run_batch(frames)
    np.testing.assert_array_equal(probs.argmax(-1), ref.argmax(-1))
    logits, acts = pipe.activations(np.zeros((1, RES, RES, 3), np.float32))
    assert logits.shape == (1, 1000) and "block14_se" in acts and "head" in acts
    folded = fold_bn_v3(init_params_v3(cfg, 1), eps=cfg.bn_eps)
    assert teval.verify_layers(cfg, folded, _x(3, 1), device="cpu")
    assert "VERIFY OK" in capsys.readouterr().out
    assert config_from_variant("v3:1.0:224", "float32") == V3Config("large", 1.0, 224)

    async def run():
        v3 = config_from_variant(f"v3:1.0:{RES}")
        server, _ = build_server({v3.variant_name(): v3}, 4, device="cpu")
        await server.start()
        try:
            return await selftest(server, streams=4, requests_per_stream=2)
        finally:
            await server.close()

    stats = asyncio.run(run())
    assert stats["errors"] == 0 and stats["requests"] == 8
    scfg = _cfgs("small")[0]
    small, _ = build_server({scfg.variant_name(): scfg}, 1, device="cpu", int8=True)  # warm-runs bucket 1
    assert small.pipeline.dw_backend == "auto" and small.pipeline.config.variant == "small"


def test_verify_v3_catches_a_wrong_tap(monkeypatch, capsys):
    """The gate fails when one layer is off by more than V3_TOL."""
    cfg, _ = _cfgs("large_min")
    folded = fold_bn_v3(init_params_v3(cfg, 2), eps=cfg.bn_eps)
    real = mobilenet_v3.head_matmul
    monkeypatch.setattr(mobilenet_v3, "head_matmul",
                        lambda pooled, head, act: real(pooled, head, act) * 1.01)
    assert not teval.verify_layers(cfg, folded, _x(4, 1), device="cpu")
    assert "[FAIL] head" in capsys.readouterr().out


def test_cli_serve_v3_on_cpu(capsys):
    from mobilenet_tpu_torch import cli

    cli.main(["serve", "--model", "v3", "--minimalistic", "--streams", "2", "--alpha", "1.0",
              "--res", str(RES), "--device", "cpu", "--dtype", "float32"])
    out = capsys.readouterr().out
    assert '"errors": 0' in out
    with pytest.raises(SystemExit):
        cli.main(["serve", "--model", "v2", "--minimalistic", "--device", "cpu"])


def test_small_golden_fixture_fused_vs_jax_fused():
    """V3-Small 1.0-96 on the golden fixture's input and weights: the port's
    fused route (one v3_block per block, block 0 included, its plain version
    on CPU tensors, then the fused head) within 1e-3 in float32 of the JAX
    package's fused route (se_block_packed, expand_block_packed_s2 and
    v3_block_pallas in interpret mode, block 0 on XLA ops), and within
    golden.V3_TOL of the fixture's logits."""
    data = np.load(GOLDEN)
    cfg, jcfg = _cfgs("small", 96)
    tree = _tree(0, jcfg)
    params = from_jax_params_v3(tree, "cpu", torch.float32, cfg)
    got = mobilenet_v3.forward_v3(params, torch.from_numpy(data["x"]), cfg,
                                  dw_backend="auto").numpy()
    ref = np.asarray(jax_v3.forward_v3(tree, jnp.asarray(data["x"]), jcfg, dw_backend="fused"))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    atol, rtol = golden.V3_TOL
    np.testing.assert_allclose(got, data["logits"], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(got.argmax(-1), data["logits"].argmax(-1))


def test_small_bf16_fused_route_vs_plain_route():
    """V3-Small's bf16 routes at the anchored routing gate, as Large's
    (test_bf16_fused_route_vs_plain_route), SE biases made non-zero."""
    cfg, jcfg = _cfgs("small", 96)
    tree = _tree(6, jcfg)
    rng = np.random.default_rng(9)
    for blk in tree["blocks"]:
        for b in ("b1", "b2") if "se" in blk else ():
            blk["se"][b] = (rng.standard_normal(blk["se"][b].shape) * 0.2).astype(np.float32)
    x = _x(10, 4, 96)
    params = from_jax_params_v3(tree, "cpu", torch.bfloat16, cfg)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mobilenet_v3.forward_v3(params, xb, cfg, dw_backend="auto").float().numpy()
    ref = mobilenet_v3.forward_v3(params, xb, cfg, dw_backend="plain").float().numpy()
    ora = np.asarray(numpy_ref.forward_all_v3(tree, x, cfg)[0], np.float32)
    atol = golden.routing_bf16_atol(float(np.abs(ref).max()), _rms(got - ref), got.size)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    srt = np.sort(ref, -1)
    flips = got.argmax(-1) != ref.argmax(-1)
    assert not (flips & (srt[:, -1] - srt[:, -2] >= atol)).any()
    assert _rms(got - ora) <= golden.ROUTING_ANCHOR_FACTOR * _rms(ref - ora) + \
        golden.ROUTING_BF16_ATOL


def test_small_fused_route_one_kernel_per_block_and_serve(monkeypatch, capsys):
    """make_config("v3small") is the JAX package's V3-Small config; its
    fused route sends all 11 blocks to v3_block (block 0: the identity
    expansion at stride 2 with SE); `cli serve --model v3small` answers with
    0 errors on the CPU."""
    from mobilenet_tpu_torch import cli
    from mobilenet_tpu_torch.runtime.serving import MODELS, make_config

    assert "v3small" in MODELS
    for mini in (False, True):
        ours = make_config("v3small", 1.0, 224, "float32", mini)
        ref = jax_v3.V3Config("small", 1.0, 224, minimalistic=mini)
        assert ours == V3Config("small", 1.0, 224, minimalistic=mini)
        assert [dataclasses.astuple(b) for b in ours.block_defs] == [
            dataclasses.astuple(b) for b in ref.block_defs]
    cfg, jcfg = _cfgs("small")
    params = from_jax_params_v3(_tree(4, jcfg), "cpu", torch.float32, cfg)
    calls = []
    real = mobilenet_v3.v3_block

    def block(x, exp_w, *a, **kw):
        calls.append((exp_w is None, kw["k"], kw["stride"], kw["se_w1"] is not None,
                      kw["residual"]))
        return real(x, exp_w, *a, **kw)

    monkeypatch.setattr(mobilenet_v3, "v3_block", block)
    mobilenet_v3.forward_v3(params, torch.from_numpy(_x(5, 1)), cfg, dw_backend="auto")
    assert calls == [(not b.has_expand, b.kernel, b.stride, b.se_mid > 0, b.has_res)
                     for b in cfg.block_defs]
    assert calls[0] == (True, 3, 2, True, False)
    cli.main(["serve", "--model", "v3small", "--streams", "2", "--alpha", "1.0",
              "--res", str(RES), "--device", "cpu", "--dtype", "float32"])
    assert '"errors": 0' in capsys.readouterr().out
