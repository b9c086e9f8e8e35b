"""The port's MobileNet-V2 against the JAX package: the config at every
alpha, the seeded weights bit for bit, the `.npz` round trip, every
per-layer tap against the NumPy oracle, the golden fixture's logits, the
bf16 fused route against the JAX fused route (the routing gate and the
oracle anchor), the routing, and the pipeline and server on the CPU."""

import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.checkpoints.v2 import fold_bn_v2 as jax_fold_bn_v2
from mobilenet_tpu.checkpoints.v2 import init_params_v2 as jax_init_params_v2
from mobilenet_tpu.models import mobilenet_v2 as jax_v2
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import InferencePipeline, V2Config
from mobilenet_tpu_torch.checkpoints import (
    fold_bn_v2, from_jax_params, from_jax_params_v2, init_params_v2, load_npz, save_npz,
)
from mobilenet_tpu_torch.models import mobilenet_v2
from mobilenet_tpu_torch.models.mobilenet_v2 import V2_ALPHAS, make_divisible
from mobilenet_tpu_torch.runtime.serving import build_server, config_from_variant, selftest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mnv2_1.0_96_seed0.npz")
CFG, JCFG = V2Config(1.0, 96), jax_v2.V2Config(1.0, 96)


def _tree(seed, jcfg=JCFG):
    return jax_fold_bn_v2(jax_init_params_v2(jcfg, seed), eps=jcfg.bn_eps)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("alpha", V2_ALPHAS)
def test_config_matches_jax(alpha):
    for res in (96, 224):
        ours, ref = V2Config(alpha, res), jax_v2.V2Config(alpha, res)
        assert ours.block_defs == ref.block_defs and len(ours.block_defs) == 17
        assert ours.stem_channels == ref.stem_channels
        assert ours.last_channels == ref.last_channels
        assert ours.final_spatial == ref.final_spatial
        assert ours.variant_name() == ref.variant_name()
    for v in (11.2, 5.6, 18.0, 48.0, 1792.0, 0.5):
        assert make_divisible(v) == jax_v2.make_divisible(v)
    with pytest.raises(ValueError):
        V2Config(0.25, 224)
    with pytest.raises(ValueError):
        V2Config(alpha, 100)


@pytest.mark.parametrize("alpha,seed", [(0.35, 0), (1.0, 3)])
def test_seeded_weights_bit_identical(alpha, seed):
    cfg, jcfg = V2Config(alpha, 96), jax_v2.V2Config(alpha, 96)
    raw = list(_leaves(init_params_v2(cfg, seed)))
    assert [(k, a.dtype, a.tobytes()) for k, a in raw] == [
        (k, a.dtype, a.tobytes()) for k, a in _leaves(jax_init_params_v2(jcfg, seed))]
    ours = list(_leaves(fold_bn_v2(init_params_v2(cfg, seed), eps=cfg.bn_eps)))
    ref = list(_leaves(_tree(seed, jcfg)))
    assert [k for k, _ in ours] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_npz_roundtrip_and_tree_checks(tmp_path):
    tree = fold_bn_v2(init_params_v2(CFG, 1))
    path = str(tmp_path / "v2.npz")
    save_npz(path, tree)
    back = load_npz(path)
    assert [(k, a.tobytes()) for k, a in _leaves(back)] == [
        (k, a.tobytes()) for k, a in _leaves(tree)]
    assert "exp" not in back["blocks"][0] and "exp" in back["blocks"][1]
    with pytest.raises(ValueError):
        from_jax_params(back, "cpu", torch.float32, (1,) * 17)
    with pytest.raises(ValueError):
        from_jax_params_v2(back, "cpu", torch.float32, V2Config(0.5, 96))


def test_per_layer_taps_vs_oracle():
    """All 64 taps of the plain route against the NumPy oracle at
    golden.V2_TOL (float32, batch 2)."""
    tree = _tree(0)
    params = from_jax_params_v2(tree, "cpu", torch.float32, CFG)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    _, acts = mobilenet_v2.forward_v2(params, torch.from_numpy(x), CFG, collect=True)
    _, ref = numpy_ref.forward_all_v2(tree, x, JCFG)
    assert list(acts) == list(ref) and len(ref) == 64
    reports = golden.compare_activations({k: v.numpy() for k, v in acts.items()}, ref,
                                         tols={k: golden.V2_TOL for k in ref})
    golden.assert_all_match(reports)


def test_plain_route_matches_jax_xla_route():
    """The plain route against the JAX package's "xla" route on the same
    weights: every float32 tap (the linear projections and the residual
    adds included) at golden.V2_TOL, and the bf16 logits within the routing
    gate's floor."""
    tree = _tree(5)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    params = from_jax_params_v2(tree, "cpu", torch.float32, CFG)
    _, acts = mobilenet_v2.forward_v2(params, torch.from_numpy(x), CFG, collect=True)
    _, ref = jax_v2.forward_v2(tree, jnp.asarray(x), JCFG, dw_backend="xla", collect=True)
    reports = golden.compare_activations({k: v.numpy() for k, v in acts.items()},
                                         {k: np.asarray(v) for k, v in ref.items()},
                                         tols={k: golden.V2_TOL for k in ref})
    golden.assert_all_match(reports)
    params16 = from_jax_params_v2(tree, "cpu", torch.bfloat16, CFG)
    got = mobilenet_v2.forward_v2(params16, torch.from_numpy(x).to(torch.bfloat16), CFG)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want = np.asarray(jax_v2.forward_v2(jtree, jnp.asarray(x, jnp.bfloat16), JCFG,
                                        dw_backend="xla"), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=max(golden.ROUTING_BF16_ATOL,
                                        golden.ROUTING_BF16_REL * float(np.abs(want).max())))


@pytest.mark.parametrize("dw_backend", ["plain", "auto", "mixed"])
def test_golden_logits(dw_backend):
    """float32 logits of the committed fixture (seed 0) on every route; on
    CPU tensors the kernels' wrappers run their plain versions."""
    data = np.load(GOLDEN)
    params = from_jax_params_v2(_tree(0), "cpu", torch.float32, CFG)
    logits = mobilenet_v2.forward_v2(params, torch.from_numpy(data["x"]), CFG,
                                     dw_backend=dw_backend)
    atol, rtol = golden.V2_TOL
    np.testing.assert_allclose(logits.numpy(), data["logits"], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), data["logits"].argmax(-1))


def test_bf16_fused_route_vs_jax_fused():
    """bf16 logits of the port's fused route against the JAX package's
    fused route (its Pallas kernels in interpret mode): within the routing
    gate (golden.routing_bf16_atol), top-1 equal up to near ties, and no
    farther from the fp32 oracle in RMS than the JAX route is (the oracle
    anchor of the JAX package's routing verify)."""
    tree = _tree(2)
    params = from_jax_params_v2(tree, "cpu", torch.bfloat16, CFG)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    got = mobilenet_v2.forward_v2(params, torch.from_numpy(x).to(torch.bfloat16), CFG,
                                  dw_backend="fused").float().numpy()
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    ref = np.asarray(jax_v2.forward_v2(jtree, jnp.asarray(x, jnp.bfloat16), JCFG,
                                       dw_backend="fused"), np.float32)
    ora = np.asarray(numpy_ref.forward_all_v2(tree, x, JCFG)[0], np.float32)
    rms = lambda a: float(np.sqrt(np.mean(a * a)))  # noqa: E731
    atol = golden.routing_bf16_atol(float(np.abs(ref).max()), rms(got - ref), got.size)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=5e-2)
    srt = np.sort(ref, -1)
    flips = got.argmax(-1) != ref.argmax(-1)
    assert not (flips & (srt[:, -1] - srt[:, -2] >= atol)).any()
    anchor = golden.ROUTING_ANCHOR_FACTOR * rms(ref - ora) + golden.ROUTING_BF16_ATOL
    assert rms(got - ora) <= anchor


def test_fused_route_runs_one_kernel_per_block(monkeypatch):
    """The fused route sends block 0 to the separable block's linear mode,
    blocks 1-16 to the inverted-residual kernel (residual where stride 1
    and Cin == Cout) and the head to fused_head with conv_last; a plain
    block in the tuple runs plain ops."""
    params = from_jax_params_v2(_tree(4), "cpu", torch.float32, CFG)
    calls = []
    real = (mobilenet_v2.separable_block, mobilenet_v2.inverted_residual,
            mobilenet_v2.fused_head)
    monkeypatch.setattr(mobilenet_v2, "separable_block", lambda *a, **kw: calls.append(
        ("sep", kw.get("pw_act"))) or real[0](*a, **kw))
    monkeypatch.setattr(mobilenet_v2, "inverted_residual", lambda *a: calls.append(
        ("ir", a[7], a[8])) or real[1](*a))
    monkeypatch.setattr(mobilenet_v2, "fused_head", lambda x, conv, post: calls.append(
        ("head", conv[2], len(post))) or real[2](x, conv, post))
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (1, 96, 96, 3)).astype(np.float32))
    fused = mobilenet_v2.forward_v2(params, x, CFG, dw_backend="auto")
    assert calls[0] == ("sep", False) and calls[-1] == ("head", "relu6", 1)
    assert [c[1:] for c in calls[1:-1]] == [
        (s, s == 1 and ci == co) for _, ci, co, s in CFG.block_defs[1:]]
    calls.clear()
    mixed = mobilenet_v2.forward_v2(params, x, CFG, dw_backend="mixed")
    assert [c[0] for c in calls] == ["ir"] * 15 + ["head"]
    torch.testing.assert_close(mixed, fused, atol=1e-4, rtol=1e-4)


def test_routing():
    n = 17
    assert mobilenet_v2._routing_v2(CFG, None, 1) == ("plain",) * n
    assert mobilenet_v2._routing_v2(CFG, "auto", 256) == ("fused",) * n
    assert mobilenet_v2._routing_v2(CFG, "auto", 1) == ("fused",) * n
    assert mobilenet_v2._routing_v2(CFG, "mixed", 1) == ("plain",) * 2 + ("fused",) * 15
    assert mobilenet_v2.mixed_b1_routing_v2(CFG) == mobilenet_v2._routing_v2(CFG, "mixed", 8)
    for bad in ("xla", ("fused",) * 16, ("fused",) * 16 + ("pallas",)):
        with pytest.raises(ValueError):
            mobilenet_v2._routing_v2(CFG, bad, 1)


def test_pipeline_and_server_on_cpu():
    """InferencePipeline(V2Config) serves uint8 batches with the JAX
    pipeline's top-1, its taps match the plain forward's, and a V2 server's
    selftest has 0 errors; with int8=True the server runs Int8PipelineV2
    (tests/test_torch_quant_v2.py serves it)."""
    from mobilenet_tpu_torch import Int8PipelineV2
    from mobilenet_tpu.runtime.pipeline import InferencePipeline as JaxPipeline

    cfg = V2Config(0.35, 96)
    pipe = InferencePipeline(cfg, device="cpu", seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (4, 96, 96, 3), np.uint8)
    probs = pipe.run_batch(frames)
    assert probs.shape == (4, 1000) and np.allclose(probs.sum(-1), 1, atol=1e-5)
    ref = JaxPipeline(jax_v2.V2Config(0.35, 96), seed=0).run_batch(frames)
    np.testing.assert_array_equal(probs.argmax(-1), ref.argmax(-1))
    assert pipe.classify(frames[1])[0][0] == int(ref[1].argmax())
    logits, acts = pipe.activations(np.zeros((1, 96, 96, 3), np.float32))
    assert logits.shape == (1, 1000) and len(acts) == 64
    assert config_from_variant("v2:0.35:96", "float32") == cfg
    assert config_from_variant("0.25:128").variant_name() == "mobilenet_v1_0.25_128"

    async def run():
        v2 = config_from_variant("v2:0.35:96")
        server, _ = build_server({v2.variant_name(): v2}, 4, device="cpu")
        await server.start()
        try:
            return await selftest(server, streams=4, requests_per_stream=2)
        finally:
            await server.close()

    stats = asyncio.run(run())
    assert stats["errors"] == 0 and stats["requests"] == 8
    server, _ = build_server({cfg.variant_name(): cfg}, 4, device="cpu", int8=True)
    assert isinstance(server.pipeline, Int8PipelineV2) and server.pipeline.config == cfg
