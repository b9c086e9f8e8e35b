"""The port's V1 forward against the JAX package: the golden fixture's
logits, the per-layer NumPy oracle, the JAX bf16 fused route, and the
batch-1 chain routing."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn as jax_fold_bn
from mobilenet_tpu.checkpoints import init_params as jax_init_params
from mobilenet_tpu.checkpoints import to_device as jax_to_device
from mobilenet_tpu.models import mobilenet_v1 as jax_v1
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import ModelConfig
from mobilenet_tpu_torch.checkpoints import from_jax_params
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.ops import preprocess as prep

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mnv1_0.25_128_seed0.npz")
CFG, JCFG = ModelConfig(0.25, 128), JaxConfig(0.25, 128)


def _params(seed, dtype):
    tree = jax_fold_bn(jax_init_params(JCFG, seed), eps=JCFG.bn_eps)
    return tree, from_jax_params(tree, "cpu", dtype, CFG.block_strides)


@pytest.mark.parametrize("dw_backend", ["plain", "auto"])
def test_golden_logits(dw_backend):
    """fp32 forward on the committed fixture's input, at golden.MM_TOL."""
    data = np.load(GOLDEN)
    _, params = _params(0, torch.float32)
    logits = mobilenet_v1.forward(params, torch.from_numpy(data["x"]), CFG,
                                  dw_backend=dw_backend)
    atol, rtol = golden.MM_TOL
    np.testing.assert_allclose(logits.numpy(), data["logits"], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), data["logits"].argmax(-1))


def test_per_layer_taps_vs_oracle():
    """Every tap (conv1, blockNN_dw/_pw, pool, logits) against the NumPy
    oracle at golden.DW_TOL / MM_TOL."""
    tree, params = _params(1, torch.float32)
    x = np.random.default_rng(8).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    logits, acts = mobilenet_v1.forward(params, torch.from_numpy(x), CFG,
                                        dw_backend="auto", collect=True)
    _, ref = numpy_ref.forward_all(tree, x, JCFG)
    assert list(acts) == list(ref)
    reports = golden.compare_activations({k: v.numpy() for k, v in acts.items()}, ref)
    golden.assert_all_match(reports)


def test_bf16_probs_vs_jax_fused():
    """bf16 probabilities against the JAX package's fused route (its Pallas
    kernels in interpret mode) on the same weights and images: within the
    JAX routing gate's bf16 class, and the same top-1."""
    tree, params = _params(2, torch.bfloat16)
    imgs = np.random.default_rng(9).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    ours = mobilenet_v1.predict_probs_u8(params, torch.from_numpy(imgs), CFG,
                                         dtype=torch.bfloat16, dw_backend="auto")
    from mobilenet_tpu.ops import preprocess as jprep

    jx = jprep.preprocess(jnp.asarray(imgs), 128, jnp.bfloat16)
    ref = np.asarray(jax_v1.predict_probs(jax_to_device(tree, dtype=jnp.bfloat16),
                                          jx, JCFG, dw_backend="fused"))
    # logits of two valid bf16 routes differ by up to ~6e-2 (the JAX
    # routing gate's V1 floor), so probabilities by up to e^0.06 - 1 ~ 6%
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0.1)
    np.testing.assert_array_equal(ours.argmax(-1).numpy(), ref.argmax(-1))


def test_preprocess_matches_jax():
    from mobilenet_tpu.ops import preprocess as jprep

    imgs = np.random.default_rng(3).integers(0, 256, (1, 100, 90, 3), dtype=np.uint8)
    for res in (64, 128):
        ref = np.asarray(jprep.preprocess(jnp.asarray(imgs), res))
        got = prep.preprocess(torch.from_numpy(imgs), res).numpy()
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    same = imgs[:, :90, :90]
    np.testing.assert_array_equal(prep.normalize(torch.from_numpy(same)).numpy(),
                                  np.asarray(jprep.normalize(jnp.asarray(same))))


@pytest.mark.parametrize("batch,expect_chain", [(1, True), (2, False)])
def test_batch1_routes_chain_over_blocks_6_to_10(monkeypatch, batch, expect_chain):
    """At batch 1 the fused route runs blocks 6-10 as one chain launch and
    the rest as per-block kernels; at batch 2 every block is per-block.
    Logits equal the per-block route's exactly."""
    _, params = _params(4, torch.bfloat16)
    runs = mobilenet_v1._chain_runs(params, CFG, ("fused",) * 13,
                                    (batch, 64, 64, 8), 2)
    assert runs == {6: 5}
    calls = []
    real_chain, real_block = mobilenet_v1.chain, mobilenet_v1.separable_block
    monkeypatch.setattr(mobilenet_v1, "chain", lambda x, *a: calls.append(
        ("chain", x.shape)) or real_chain(x, *a))
    monkeypatch.setattr(mobilenet_v1, "separable_block", lambda x, *a: calls.append(
        ("block", x.shape)) or real_block(x, *a))
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (batch, 128, 128, 3)).astype(np.float32)).to(torch.bfloat16)
    got = mobilenet_v1.forward(params, x, CFG, dw_backend="auto")
    kinds = [k for k, _ in calls]
    if expect_chain:
        assert kinds == ["block"] * 6 + ["chain"] + ["block"] * 2
        assert calls[6][1] == (1, 8, 8, 128)
    else:
        assert kinds == ["block"] * 13
    monkeypatch.setattr(mobilenet_v1, "CHAIN_AT_BATCH1", False)
    assert torch.equal(mobilenet_v1.forward(params, x, CFG, dw_backend="auto"), got)


def test_chain_runs_follow_routing():
    """A plain block inside the stretch breaks the run; a run of 4 fused
    blocks still chains (stacked at call time, not at load)."""
    _, params = _params(0, torch.bfloat16)
    shape = (1, 64, 64, 8)
    route = ["fused"] * 13
    route[8] = "plain"
    assert mobilenet_v1._chain_runs(params, CFG, tuple(route), shape, 2) == {}
    route[8], route[6] = "fused", "plain"
    assert mobilenet_v1._chain_runs(params, CFG, tuple(route), shape, 2) == {7: 4}
    stacked = mobilenet_v1._chain_weights(params, 7, 4)
    assert stacked[0].shape == (4, 3, 3, 128)
    assert torch.equal(stacked[2][0], params["blocks"][7]["pw"]["w"])
    assert mobilenet_v1._chain_weights(params, 6, 5) is params["chain"][6]


def test_routing():
    assert mobilenet_v1._routing(CFG, None, 1) == ("plain",) * 13
    assert mobilenet_v1._routing(CFG, "auto", 256) == ("fused",) * 13
    assert mobilenet_v1._routing(CFG, "auto", 1) == ("fused",) * 13
    mixed = ("plain",) * 2 + ("fused",) * 11
    assert mobilenet_v1._routing(CFG, mixed, 4) == mixed
    for bad in ("mixed", "xla", ("fused",) * 12):
        with pytest.raises(ValueError):
            mobilenet_v1._routing(CFG, bad, 1)
