"""The port's int8 network against the JAX package at 0.25-128, batch 2 (the
size of tests/test_quant.py's fixture): every tap against the JAX int8
oracle, the fused route's logits against the JAX fused route (its Pallas
kernels in interpret mode), the JAX package's quantized weights carried
across, Int8Pipeline against the JAX Int8Pipeline, and the int8 server."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.quant import model as jax_qmodel
from mobilenet_tpu.quant import oracle as jax_oracle
from mobilenet_tpu.quant import quantize as jax_quantize
from mobilenet_tpu.quant import quantize_input
from mobilenet_tpu_torch import Int8Pipeline, ModelConfig
from mobilenet_tpu_torch.quant import model as qmodel
from mobilenet_tpu_torch.quant import quantize
from mobilenet_tpu_torch.quant.verify import verify_int8
from mobilenet_tpu_torch.runtime.serving import build_server, selftest

RES = 128
CFG, JCFG = ModelConfig(0.25, RES), JaxConfig(0.25, RES)


@pytest.fixture(scope="module")
def setup():
    folded = fold_bn(init_params(JCFG, seed=5), eps=JCFG.bn_eps)
    x = np.random.default_rng(21).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    x_i8 = quantize_input(x)
    q = jax_quantize(folded, JCFG)
    logits, acts = jax_oracle.forward_all(q, x_i8, JCFG)
    return folded, x, x_i8, q, logits, acts


@pytest.mark.parametrize("use_dw_kernel", [False, True])
def test_every_tap_vs_jax_oracle(setup, use_dw_kernel):
    folded, _, x_i8, _, _, ref = setup
    dev = qmodel.to_device_i8(quantize(folded, CFG), "cpu")
    logits, acts = qmodel.forward_i8(dev, torch.from_numpy(x_i8), CFG, dw_backend="auto",
                                     use_dw_kernel=use_dw_kernel, collect=True)
    assert list(acts) == list(ref)
    for name, want in ref.items():
        assert acts[name].dtype == (torch.float32 if name == "logits" else torch.int8)
        np.testing.assert_array_equal(acts[name].numpy(), want, err_msg=name)


def test_fused_route_vs_jax_fused(setup):
    """Logits of the port's fused route (the kernels' plain versions on the
    CPU) equal the JAX fused route's and the JAX XLA route's bit for bit."""
    folded, _, x_i8, q, ref_logits, _ = setup
    dev = qmodel.to_device_i8(quantize(folded, CFG), "cpu")
    got = qmodel.forward_i8(dev, torch.from_numpy(x_i8), CFG, dw_backend="fused").numpy()
    jdev = jax_qmodel._as_device_tree(q)
    jx = jnp.asarray(x_i8)
    fused = jax.jit(lambda v: jax_qmodel.forward_i8(jdev, v, JCFG, use_fused=True))(jx)
    xla = jax.jit(lambda v: jax_qmodel.forward_i8(jdev, v, JCFG, use_fused=False))(jx)
    np.testing.assert_array_equal(got, np.asarray(fused))
    np.testing.assert_array_equal(got, np.asarray(xla))
    np.testing.assert_array_equal(got, ref_logits)


def test_to_device_i8_takes_jax_params(setup):
    """The JAX package's QuantizedParams carries across: the same device
    tensors as the port's own quantizer gives, and the same logits."""
    folded, _, x_i8, q, ref_logits, _ = setup
    ours = qmodel.to_device_i8(quantize(folded, CFG), "cpu")
    theirs = qmodel.to_device_i8(q, "cpu")
    assert theirs["conv1"]["w"].dtype == torch.int8
    assert theirs["conv1"]["b"].dtype == torch.int32
    assert theirs["blocks"][0]["dw"]["m"].dtype == torch.float32
    assert isinstance(theirs["blocks"][0]["pw"]["six_q"], float)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    got = qmodel.forward_i8(theirs, torch.from_numpy(x_i8), CFG, dw_backend="fused")
    np.testing.assert_array_equal(got.numpy(), ref_logits)


def test_int8_pipeline_vs_jax_pipeline():
    imgs = np.random.default_rng(7).integers(0, 256, (3, RES, RES, 3), dtype=np.uint8)
    ours = Int8Pipeline(CFG, device="cpu", seed=0).run_batch(imgs)
    ref = jax_qmodel.Int8Pipeline(JCFG, seed=0).run_batch(imgs)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_padding_keeps_logits():
    """alpha 0.75: the fused route on padded channels (24 -> 32, 48 -> 64,
    96 -> 128) equals the plain route on unpadded channels bit for bit."""
    cfg, jcfg = ModelConfig(0.75, RES), JaxConfig(0.75, RES)
    folded = fold_bn(init_params(jcfg, seed=6), eps=jcfg.bn_eps)
    x_i8 = torch.from_numpy(quantize_input(
        np.random.default_rng(6).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)))
    padded = qmodel.to_device_i8(qmodel.quantize_for_device(folded, cfg, "auto"), "cpu")
    plain = qmodel.to_device_i8(qmodel.quantize_for_device(folded, cfg, "plain"), "cpu")
    assert padded["blocks"][0]["dw"]["w"].shape[-1] == 32
    assert plain["blocks"][0]["dw"]["w"].shape[-1] == 24
    got = qmodel.forward_i8(padded, x_i8, cfg, dw_backend="auto")
    assert torch.equal(got, qmodel.forward_i8(plain, x_i8, cfg, dw_backend="plain"))


def test_routing_i8():
    assert qmodel._routing_i8(CFG, None, 1) == ("plain",) * 13
    assert qmodel._routing_i8(CFG, "auto", 1) == ("fused",) * 13
    assert qmodel._routing_i8(CFG, "auto", 256) == ("fused",) * 13
    mixed = ("plain",) * 2 + ("fused",) * 11
    assert qmodel._routing_i8(CFG, mixed, 4) == mixed
    assert qmodel._routing_i8(CFG, "mixed", 1) == mixed  # the JAX package's tuple
    for bad in ("xla", ("fused",) * 12):
        with pytest.raises(ValueError):
            qmodel._routing_i8(CFG, bad, 1)


def test_verify_int8_on_cpu(setup, capsys):
    folded, x, *_ = setup
    assert verify_int8(CFG, folded, x[:1], device="cpu", use_dw_kernel=True)
    assert "INT8 VERIFY OK" in capsys.readouterr().out


def test_int8_server_selftest():
    async def run():
        server, _ = build_server({CFG.variant_name(): CFG}, 8, device="cpu", int8=True)
        await server.start()
        try:
            stats = await selftest(server, streams=8, requests_per_stream=2)
            frame = np.random.default_rng(1).integers(0, 256, (RES, RES, 3), np.uint8)
            lone = await server.submit(frame)
            return server, stats, lone
        finally:
            await server.close()

    server, stats, lone = asyncio.run(run())
    assert isinstance(server.pipeline, Int8Pipeline)
    assert stats["errors"] == 0 and stats["requests"] == 16
    assert lone[0][0] == server.pipeline.classify(
        np.random.default_rng(1).integers(0, 256, (RES, RES, 3), np.uint8))[0][0]


def test_int8_pipeline_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError):
            Int8Pipeline(CFG, **kw)
    with pytest.raises(RuntimeError):
        Int8Pipeline(CFG, device="cpu").benchmark(batch_size=1)
