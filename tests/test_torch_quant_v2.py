"""The port's int8 MobileNet-V2 against the JAX package at 1.0-96, batch 2,
8 calibration images (the size of tests/test_pallas_ir_i8.py's model tests):
the quantizer field by field, the scale groups, every tap of the oracle and
of the collect route, the fused route's logits (the kernels' plain versions
on the CPU) against the JAX XLA int8 route and the oracle, the JAX package's
quantized tree carried across, Int8PipelineV2 against the JAX
Int8PipelineV2, the per-layer gate, the server and the CLI. Every int8
comparison is exact; so are the logits. The JAX fused route is held equal to
its XLA route by the JAX package's own tests, so the XLA route stands for
both here (the fused route runs its Pallas kernels in interpret mode, ~30 s
at this size)."""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.checkpoints.v2 import fold_bn_v2 as jax_fold_bn_v2
from mobilenet_tpu.checkpoints.v2 import init_params_v2 as jax_init_params_v2
from mobilenet_tpu.models import mobilenet_v2 as jax_v2
from mobilenet_tpu.quant import v2 as jax_qv2
from mobilenet_tpu.quant.quantize import quantize_input
from mobilenet_tpu_torch import Int8PipelineV2, V2Config
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.quant import v2 as qv2
from mobilenet_tpu_torch.quant.verify import verify_int8_v2
from mobilenet_tpu_torch.runtime.serving import build_server, selftest

RES, N_CALIB = 96, 8
CFG, JCFG = V2Config(1.0, RES), jax_v2.V2Config(1.0, RES)


@pytest.fixture(scope="module")
def setup():
    folded = jax_fold_bn_v2(jax_init_params_v2(JCFG, seed=0), eps=JCFG.bn_eps)
    x = np.random.default_rng(5).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    x_i8 = quantize_input(x)
    jq = jax_qv2.quantize_v2(folded, JCFG, n_calib=N_CALIB)
    q = qv2.quantize_v2(folded, CFG, n_calib=N_CALIB)
    logits, acts = jax_qv2.forward_all_v2_i8(jq, x_i8, JCFG)
    return folded, x, x_i8, jq, q, logits, acts


def _same_layer(a, b, where):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert np.asarray(va).dtype == np.asarray(vb).dtype, (where, f.name)
        np.testing.assert_array_equal(va, vb, err_msg=f"{where}.{f.name}")


def test_quantize_v2_equals_jax(setup):
    _, _, _, jq, q, _, _ = setup
    assert [s.dtype for s in q.s_blk] == [np.float32] * 17
    np.testing.assert_array_equal(np.array(q.s_blk), np.array(jq.s_blk))
    for name in ("conv1", "conv_last"):
        _same_layer(getattr(q, name), getattr(jq, name), name)
    assert [sorted(b) for b in q.blocks] == [sorted(b) for b in jq.blocks]
    for i, (b, jb) in enumerate(zip(q.blocks, jq.blocks)):
        for k in b:
            _same_layer(b[k], jb[k], f"blocks[{i}].{k}")
    for name in ("fc_w_i8", "fc_s_w", "fc_b_f32"):
        assert getattr(q, name).dtype == getattr(jq, name).dtype
        np.testing.assert_array_equal(getattr(q, name), getattr(jq, name), err_msg=name)


@pytest.mark.parametrize("alpha", [0.35, 1.0, 1.4])
def test_scale_groups_equal_jax(alpha):
    assert qv2.scale_groups(V2Config(alpha, RES)) == jax_qv2.scale_groups(
        jax_v2.V2Config(alpha, RES))


def test_oracle_every_tap_equals_jax(setup):
    _, _, x_i8, jq, _, logits, ref = setup
    got_logits, got = qv2.forward_all_v2_i8(jq, x_i8, CFG)
    assert list(got) == list(ref)
    for name, want in ref.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(got_logits, logits)


def test_collect_route_every_tap(setup):
    _, _, x_i8, _, q, logits, ref = setup
    dev = qv2.to_device_i8_v2(q, "cpu")
    got_logits, acts = qv2.forward_v2_i8(dev, torch.from_numpy(x_i8), CFG, dw_backend="auto",
                                         collect=True)
    assert list(acts) == list(ref) and len(acts) == 64
    for name, want in ref.items():
        assert acts[name].dtype == (torch.float32 if name == "logits" else torch.int8)
        np.testing.assert_array_equal(acts[name].numpy(), want, err_msg=name)
    np.testing.assert_array_equal(got_logits.numpy(), logits)


def test_fused_route_vs_jax_xla_route(setup):
    """The port's fused route (block 0 through the separable block's linear
    mode, blocks 1-16 through the int8 inverted-residual kernel; their plain
    versions here) and its plain route equal the JAX XLA int8 route and the
    oracle, bit for bit."""
    _, _, x_i8, jq, q, logits, _ = setup
    dev = qv2.to_device_i8_v2(q, "cpu")
    x = torch.from_numpy(x_i8)
    fused = qv2.forward_v2_i8(dev, x, CFG, dw_backend="fused").numpy()
    plain = qv2.forward_v2_i8(dev, x, CFG).numpy()
    jdev = jax_qv2._as_device_tree_v2(jq)
    xla = jax.jit(lambda v: jax_qv2.forward_v2_i8(jdev, v, JCFG))(jnp.asarray(x_i8))
    np.testing.assert_array_equal(fused, np.asarray(xla))
    np.testing.assert_array_equal(fused, logits)
    np.testing.assert_array_equal(plain, logits)


def test_to_device_i8_v2_takes_jax_params(setup):
    _, _, x_i8, jq, q, logits, _ = setup
    ours, theirs = qv2.to_device_i8_v2(q, "cpu"), qv2.to_device_i8_v2(jq, "cpu")
    assert theirs["blocks"][1]["exp"]["w"].dtype == torch.int8
    assert theirs["blocks"][1]["prj"]["b"].dtype == torch.int32
    assert theirs["blocks"][1]["prj"]["m"].dtype == torch.float32
    assert isinstance(theirs["blocks"][1]["dw"]["six_q"], float)
    assert "exp" not in theirs["blocks"][0]
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    got = qv2.forward_v2_i8(theirs, torch.from_numpy(x_i8), CFG, dw_backend="fused")
    np.testing.assert_array_equal(got.numpy(), logits)


def test_routing_v2_i8():
    n = 17
    assert qv2._routing_v2_i8(CFG, None, 1) == ("plain",) * n
    assert qv2._routing_v2_i8(CFG, "auto", 1) == ("fused",) * n
    assert qv2._routing_v2_i8(CFG, "auto", 256) == ("fused",) * n
    mixed = ("plain",) * 2 + ("fused",) * 15
    assert qv2._routing_v2_i8(CFG, mixed, 4) == mixed
    for bad in ("mixed", "xla", ("fused",) * 16):
        with pytest.raises(ValueError):
            qv2._routing_v2_i8(CFG, bad, 1)


def test_int8_pipeline_v2_vs_jax_pipeline():
    """Both pipelines calibrate the seed-0 weights themselves (32 images);
    the JAX one runs its XLA route on the CPU. Softmax is float32 in two
    frameworks, so the probabilities agree to 1e-6, the classes exactly."""
    imgs = np.random.default_rng(7).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    pipe = Int8PipelineV2(CFG, device="cpu", seed=0)
    ours = pipe.run_batch(imgs)
    ref = jax_qv2.Int8PipelineV2(JCFG, seed=0).run_batch(imgs)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    assert pipe.classify(imgs[1])[0][0] == int(ref[1].argmax())


def test_verify_int8_v2_on_cpu(setup, capsys):
    folded, x, *_ = setup
    assert verify_int8_v2(CFG, folded, x[:1], n_calib=N_CALIB, device="cpu")
    assert "INT8 VERIFY OK (64 layers" in capsys.readouterr().out


def test_int8_v2_server_selftest():
    cfg = V2Config(0.35, 96)

    async def run():
        server, _ = build_server({cfg.variant_name(): cfg}, 8, device="cpu", int8=True)
        await server.start()
        try:
            stats = await selftest(server, streams=8, requests_per_stream=2)
            frame = np.random.default_rng(1).integers(0, 256, (96, 96, 3), np.uint8)
            lone = await server.submit(frame)
            return server, stats, lone, frame
        finally:
            await server.close()

    server, stats, lone, frame = asyncio.run(run())
    assert isinstance(server.pipeline, Int8PipelineV2)
    assert stats["errors"] == 0 and stats["requests"] == 16
    assert lone[0][0] == server.pipeline.classify(frame)[0][0]


def test_cli_serve_v2_int8_on_cpu(capsys):
    cli_main(["serve", "--model", "v2", "--int8", "--streams", "4", "--alpha", "0.35",
              "--res", "96", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["errors"] == 0 and stats["requests"] == 4 * 8


def test_int8_pipeline_v2_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        Int8PipelineV2(CFG, device="cuda", quantized=object())
