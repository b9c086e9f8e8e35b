"""The port's int8 MobileNet-V3 against the JAX package at 1.0-96, batch 2,
8 calibration images (the size of tests/test_quant_v3.py), for Large and
Small: the quantizer field by field, the scale groups, every tap of the
oracle and of the collect route, the plain and fused routes' logits (the
kernel's plain version on the CPU) against the JAX XLA int8 route and the
JAX fused route with its Pallas kernels in interpret mode (Large at 1.0-96;
Small at 1.0-224, batch 1, the size at which the JAX fused route runs
Small's block 0 on `packed_block_i8_named_s2_se`). Also Int8PipelineV3
against the JAX Int8PipelineV3, the per-layer gate, the servers and the
CLI. Every int8 comparison is exact; so are the logits."""

import asyncio
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.checkpoints.v3 import fold_bn_v3 as jax_fold_bn_v3
from mobilenet_tpu.checkpoints.v3 import init_params_v3 as jax_init_params_v3
from mobilenet_tpu.models import mobilenet_v3 as jax_v3
from mobilenet_tpu.quant import v3 as jax_qv3
from mobilenet_tpu.quant.quantize import quantize_input
from mobilenet_tpu_torch import Int8PipelineV3, V3Config
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.ops import v3_block_i8 as v3_block_i8_mod
from mobilenet_tpu_torch.quant import v3 as qv3
from mobilenet_tpu_torch.quant.verify import verify_int8_v3
from mobilenet_tpu_torch.runtime.serving import build_server, selftest

RES, N_CALIB = 96, 8


@functools.lru_cache(maxsize=None)
def _setup(variant):
    cfg, jcfg = V3Config(variant, 1.0, RES), jax_v3.V3Config(variant, 1.0, RES)
    folded = jax_fold_bn_v3(jax_init_params_v3(jcfg, seed=0), eps=jcfg.bn_eps)
    x = np.random.default_rng(5).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    x_i8 = quantize_input(x)
    jq = jax_qv3.quantize_v3(folded, jcfg, n_calib=N_CALIB)
    q = qv3.quantize_v3(folded, cfg, n_calib=N_CALIB)
    logits, acts = jax_qv3.forward_all_v3_i8(jq, x_i8, jcfg)
    return dict(cfg=cfg, jcfg=jcfg, folded=folded, x=x, x_i8=x_i8, jq=jq, q=q,
                logits=logits, acts=acts)


@pytest.fixture(params=["large", "small"])
def setup(request):
    return _setup(request.param)


def _same_layer(a, b, where):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert np.asarray(va).dtype == np.asarray(vb).dtype, (where, f.name)
        np.testing.assert_array_equal(va, vb, err_msg=f"{where}.{f.name}")


def test_quantize_v3_equals_jax(setup):
    q, jq = setup["q"], setup["jq"]
    for name in ("conv1", "conv_last", "head"):
        _same_layer(getattr(q, name), getattr(jq, name), name)
    assert [sorted(b) for b in q.blocks] == [sorted(b) for b in jq.blocks]
    assert any("se1" in b for b in q.blocks)
    for i, (b, jb) in enumerate(zip(q.blocks, jq.blocks)):
        for k in b:
            _same_layer(b[k], jb[k], f"blocks[{i}].{k}")
    for name in ("fc_w_i8", "fc_s_w", "fc_b_f32", "s_head"):
        assert np.asarray(getattr(q, name)).dtype == np.asarray(getattr(jq, name)).dtype
        np.testing.assert_array_equal(getattr(q, name), getattr(jq, name), err_msg=name)


@pytest.mark.parametrize("variant", ["large", "small"])
@pytest.mark.parametrize("alpha,mini", [(0.75, False), (1.0, False), (1.0, True)])
def test_scale_groups_equal_jax(variant, alpha, mini):
    assert qv3.scale_groups_v3(V3Config(variant, alpha, RES, minimalistic=mini)) == \
        jax_qv3.scale_groups_v3(jax_v3.V3Config(variant, alpha, RES, minimalistic=mini))


def test_stem_accumulation_split():
    """quant/ops.conv1_acc_i8, the stem's exact integer sums that V3 requantizes
    with its named activation, equals the JAX oracle's `_conv3x3_acc_np`;
    conv1_i8 (V1, V2) is that sum + bias under the ReLU6 requant."""
    from mobilenet_tpu_torch.quant import ops as qops

    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, 10, 12, 3)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, 16)).astype(np.int8)
    b = rng.integers(-3000, 3000, (16,)).astype(np.int32)
    m = rng.uniform(1e-4, 1e-3, (16,)).astype(np.float32)
    acc = qops.conv1_acc_i8(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(acc.numpy(), jax_qv3._conv3x3_acc_np(x, w, 2))
    tb, tm = torch.from_numpy(b), torch.from_numpy(m)
    assert torch.equal(qops.conv1_i8(torch.from_numpy(x), torch.from_numpy(w), tb, tm, 127.0),
                       qops.requantize(acc + tb, tm, 127.0))


def test_small_golden_fixture_int8_logits():
    """V3-Small 1.0-96's committed fixture pins the calibrated int8 logits
    (8 calibration images): the port's quantizer and plain route give them
    bit for bit."""
    data = np.load(pathlib.Path(__file__).parent / "golden" / "mnv3s_1.0_96_seed0.npz")
    q = _setup("small")["q"]
    dev = qv3.to_device_i8_v3(q, "cpu")
    got = qv3.forward_v3_i8(dev, torch.from_numpy(quantize_input(data["x"])),
                            V3Config("small", 1.0, RES))
    np.testing.assert_array_equal(got.numpy(), data["logits_i8"])


def test_oracle_every_tap_equals_jax(setup):
    got_logits, got = qv3.forward_all_v3_i8(setup["jq"], setup["x_i8"], setup["cfg"])
    ref = setup["acts"]
    assert list(got) == list(ref)
    for name, want in ref.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(got_logits, setup["logits"])


def test_collect_route_every_tap(setup):
    dev = qv3.to_device_i8_v3(setup["q"], "cpu")
    logits, acts = qv3.forward_v3_i8(dev, torch.from_numpy(setup["x_i8"]), setup["cfg"],
                                     collect=True)
    ref = setup["acts"]
    assert list(acts) == list(ref)
    for name, want in ref.items():
        assert acts[name].dtype == (torch.float32 if name == "logits" else torch.int8)
        np.testing.assert_array_equal(acts[name].numpy(), want, err_msg=name)
    np.testing.assert_array_equal(logits.numpy(), setup["logits"])


def test_routes_vs_jax_xla_route(setup, monkeypatch):
    """The port's plain route and fused route (one v3_block_i8 per block,
    its plain version here: 15 on Large, 11 on Small, block 0 with the
    identity expansion) equal the JAX XLA int8 route and the oracle, bit for
    bit; so does a per-block route with one fused block."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    dev = qv3.to_device_i8_v3(setup["q"], "cpu")
    x = torch.from_numpy(setup["x_i8"])
    jdev = jax_qv3._as_device_tree_v3(setup["jq"])
    xla = np.asarray(jax.jit(lambda v: jax_qv3.forward_v3_i8(jdev, v, jcfg))(
        jnp.asarray(setup["x_i8"])))
    np.testing.assert_array_equal(xla, setup["logits"])
    np.testing.assert_array_equal(qv3.forward_v3_i8(dev, x, cfg).numpy(), xla)
    calls = []
    real = qv3.v3_block_i8

    def spy(y, exp, dw, prj, **kw):
        calls.append((exp is None, kw["k"], kw["stride"], kw["act"], kw["se1"] is not None,
                      kw["residual"]))
        return real(y, exp, dw, prj, **kw)

    monkeypatch.setattr(qv3, "v3_block_i8", spy)
    for route in ("fused", "auto"):
        calls.clear()
        np.testing.assert_array_equal(qv3.forward_v3_i8(dev, x, cfg, dw_backend=route).numpy(),
                                      xla)
        assert calls == [(not b.has_expand, b.kernel, b.stride, b.act, b.se_mid > 0, b.has_res)
                         for b in cfg.block_defs]
    assert len(calls) == (11 if cfg.variant == "small" else 15)
    calls.clear()
    one = ("plain",) * (len(cfg.block_defs) - 1) + ("fused",)
    np.testing.assert_array_equal(qv3.forward_v3_i8(dev, x, cfg, dw_backend=one).numpy(), xla)
    assert len(calls) == 1


def test_fused_route_vs_jax_fused_route():
    """V3-Large: the port's fused route against the JAX package's fused
    route (use_fused=True: its int8 Pallas kernels in interpret mode, the
    lane-packed blocks 0 and 1 included), bit for bit."""
    setup = _setup("large")
    jdev = jax_qv3._as_device_tree_v3(setup["jq"])
    want = jax_qv3.forward_v3_i8(jdev, jnp.asarray(setup["x_i8"]), setup["jcfg"],
                                 use_fused=True)
    dev = qv3.to_device_i8_v3(setup["jq"], "cpu")
    got = qv3.forward_v3_i8(dev, torch.from_numpy(setup["x_i8"]), setup["cfg"],
                            dw_backend="fused")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_small_fused_route_vs_jax_fused_route_at_224(monkeypatch):
    """V3-Small 1.0-224, batch 1 (8 calibration images): the port's fused
    route against the JAX package's fused route, bit for bit. At this size
    the JAX route runs block 0 on `packed_block_i8_named_s2_se` (a spy sees
    one call; at 1.0-96 and 1.0-128 its plan takes block 0 whole-image and
    the kernel is never called) and blocks 1-10 on `v3_block_pallas_i8`."""
    from mobilenet_tpu.quant import pallas_block_packed_i8 as jax_pbi8

    cfg, jcfg = V3Config("small", 1.0, 224), jax_v3.V3Config("small", 1.0, 224)
    folded = jax_fold_bn_v3(jax_init_params_v3(jcfg, seed=0), eps=jcfg.bn_eps)
    jq = jax_qv3.quantize_v3(folded, jcfg, n_calib=N_CALIB)
    x_i8 = quantize_input(
        np.random.default_rng(9).uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32))
    seen = []
    real = jax_pbi8.packed_block_i8_named_s2_se

    def spy(x_packed, *args, **kw):
        seen.append(tuple(x_packed.shape))
        return real(x_packed, *args, **kw)

    monkeypatch.setattr(jax_pbi8, "packed_block_i8_named_s2_se", spy)
    want = jax_qv3.forward_v3_i8(jax_qv3._as_device_tree_v3(jq), jnp.asarray(x_i8), jcfg,
                                 use_fused=True)
    assert seen == [(1, 112, 14, 128)]
    got = qv3.forward_v3_i8(qv3.to_device_i8_v3(jq, "cpu"), torch.from_numpy(x_i8), cfg,
                            dw_backend="fused")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), jax_qv3.forward_all_v3_i8(jq, x_i8, jcfg)[0])


def test_to_device_i8_v3_constants(setup):
    """The requant constants are numpy float32 products of the layer's own
    fields: m = a * inv_s, m6 = inv_s * f32(1/6)."""
    dev = qv3.to_device_i8_v3(setup["jq"], "cpu")
    layer, ql = dev["blocks"][1]["exp"], setup["jq"].blocks[1]["exp"]
    assert layer["w"].dtype == torch.int8 and layer["b"].dtype == torch.int32
    np.testing.assert_array_equal(layer["m"].numpy(),
                                  np.asarray(ql.a, np.float32) * np.float32(ql.inv_s))
    assert layer["m6"] == float(np.float32(ql.inv_s) * np.float32(1.0 / 6.0))
    assert "exp" not in dev["blocks"][0] and isinstance(dev["s_head"], float)


def test_verify_int8_v3_on_cpu(setup, capsys):
    assert verify_int8_v3(setup["cfg"], setup["folded"], setup["x"][:1], n_calib=N_CALIB,
                          device="cpu")
    out = capsys.readouterr().out
    assert "INT8 VERIFY OK" in out and "logits         < 1e-05" in out


def test_verify_int8_v3_catches_a_wrong_tap(monkeypatch, capsys):
    setup = _setup("large")
    real = qv3.qops.se_i8
    monkeypatch.setattr(qv3.qops, "se_i8", lambda z, a, b: real(z, a, b).clamp(-127, 126))
    assert not verify_int8_v3(setup["cfg"], setup["folded"], setup["x"][:1],
                              n_calib=N_CALIB, device="cpu")
    assert "[FAIL]" in capsys.readouterr().out


def test_int8_pipeline_v3_vs_jax_pipeline():
    """V3-Large and V3-Small: both pipelines calibrate the seed-0 weights
    themselves (32 images); the port's runs its fused route ("auto"; the
    kernel's plain version), the JAX one its XLA route on the CPU. Softmax
    is float32 in two frameworks, so the probabilities agree to 1e-6, the
    classes exactly; the port's plain route gives the fused route's bits."""
    imgs = np.random.default_rng(7).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    for variant in ("large", "small"):
        pipe = Int8PipelineV3(V3Config(variant, 1.0, RES), device="cpu", seed=0)
        ours = pipe.run_batch(imgs)
        ref = jax_qv3.Int8PipelineV3(jax_v3.V3Config(variant, 1.0, RES), seed=0,
                                     use_fused=False).run_batch(imgs)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
        assert pipe.classify(imgs[1])[0][0] == int(ref[1].argmax())
        plain = Int8PipelineV3(V3Config(variant, 1.0, RES), device="cpu",
                               dw_backend="plain", quantized=pipe.q)
        np.testing.assert_array_equal(plain.run_batch(imgs), ours)


def test_int8_v3_server_selftest():
    """A V3-Large (1.0-64) and a V3-Small (1.0-96) int8 server (build_server
    calibrates) answer with 0 errors, on CPU tensors through the kernel's
    plain version (no launch)."""
    for variant, res in (("large", 64), ("small", RES)):
        cfg = V3Config(variant, 1.0, res)
        before = v3_block_i8_mod.v3_block_i8.launches
        frame = np.random.default_rng(1).integers(0, 256, (res, res, 3), np.uint8)

        async def run(cfg=cfg, frame=frame):
            server, _ = build_server({cfg.variant_name(): cfg}, 4, device="cpu", int8=True)
            await server.start()
            try:
                stats = await selftest(server, streams=4, requests_per_stream=2)
                return server, stats, await server.submit(frame)
            finally:
                await server.close()

        server, stats, lone = asyncio.run(run())
        assert isinstance(server.pipeline, Int8PipelineV3) and server.pipeline.config == cfg
        assert stats["errors"] == 0 and stats["requests"] == 8
        assert lone[0][0] == server.pipeline.classify(frame)[0][0]
        assert v3_block_i8_mod.v3_block_i8.launches == before  # CPU tensors: the plain version


def test_cli_serve_v3_int8_on_cpu(capsys):
    cli_main(["serve", "--model", "v3", "--int8", "--streams", "2", "--alpha", "1.0",
              "--res", "64", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["errors"] == 0 and stats["requests"] == 2 * 8
    cli_main(["serve", "--model", "v3small", "--int8", "--streams", "2", "--alpha", "1.0",
              "--res", str(RES), "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["errors"] == 0 and stats["requests"] == 2 * 8
