"""Data and tensor parallelism of the port (parallel/mesh.py, tp_fused.py,
quant/tp.py, the pipelines' `mesh=`, `serve`/`warmup --dp`) against the JAX
package on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices
(`pmesh.make_mesh(8, model_parallel=tp)`), the port on host ranks
(`devices=["cpu"] * n`), from the same seeded folded weights at the JAX
tests' size, V1 0.25-64 at batch 8. Float32 within atol 2e-4 / rtol 1e-3
(tests/test_tp_fused.py: the psum reassociates the pointwise sum); int8
bit-equal. The raw-partial mode of the separable block
(`pw_epilogue=False`) against `separable_block_pallas(pw_epilogue=False)`
in interpret mode. Each JAX reference is computed once (module fixtures).

At 0.25 the first blocks' channel shards are narrower than the separable
kernel's multiple of 8 (block 0: 8 channels, 2 a rank at tp 4); the "fused"
cases route those blocks "xla" by tuple, and a "fused" block on such a
shard raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn as jax_fold_bn
from mobilenet_tpu.checkpoints import init_params as jax_init_params
from mobilenet_tpu.ops.pallas_block import separable_block_pallas
from mobilenet_tpu.parallel import mesh as jax_pmesh
from mobilenet_tpu.parallel import tp_fused as jax_tp
from mobilenet_tpu.quant import model as jax_qmodel
from mobilenet_tpu.quant import tp as jax_qtp
from mobilenet_tpu.quant.ops import quantize_input_dev as jax_quantize_input
from mobilenet_tpu.quant.quantize import ACT_IN_SCALE
from mobilenet_tpu.runtime.serving import default_buckets as jax_default_buckets
from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import to_device
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.ops.separable_block import separable_block, separable_block_plain
from mobilenet_tpu_torch.parallel import mesh as pmesh
from mobilenet_tpu_torch.parallel import tp_fused
from mobilenet_tpu_torch.quant import tp as qtp
from mobilenet_tpu_torch.quant.model import Int8Pipeline, forward_i8, quantize_for_device, \
    to_device_i8
from mobilenet_tpu_torch.quant.v2 import Int8PipelineV2
from mobilenet_tpu_torch.quant.v3 import Int8PipelineV3
from mobilenet_tpu_torch.runtime.pipeline import InferencePipeline
from mobilenet_tpu_torch.runtime.serving import build_server, default_buckets, selftest

TP_TOL = dict(atol=2e-4, rtol=1e-3)
F32_TOL = dict(atol=3e-5, rtol=1e-5)  # tests/test_pallas_block.py
BF16_TOL = dict(atol=1 / 32, rtol=2 ** -7)  # a bf16 step of the depthwise result
RES, BATCH = 64, 8


def _cpu_mesh(n, tp=1):
    return pmesh.make_mesh(n, model_parallel=tp, devices=["cpu"] * n)


# -- the raw-partial mode --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,h,cin,cout", [(1, 8, 128, 64), (2, 8, 64, 128)])
def test_raw_partial_vs_pallas(dtype, stride, h, cin, cout):
    """pw_epilogue=False: the raw float32 product, no pw bias, no
    activation, float32 whatever x's dtype."""
    rng = np.random.default_rng(stride * 100 + cin)
    arrs = (rng.uniform(-1, 1, (2, h, h, cin)).astype(np.float32),
            rng.normal(0, 0.5, (3, 3, 1, cin)).astype(np.float32),
            rng.normal(0, 0.2, (cin,)).astype(np.float32),
            rng.normal(0, 0.3, (cin, cout)).astype(np.float32),
            rng.normal(0, 5.0, (cout,)).astype(np.float32))  # a bias that would show
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = separable_block(*(torch.from_numpy(a).to(tdt) for a in arrs), stride, True,
                          pw_epilogue=False)
    want = separable_block_pallas(*(jnp.asarray(a, jdt) for a in arrs), stride, True,
                                  interpret=True, pw_epilogue=False)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.min() < 0 or want.min() >= 0  # no activation on the partial
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_raw_partial_is_the_block_before_its_epilogue():
    rng = np.random.default_rng(5)
    t = [torch.from_numpy(a) for a in (
        rng.uniform(-1, 1, (1, 6, 6, 16)).astype(np.float32),
        rng.normal(0, 0.5, (3, 3, 1, 16)).astype(np.float32),
        rng.normal(0, 0.2, (16,)).astype(np.float32),
        rng.normal(0, 0.3, (16, 24)).astype(np.float32),
        rng.normal(0, 0.2, (24,)).astype(np.float32))]
    raw = separable_block_plain(*t, 1, True, pw_epilogue=False)
    full = separable_block_plain(*t, 1, True)
    torch.testing.assert_close((raw + t[4]).clamp(0, 6), full, rtol=0, atol=0)


# -- tensor parallelism through the separable block ----------------------------


@pytest.fixture(scope="module")
def v1():
    """Port and JAX sides of V1 0.25-64: folded weights, the batch, the
    port's single-device logits."""
    jcfg = JaxConfig(alpha=0.25, resolution=RES)
    host = jax_fold_bn(jax_init_params(jcfg, seed=0), eps=jcfg.bn_eps)
    x = np.random.default_rng(0).uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    cfg = ModelConfig(0.25, RES, compute_dtype="float32")
    params = to_device(host, "cpu", torch.float32)
    single = mobilenet_v1.forward(params, torch.from_numpy(x), cfg, dw_backend="plain")
    return dict(jcfg=jcfg, host=host, x=x, cfg=cfg, params=params, single=single.numpy())


@pytest.fixture(scope="module")
def jax_tp_logits(v1):
    """JAX forward_tp_fused ("xla") at tp 2 (dp 4) and tp 4 (dp 2)."""
    out = {}
    for tp in (2, 4):
        mesh = jax_pmesh.make_mesh(8, model_parallel=tp)
        sharded = jax_tp.shard_params_tp_fused(v1["host"], mesh)
        out[tp] = np.asarray(jax.jit(lambda p, x: jax_tp.forward_tp_fused(
            p, x, v1["jcfg"], mesh, dw_backend="xla"))(sharded, jnp.asarray(v1["x"])))
    return out


def _fused_where_it_fits(cfg, tp):
    return tuple("fused" if (c // tp) % 8 == 0 else "xla" for c in tp_fused._block_cins(cfg))


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("backend", ["xla", "fused", "auto"])
def test_forward_tp_fused(v1, jax_tp_logits, dp, tp, backend):
    mesh = _cpu_mesh(dp * tp, tp)
    sharded = tp_fused.shard_params_tp_fused(v1["params"], mesh)
    route = _fused_where_it_fits(v1["cfg"], tp) if backend == "fused" else backend
    if backend == "fused":
        assert route.count("fused") >= 11
    out = tp_fused.forward_tp_fused(sharded, torch.from_numpy(v1["x"]), v1["cfg"], mesh,
                                    dw_backend=route)
    assert out.shape == (BATCH, v1["cfg"].num_classes) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jax_tp_logits[tp], **TP_TOL)
    np.testing.assert_allclose(out.numpy(), v1["single"], **TP_TOL)


def test_tp_auto_routing_rule():
    """"auto": fused where the shard holds >= 128 channels (the JAX rule),
    so at 1.0 the kernel runs blocks 4-12 at tp 2 and 6-12 at tp 4; at 0.25
    block 12 alone at tp 2 (256 channels) and no block at tp 4."""
    full = ModelConfig(1.0, 224)
    assert [i for i, r in enumerate(tp_fused.tp_routing(full, 2, "auto"))
            if r == "fused"] == list(range(4, 13))
    assert [i for i, r in enumerate(tp_fused.tp_routing(full, 4, "auto"))
            if r == "fused"] == list(range(6, 13))
    quarter = ModelConfig(0.25, 64)
    assert tp_fused.tp_routing(quarter, 2, "auto") == ("xla",) * 12 + ("fused",)
    assert set(tp_fused.tp_routing(quarter, 4, "auto")) == {"xla"}
    with pytest.raises(ValueError, match="dw_backend"):
        tp_fused.tp_routing(full, 2, "dw")


def test_tp_fused_narrow_shard_raises(v1):
    """A "fused" block whose shard the kernel cannot take raises; nothing
    moves to the plain route on its own."""
    mesh = _cpu_mesh(4, 4)
    sharded = tp_fused.shard_params_tp_fused(v1["params"], mesh)
    with pytest.raises(ValueError, match="multiple of 8"):
        tp_fused.forward_tp_fused(sharded, torch.from_numpy(v1["x"]), v1["cfg"], mesh,
                                  dw_backend="fused")


def test_tp_shards_and_specs(v1):
    mesh = _cpu_mesh(4, 2)
    sharded = tp_fused.shard_params_tp_fused(v1["params"], mesh)
    assert len(sharded) == 2 and len(sharded[0]) == 2
    full, half = v1["params"]["blocks"][3], sharded[1][1]["blocks"][3]
    cin = full["pw"]["w"].shape[0]
    torch.testing.assert_close(half["pw"]["w"], full["pw"]["w"][cin // 2:])
    torch.testing.assert_close(half["dw"]["w"], full["dw"]["w"][..., cin // 2:])
    torch.testing.assert_close(half["pw"]["b"], full["pw"]["b"])
    assert tp_fused.param_specs_tp_fused(v1["params"])["fc"]["w"] == (pmesh.MODEL_AXIS, None)
    with pytest.raises(ValueError, match="does not divide"):
        tp_fused.forward_tp_fused(sharded, torch.from_numpy(v1["x"][:3]), v1["cfg"], mesh,
                                  dw_backend="xla")


# -- int8 tensor parallelism ---------------------------------------------------


@pytest.fixture(scope="module")
def i8(v1):
    jcfg = v1["jcfg"]
    q = jax_qmodel.quantize_for_device(v1["host"], jcfg)
    jdev = jax_qmodel._as_device_tree(q)
    x_i8 = np.asarray(jax_quantize_input(jnp.asarray(v1["x"]), ACT_IN_SCALE))
    jax_out = {}
    for tp in (2, 4):
        mesh = jax_pmesh.make_mesh(8, model_parallel=tp)
        arrays, six = jax_qtp.shard_dev_i8_tp(jdev, mesh)
        # six_q stays a static Python float: closed over, as the JAX tests do
        jax_out[tp] = np.asarray(jax.jit(lambda a, x, six=six, mesh=mesh: jax_qtp.forward_i8_tp(
            a, six, x, jcfg, mesh))(arrays, jnp.asarray(x_i8)))
    dev = to_device_i8(quantize_for_device(v1["host"], v1["cfg"]), "cpu")
    x_t = torch.from_numpy(x_i8.copy())
    return dict(dev=dev, x=x_t, jax=jax_out,
                single=forward_i8(dev, x_t, v1["cfg"], dw_backend="plain"))


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_forward_i8_tp_bit_equal(v1, i8, dp, tp):
    mesh = _cpu_mesh(dp * tp, tp)
    arrays, six = qtp.shard_dev_i8_tp(i8["dev"], mesh)
    out = qtp.forward_i8_tp(arrays, six, i8["x"], v1["cfg"], mesh)
    assert torch.equal(out, i8["single"])
    np.testing.assert_array_equal(out.numpy(), i8["jax"][tp])


# -- data-parallel pipelines ---------------------------------------------------


def _images(res, n=4, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, res, res, 3), dtype=np.uint8)


@pytest.mark.parametrize("cfg", [ModelConfig(0.25, 64), V2Config(0.35, 64),
                                 V3Config("small", 1.0, 64)], ids=["v1", "v2", "v3small"])
def test_dp_pipeline_float(cfg):
    imgs = _images(cfg.resolution)
    one = InferencePipeline(cfg, device="cpu", dtype=torch.float32)
    dp = InferencePipeline(cfg, dtype=torch.float32, mesh=_cpu_mesh(2))
    np.testing.assert_allclose(dp.run_batch(imgs), one.run_batch(imgs), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="does not divide"):  # one image, two ranks
        dp.classify(imgs[0])
    assert dp._replicas[1]["conv1"]["w"].data_ptr() != dp.params["conv1"]["w"].data_ptr()
    torch.testing.assert_close(dp._replicas[1]["conv1"]["w"], dp.params["conv1"]["w"])


def test_dp_pipeline_float_taps():
    """run_preprocessed and the per-layer taps split and gather as well."""
    cfg = ModelConfig(0.25, 64)
    x = np.random.default_rng(4).uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    one = InferencePipeline(cfg, device="cpu", dtype=torch.float32)
    dp = InferencePipeline(cfg, dtype=torch.float32, mesh=_cpu_mesh(2))
    torch.testing.assert_close(dp.run_preprocessed(x), one.run_preprocessed(x))
    lg, acts = dp.activations(x)
    lg1, acts1 = one.activations(x)
    np.testing.assert_allclose(lg, lg1, atol=1e-5, rtol=0)
    assert set(acts) == set(acts1)
    np.testing.assert_allclose(acts["block12_pw"], acts1["block12_pw"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", ["v1", "v2", "v3small"])
def test_dp_pipeline_int8_exact(family):
    imgs = _images(64 if family == "v1" else 96)
    if family == "v1":
        one = Int8Pipeline(ModelConfig(0.25, 64), device="cpu")
        dp = Int8Pipeline(ModelConfig(0.25, 64), mesh=_cpu_mesh(2))
    else:
        cls, cfg = ((Int8PipelineV2, V2Config(0.35, 96)) if family == "v2"
                    else (Int8PipelineV3, V3Config("small", 1.0, 96)))
        one = cls(cfg, device="cpu")
        dp = cls(cfg, quantized=one.q, mesh=_cpu_mesh(2))
    np.testing.assert_array_equal(dp.run_batch(imgs), one.run_batch(imgs))


@pytest.mark.parametrize("max_batch,dp", [(64, 1), (64, 2), (8, 4), (32, 8), (6, 4)])
def test_default_buckets_with_a_mesh(max_batch, dp):
    jm = jax_pmesh.make_mesh(dp, model_parallel=1)
    want = jax_default_buckets(max_batch, jm)
    assert default_buckets(max_batch, _cpu_mesh(dp)) == want
    assert default_buckets(max_batch) == jax_default_buckets(max_batch)


def test_meshes_refused():
    with pytest.raises(ValueError, match="data-parallel only"):
        InferencePipeline(ModelConfig(0.25, 64), mesh=_cpu_mesh(4, 2))
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pmesh.make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_mesh(6, model_parallel=4, devices=["cpu"] * 6)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            pmesh.make_mesh(2)
    mesh = _cpu_mesh(4, 2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4


def test_psum_in_rank_order():
    """(1e8 + 1) - 1e8 in float32 is 0; another order would give 1."""
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    out = pmesh.psum(parts)
    assert len(out) == 3 and out[0].item() == 0.0 and out[2] is out[0]


def test_dp_server_selftest():
    pipe = InferencePipeline(ModelConfig(0.25, 64), mesh=_cpu_mesh(2))
    server, _ = build_server({"v": ModelConfig(0.25, 64)}, 8, mesh=pipe.mesh)
    assert server.batch_buckets == [2, 8]
    import asyncio  # noqa: PLC0415

    async def run():
        await server.start()
        try:
            return await selftest(server, streams=8, requests_per_stream=2)
        finally:
            await server.close()

    stats = asyncio.run(run())
    assert stats["errors"] == 0 and stats["requests"] == 16


def test_cli_dp(capsys):
    args = ["--alpha", "0.25", "--res", "64", "--device", "cpu", "--streams", "4"]
    cli_main(["serve", "--dp", "2", *args])
    out = capsys.readouterr().out
    assert '"errors": 0' in out and '"4": ' in out
    cli_main(["warmup", "--dp", "2", *args])
    assert "batches=[2, 4]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="multiple of --dp"):
        cli_main(["serve", "--dp", "3", *args])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="make_mesh: need 2 devices"):
            cli_main(["serve", "--dp", "2", "--alpha", "0.25", "--res", "64"])
