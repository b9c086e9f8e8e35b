"""Measured routing in the port: V1's "mixed" routes (float and int8) against
the JAX package, `runtime/autotune.autotune_backend` on the CPU (its default
candidate sets pinned for the card by a pure function), each candidate timed
on its own pipeline's weights, and the `bench`, `sweep` and `autotune`
commands' flags, rows and refusals (the pipelines' benchmark replaced, since
it times the card)."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu import cli as jax_cli
from mobilenet_tpu.checkpoints import fold_bn as jax_fold_bn
from mobilenet_tpu.checkpoints import init_params as jax_init_params
from mobilenet_tpu.checkpoints import to_device as jax_to_device
from mobilenet_tpu.models import mobilenet_v1 as jax_v1
from mobilenet_tpu.quant import model as jax_qmodel
from mobilenet_tpu.quant import quantize as jax_quantize
from mobilenet_tpu.quant import quantize_input
from mobilenet_tpu_torch import V2Config, V3Config, cli
from mobilenet_tpu_torch import ModelConfig
from mobilenet_tpu_torch.checkpoints import default_folded, from_jax_params
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.quant import model as qmodel
from mobilenet_tpu_torch.quant import quantize
from mobilenet_tpu_torch.quant import v2 as qv2
from mobilenet_tpu_torch.quant import v3 as qv3
from mobilenet_tpu_torch.runtime import autotune, serving

RES = 64
CFG, JCFG = ModelConfig(0.25, RES), JaxConfig(0.25, RES)
TO_PORT = {"xla": "plain", "pallas": "dw", "fused": "fused"}
# The float32 routing gate of runtime/eval.verify_routing (the JAX package's
# cli._verify_routing): the fused blocks' sums differ in order only.
F32_TOL = dict(atol=2e-4, rtol=2e-3)


def _port(route):
    return tuple(TO_PORT[r] for r in route)


@pytest.fixture(scope="module")
def folded():
    return jax_fold_bn(jax_init_params(JCFG, 11), eps=JCFG.bn_eps)


@pytest.fixture(scope="module")
def x_f32():
    return np.random.default_rng(25).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_mixed_routing_matches_jax(batch):
    """"mixed" resolves to the JAX tuple with "xla" named "plain", float and
    int8; "auto" stays fused at every batch (the JAX "auto" is "mixed" below
    batch 8 on the TPU)."""
    want = _port(jax_v1._routing(JCFG, False, "mixed", batch))
    assert want == ("plain",) * 2 + ("fused",) * 11
    assert mobilenet_v1._routing(CFG, "mixed", batch) == want
    assert qmodel.resolve_i8_routing(13, "mixed") == _port(
        jax_qmodel._routing_i8(JCFG, "mixed", batch))
    assert qmodel._routing_i8(CFG, "mixed", batch) == want
    assert mobilenet_v1._routing(CFG, "auto", batch) == ("fused",) * 13
    assert qmodel._routing_i8(CFG, "auto", batch) == ("fused",) * 13


def test_v2_v3_int8_refuse_mixed():
    """The JAX package's V2 and V3 int8 routes are all or nothing (a bool)."""
    with pytest.raises(ValueError, match="MobileNet-V1"):
        qv2._routing_v2_i8(V2Config(0.35, 32), "mixed", 1)
    with pytest.raises(ValueError, match="MobileNet-V1"):
        qv3._routing_v3_i8(V3Config("small", 0.75, 64), "mixed", 1)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(mobilenet_v1, name)

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return real(x, *a, **k)

    monkeypatch.setattr(mobilenet_v1, name, spy)
    return calls


@pytest.mark.parametrize("batch", [2, 1])
def test_mixed_forward_vs_jax(monkeypatch, folded, x_f32, batch):
    """The port's float32 "mixed" forward (the kernels' plain versions on the
    CPU) within the routing gate of the JAX "mixed" forward (its Pallas
    kernels in interpret mode): the stem is the plain convolution, blocks
    2-12 the separable kernel, and at batch 1 blocks 6-10 one chain."""
    x = x_f32[:batch]
    ref = np.asarray(jax_v1.forward(jax_to_device(folded), jnp.asarray(x), JCFG,
                                    dw_backend="mixed"))
    params = from_jax_params(folded, "cpu", torch.float32, CFG.block_strides)
    stem, sep = _spy(monkeypatch, "stem_conv"), _spy(monkeypatch, "separable_block")
    chain = _spy(monkeypatch, "chain")
    got = mobilenet_v1.forward(params, torch.from_numpy(x), CFG, dw_backend="mixed")
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)
    assert stem == []
    assert (len(sep), len(chain)) == ((6, 1) if batch == 1 else (11, 0))


def test_mixed_int8_vs_jax(folded, x_f32):
    """The int8 "mixed" logits equal the JAX use_fused="mixed" route's bit
    for bit (its fused int8 kernels in interpret mode)."""
    x_i8 = quantize_input(x_f32)
    q = jax_quantize(folded, JCFG)
    ref = jax_qmodel.forward_i8(jax_qmodel._as_device_tree(q), jnp.asarray(x_i8), JCFG,
                                use_fused="mixed")
    dev = qmodel.to_device_i8(quantize(folded, CFG), "cpu")
    got = qmodel.forward_i8(dev, torch.from_numpy(x_i8), CFG, dw_backend="mixed")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_pipeline_mixed_pads_as_fused():
    """quantize_for_device pads for "mixed" as for any spec but "plain" (the
    JAX package's rule), and the padded "mixed" route equals the unpadded
    plain route bit for bit."""
    cfg = ModelConfig(0.75, RES)
    imgs = np.random.default_rng(3).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    mixed = qmodel.Int8Pipeline(cfg, device="cpu", seed=2, dw_backend="mixed")
    plain = qmodel.Int8Pipeline(cfg, device="cpu", seed=2, dw_backend="plain")
    assert mixed.dev["conv1"]["w"].shape[-1] == 32
    assert plain.dev["conv1"]["w"].shape[-1] == 24
    np.testing.assert_array_equal(mixed.run_batch(imgs), plain.run_batch(imgs))


# -- autotune_backend ------------------------------------------------------------------------


def test_default_candidates_pinned():
    """The card's sets are the JAX package's on-TPU sets, names mapped; off
    the card "plain" alone, as the JAX package races ("xla",) off the TPU."""
    dc = autotune.default_candidates
    assert dc("v1", False, "throughput", True) == ("plain", "dw", "fused", "mixed")
    assert dc("v1", False, "latency", True) == ("plain", "dw", "fused", "mixed")
    assert dc("v1", True, "throughput", True) == ("plain", "fused", "mixed")
    assert dc("v1", True, "latency", True) == ("plain", "fused", "mixed")
    for fam in ("v2", "v3"):
        assert dc(fam, False, "latency", True) == ("plain", "fused", "mixed")
        assert dc(fam, False, "throughput", True) == ("plain", "fused")
        assert dc(fam, True, "latency", True) == ("plain", "fused")
        assert dc(fam, True, "throughput", True) == ("plain", "fused")
    for fam in ("v1", "v2", "v3"):
        for int8 in (False, True):
            for mode in ("throughput", "latency"):
                assert dc(fam, int8, mode, False) == ("plain",)


_SMALL = {"v1": ModelConfig(0.25, 64, compute_dtype="float32"),
          "v2": V2Config(0.35, 32, compute_dtype="float32"),
          "v3": V3Config("small", 0.75, 64, compute_dtype="float32")}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", ["v1", "v2", "v3"])
def test_autotune_on_cpu(monkeypatch, family, int8):
    """On the CPU the race is ("plain",), in both modes: a finite img/s at
    batch 2 and a finite ms from differenced chains at batch 1 (chains of 1
    and 4 forwards here), and "plain" wins."""
    monkeypatch.setattr(autotune, "CHAIN_LEN", 1)
    cfg = _SMALL[family]
    for batch in (2, 1):
        best, res = autotune.autotune_backend(cfg, batch_size=batch, steps=1, int8=int8,
                                              device="cpu")
        assert best == "plain" and list(res) == ["plain"]
        assert np.isfinite(res["plain"]) and res["plain"] > 0


@pytest.mark.parametrize("mode", ["throughput", "latency"])
def test_each_candidate_on_its_own_pipeline(monkeypatch, mode):
    """Padding is bit-neutral, not time-neutral: "plain" is timed on the
    unpadded tree it ships with, "fused" on the padded one (alpha 0.75:
    a 24-channel stem padded to 32), each on a pipeline of its own route."""
    seen = {}

    def fake(cand, pipe, m, batch_size, steps, int8):
        assert m == mode
        seen[cand] = (pipe.dw_backend, pipe.dev["conv1"]["w"].shape[-1])
        return 1.0

    monkeypatch.setattr(autotune, "_measure", fake)
    autotune.autotune_backend(ModelConfig(0.75, RES), batch_size=4, mode=mode, int8=True,
                              candidates=("plain", "fused"), device="cpu")
    assert seen == {"plain": ("plain", 24), "fused": ("fused", 32)}


def test_float_candidates_and_calibrated_once(monkeypatch):
    """Float candidates each get an InferencePipeline with their dw_backend;
    V2 int8 candidates share one calibrated tree (calibration does not
    depend on the route)."""
    seen, trees = {}, []

    def fake(cand, pipe, mode, batch_size, steps, int8):
        (trees if int8 else seen.setdefault("float", [])).append(
            (cand, pipe.dw_backend, pipe.q) if int8 else (cand, pipe.dw_backend))
        return {"plain": 3.0, "fused": 2.0, "mixed": float("nan")}[cand]

    monkeypatch.setattr(autotune, "_measure", fake)
    best, res = autotune.autotune_backend(CFG, batch_size=1, device="cpu",
                                          candidates=("plain", "fused", "mixed"))
    assert seen["float"] == [("plain", "plain"), ("fused", "fused"), ("mixed", "mixed")]
    assert best == "fused"  # the NaN is never crowned
    assert res["mixed"] != res["mixed"]
    cfg = _SMALL["v2"]
    params = default_folded(cfg, seed=0)
    best, _ = autotune.autotune_backend(cfg, batch_size=4, int8=True, params=params,
                                        device="cpu", candidates=("plain", "fused"))
    assert [t[:2] for t in trees] == [("plain", "plain"), ("fused", "fused")]
    assert trees[0][2] is trees[1][2]
    assert best == "plain"  # throughput: the highest wins


def test_no_finite_value_crowns_nothing(monkeypatch):
    monkeypatch.setattr(autotune, "_measure", lambda *a: float("nan"))
    best, res = autotune.autotune_backend(CFG, batch_size=1, device="cpu",
                                          candidates=("plain", "fused"))
    assert best is None and list(res) == ["plain", "fused"]


# -- the commands ------------------------------------------------------------------------------


class _StubPipe:
    """Stands in for a pipeline whose benchmark() would time the card."""

    def __init__(self, cfg, int8, log):
        self.config, self.int8, self.dw_backend = cfg, int8, "auto"
        log.append((cfg.variant_name(), int8))

    def benchmark(self, batch_size=256, steps=40):
        return {"images_per_sec": 1234.56, "batch_size": batch_size, "steps": steps,
                "p50_latency_ms": 0.98765, "p99_latency_ms": 1.5}


@pytest.fixture
def stub_card(monkeypatch):
    """The card's checks passed and every pipeline a _StubPipe; returns the
    log of (variant, int8) built."""
    log = []
    monkeypatch.setattr(cli, "_require_card", lambda args: None)
    monkeypatch.setattr(serving, "build_pipeline",
                        lambda cfg, int8=False, **kw: _StubPipe(cfg, int8, log))
    return log


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_sweep_rows_in_jax_order(stub_card, capsys, monkeypatch):
    """`sweep` prints one row per grid point in the JAX package's order, with
    its keys and variant names (the JAX command run with the same stub)."""
    argv = ["--alphas", "0.25,0.5", "--resolutions", "128,160", "--steps", "3"]
    cli.main(["sweep", *argv])
    got = _lines(capsys)

    class JaxStub:
        def __init__(self, cfg, seed=0):
            self.config = cfg

        benchmark = _StubPipe.benchmark

    import mobilenet_tpu.runtime.pipeline as jax_pipeline

    monkeypatch.setattr(jax_pipeline, "InferencePipeline", JaxStub)
    jax_cli.main(["sweep", *argv])
    assert got == _lines(capsys)
    assert [r["variant"] for r in got] == [
        "mobilenet_v1_0.25_128", "mobilenet_v1_0.25_160",
        "mobilenet_v1_0.5_128", "mobilenet_v1_0.5_160"]
    assert got[0] == {"variant": "mobilenet_v1_0.25_128", "images_per_sec": 1234.6,
                      "p50_latency_ms": 0.988}


def test_sweep_default_grids():
    """The default grids are the JAX package's: V1 ALPHAS x RESOLUTIONS, V2
    V2_ALPHAS, V3 (0.75, 1.0), each over RESOLUTIONS."""
    from mobilenet_tpu.config import ALPHAS, RESOLUTIONS
    from mobilenet_tpu.models.mobilenet_v2 import V2_ALPHAS

    def grid(model):
        return cli._sweep_grid(types.SimpleNamespace(model=model, alphas=None,
                                                     resolutions=None))

    assert grid("v1") == [(a, r) for a in ALPHAS for r in RESOLUTIONS]
    assert grid("v2") == [(a, r) for a in V2_ALPHAS for r in RESOLUTIONS]
    for m in ("v3", "v3small"):
        assert grid(m) == [(a, r) for a in (0.75, 1.0) for r in RESOLUTIONS]


def test_sweep_int8_rows(stub_card, capsys):
    cli.main(["sweep", "--int8", "--model", "v2", "--alphas", "0.35", "--resolutions",
              "96,128", "--batch", "8", "--steps", "2", "--seed", "1"])
    rows = _lines(capsys)
    assert stub_card == [("mobilenet_v2_0.35_96", True), ("mobilenet_v2_0.35_128", True)]
    assert rows[0] == {"variant": "mobilenet_v2_0.35_96", "dtype": "int8",
                       "images_per_sec": 1234.6, "batch_size": 8, "steps": 2,
                       "backend": "cuda"}
    cli.main(["sweep", "--int8", "--alphas", "0.25", "--resolutions", "128"])
    assert set(_lines(capsys)[0]) == {"variant", "dtype", "images_per_sec", "batch_size",
                                      "steps"}


def test_bench_int8_and_profile(stub_card, capsys, tmp_path):
    """`bench --int8` takes the JAX flags and prints the int8 pipeline's
    benchmark(); --profile DIR writes a trace file and names DIR."""
    cli.main(["bench", "--int8", "--model", "v3small", "--minimalistic", "--alpha", "1.0",
              "--res", "96", "--batch", "4", "--steps", "3", "--seed", "2",
              "--profile", str(tmp_path)])
    (line,) = _lines(capsys)
    assert stub_card == [("mobilenet_v3_small_min_1_96", True)]
    assert line["dtype"] == "int8" and line["backend"] == "cuda"
    assert line["variant"] == "mobilenet_v3_small_min_1_96"
    assert (line["batch_size"], line["steps"]) == (4, 3)
    assert line["profile_dir"] == str(tmp_path)
    assert list(tmp_path.glob("trace_*.json"))
    cli.main(["bench", "--alpha", "0.25", "--res", "128", "--dtype", "float32"])
    (line,) = _lines(capsys)
    assert (line["dtype"], line["dw_backend"], line["steps"]) == ("float32", "auto", 40)


@pytest.mark.parametrize("cmd", ["bench", "sweep"])
def test_bench_sweep_refuse_the_cpu(monkeypatch, cmd):
    """bench and sweep time the card: --device cpu exits non-zero before
    any pipeline is built or timed."""
    monkeypatch.setattr(serving, "build_pipeline", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--device", "cpu", "--alpha", "0.25", "--res", "128"])
    assert e.value.code not in (0, None) and "refused" in str(e.value.code)


def test_cli_autotune(monkeypatch, capsys):
    """`autotune` prints variant, dtype, batch, best and each candidate's
    img/s (or, at --batch 1, latency_ms), rounded as the JAX command."""
    cli.main(["autotune", "--device", "cpu", "--alpha", "0.25", "--res", "64",
              "--dtype", "float32", "--batch", "2", "--steps", "1"])
    (line,) = _lines(capsys)
    assert set(line) == {"variant", "dtype", "batch", "best", "images_per_sec"}
    assert line["best"] == "plain" and line["images_per_sec"]["plain"] > 0
    monkeypatch.setattr(autotune, "_measure", lambda cand, *a: 0.123456)
    cli.main(["autotune", "--device", "cpu", "--int8", "--model", "v1", "--alpha",
              "0.25", "--res", "64", "--batch", "1", "--seed", "3"])
    (line,) = _lines(capsys)
    assert line == {"variant": "mobilenet_v1_0.25_64", "dtype": "int8", "batch": 1,
                    "best": "plain", "latency_ms": {"plain": 0.1235}}
