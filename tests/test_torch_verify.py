"""The port's verify entry point and what it stands on, against the JAX
package: the golden tolerances and `routing_bf16_atol`, the NumPy V1 oracle
(`forward_all`, `preprocess_ref`), the C++ oracle `cpu_ref` (the port's
copy of the source, built into build/cpu_ref/) layer by layer and end to
end, bit for bit; MobileNet-V1's "dw" route (the depthwise kernel's plain
version on the CPU) against the JAX "pallas" route; the "fused" collect
against the plain taps; and `cli verify` on the CPU over the matrix of
models, oracles, int8 and routings, with a planted fault that fails."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import cpu_ref as jax_cpu_ref
from mobilenet_tpu.config import ModelConfig as JaxModelConfig
from mobilenet_tpu.models import mobilenet_v1 as jax_v1
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu.oracle import numpy_ref as jax_numpy_ref
from mobilenet_tpu.utils import golden as jax_golden
from mobilenet_tpu_torch import InferencePipeline, ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch import cpu_ref
from mobilenet_tpu_torch.checkpoints import (
    fold_bn, fold_bn_v2, fold_bn_v3, init_params, init_params_v2, init_params_v3, to_device,
)
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.oracle import numpy_ref
from mobilenet_tpu_torch.utils import golden

V1 = ModelConfig(0.25, 96)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the C++ oracle cannot be built")


def _x(seed, n, res, c=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, c)).astype(np.float32)


def _v1_folded(cfg=V1, seed=0):
    return fold_bn(init_params(cfg, seed=seed), eps=cfg.bn_eps)


def test_golden_constants_equal_jax():
    for name in ("DW_TOL", "MM_TOL", "V2_TOL", "V3_TOL", "ROUTING_BF16_ATOL",
                 "ROUTING_BF16_REL", "ROUTING_EV_FACTOR", "ROUTING_ANCHOR_FACTOR"):
        assert getattr(golden, name) == getattr(jax_golden, name), name
    for args in ((1.0, 0.01, 10), (41.5, 0.3, 256000), (0.5, 0.0, 1), (3.0, 0.05, 2000)):
        assert golden.routing_bf16_atol(*args) == jax_golden.routing_bf16_atol(*args)
    a = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    b = np.nextafter(a, np.float32(np.inf))
    assert golden.max_ulp_diff(a, b) == jax_golden.max_ulp_diff(a, b) == 1


def test_compare_activations_equals_jax():
    rng = np.random.default_rng(1)
    ref = {"conv1": rng.normal(size=(2, 4)).astype(np.float32),
           "block00_dw": rng.normal(size=(3,)).astype(np.float32)}
    got = {k: v + np.float32(2e-4) for k, v in ref.items()}
    ours, theirs = golden.compare_activations(got, ref), jax_golden.compare_activations(got, ref)
    assert [str(r) for r in ours] == [str(r) for r in theirs]
    assert [r.ok for r in ours] == [False, False]
    assert golden.first_divergence(ours).name == "conv1"
    with pytest.raises(AssertionError, match="first divergence at conv1"):
        golden.assert_all_match(ours)


def test_numpy_forward_all_equals_jax():
    cfg = ModelConfig(0.25, 128)
    folded, x = _v1_folded(cfg), _x(2, 2, 128)
    logits, acts = numpy_ref.forward_all(folded, x, cfg)
    jlogits, jacts = jax_numpy_ref.forward_all(folded, x, JaxModelConfig(0.25, 128))
    assert list(acts) == list(jacts)
    for name, want in jacts.items():
        np.testing.assert_array_equal(acts[name], want, err_msg=name)
    np.testing.assert_array_equal(logits, jlogits)
    img = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    np.testing.assert_array_equal(numpy_ref.preprocess_ref(img), jax_numpy_ref.preprocess_ref(img))


def test_cpu_ref_layers_equal_jax():
    """Every float and int8 entry of the C++ oracle equals the JAX
    package's build of the same source, bit for bit."""
    _need_gxx()
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (2, 9, 10, 8)).astype(np.float32)
    b8 = rng.normal(size=(8,)).astype(np.float32)
    for stride in (1, 2):
        w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
        b16 = rng.normal(size=(16,)).astype(np.float32)
        dw = rng.normal(size=(3, 3, 1, 8)).astype(np.float32)
        dw5 = rng.normal(size=(5, 5, 1, 8)).astype(np.float32)
        pairs = [
            (cpu_ref.conv3x3(x, w, b16, stride, True), jax_cpu_ref.conv3x3(x, w, b16, stride, True)),
            (cpu_ref.dw3x3(x, dw, b8, stride, False), jax_cpu_ref.dw3x3(x, dw, b8, stride, False)),
            (cpu_ref.conv3x3a(x, w, b16, stride, "hswish"),
             jax_cpu_ref.conv3x3a(x, w, b16, stride, "hswish")),
            (cpu_ref.dwk(x, dw5, b8, stride, "relu"), jax_cpu_ref.dwk(x, dw5, b8, stride, "relu")),
        ]
        for got, want in pairs:
            np.testing.assert_array_equal(got, want)
    pw_w = rng.normal(size=(8, 12)).astype(np.float32)
    b12 = rng.normal(size=(12,)).astype(np.float32)
    np.testing.assert_array_equal(cpu_ref.pw(x, pw_w, b12, apply_act=False),
                                  jax_cpu_ref.pw(x, pw_w, b12, apply_act=False))
    np.testing.assert_array_equal(cpu_ref.pwa(x, pw_w, None, "hsigmoid"),
                                  jax_cpu_ref.pwa(x, pw_w, None, "hsigmoid"))
    np.testing.assert_array_equal(cpu_ref.avgpool(x), jax_cpu_ref.avgpool(x))
    fc_w = rng.normal(size=(8, 5)).astype(np.float32)
    np.testing.assert_array_equal(cpu_ref.fc(x[:, 0, 0], fc_w, b8[:5]),
                                  jax_cpu_ref.fc(x[:, 0, 0], fc_w, b8[:5]))
    xi = rng.integers(-128, 128, (2, 9, 10, 8)).astype(np.int8)
    m8 = rng.uniform(1e-3, 5e-3, (8,)).astype(np.float32)
    bi8 = rng.integers(-3000, 3000, (8,)).astype(np.int32)
    wi = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    m16 = rng.uniform(1e-4, 1e-3, (16,)).astype(np.float32)
    bi16 = rng.integers(-3000, 3000, (16,)).astype(np.int32)
    dwi = rng.integers(-127, 128, (3, 3, 1, 8)).astype(np.int8)
    pwi = rng.integers(-127, 128, (8, 16)).astype(np.int8)
    s_out = np.float32(6.0 / 127.0)
    for stride in (1, 2):
        np.testing.assert_array_equal(cpu_ref.conv3x3_i8(xi, wi, bi16, m16, s_out, stride),
                                      jax_cpu_ref.conv3x3_i8(xi, wi, bi16, m16, s_out, stride))
        np.testing.assert_array_equal(cpu_ref.dw3x3_i8(xi, dwi, bi8, m8, s_out, stride),
                                      jax_cpu_ref.dw3x3_i8(xi, dwi, bi8, m8, s_out, stride))
    np.testing.assert_array_equal(cpu_ref.pw_i8(xi, pwi, bi16, m16, s_out, False),
                                  jax_cpu_ref.pw_i8(xi, pwi, bi16, m16, s_out, False))
    assert cpu_ref.library_path().parent.name == "cpu_ref"
    assert cpu_ref.library_path().parent.parent.name == "build"


@pytest.mark.parametrize("family", ["v1", "v2", "v3small"])
def test_cpu_ref_forward_all_equals_jax(family):
    """The C++ oracle's three forwards equal the JAX package's, tap for
    tap, bit for bit."""
    _need_gxx()
    if family == "v1":
        cfg, jcfg, fwd = V1, JaxModelConfig(0.25, 96), "forward_all"
        folded = _v1_folded()
    elif family == "v2":
        cfg, jcfg, fwd = V2Config(0.35, 64), JaxV2Config(0.35, 64), "forward_all_v2"
        folded = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
    else:
        cfg, jcfg, fwd = V3Config("small", 1.0, 64), JaxV3Config("small", 1.0, 64), \
            "forward_all_v3"
        folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    x = _x(4, 2, cfg.resolution)
    logits, acts = getattr(cpu_ref, fwd)(folded, x, cfg)
    jlogits, jacts = getattr(jax_cpu_ref, fwd)(folded, x, jcfg)
    assert list(acts) == list(jacts)
    for name, want in jacts.items():
        np.testing.assert_array_equal(acts[name], want, err_msg=name)
    np.testing.assert_array_equal(logits, jlogits)


def test_v1_dw_route_vs_jax_pallas_route():
    """MobileNet-V1 float32: the port's "dw" route (the depthwise kernel's
    plain version, then the plain pointwise) against the JAX "pallas" route
    (depthwise_conv_pallas in interpret mode), logits within MM_TOL."""
    cfg = ModelConfig(0.25, 64)
    folded, x = _v1_folded(cfg, 1), _x(5, 2, 64)
    params = to_device(folded, "cpu", torch.float32)
    got = mobilenet_v1.forward(params, torch.from_numpy(x), cfg, dw_backend="dw").numpy()
    want = np.asarray(jax_v1.forward(folded, jnp.asarray(x), JaxModelConfig(0.25, 64),
                                     dw_backend="pallas"))
    np.testing.assert_allclose(got, want, atol=golden.MM_TOL[0], rtol=golden.MM_TOL[1])


def test_fused_collect_taps_equal_plain_taps():
    """collect=True on a "fused" (and a "dw") pipeline takes the depthwise
    taps from the depthwise kernel; on CPU tensors that is its plain
    version, the plain taps' function in float32: every tap equal."""
    folded, x = _v1_folded(), _x(6, 2, 96)
    _, plain = InferencePipeline(V1, folded, device="cpu", dw_backend="plain").activations(x)
    for route in ("fused", "dw"):
        _, acts = InferencePipeline(V1, folded, device="cpu", dw_backend=route).activations(x)
        assert list(acts) == list(plain)
        for name, want in plain.items():
            np.testing.assert_array_equal(acts[name], want, err_msg=f"{route} {name}")


CLI_RUNS = {
    "v1-cpp": ["--alpha", "0.25", "--res", "96"],
    "v1-numpy": ["--alpha", "0.25", "--res", "96", "--oracle", "numpy"],
    "v1-int8-cpp": ["--alpha", "0.25", "--res", "96", "--int8"],
    "v1-int8-numpy": ["--alpha", "0.25", "--res", "96", "--int8", "--oracle", "numpy"],
    "v1-dw": ["--alpha", "0.25", "--res", "96", "--routing", "dw"],
    "v1-fused": ["--alpha", "0.25", "--res", "96", "--routing", "fused"],
    "v1-mixed-bf16": ["--alpha", "0.25", "--res", "96", "--routing", "mixed",
                      "--dtype", "bfloat16"],
    "v2": ["--model", "v2", "--alpha", "0.35", "--res", "64"],
    "v3": ["--model", "v3", "--res", "64"],
    "v3small": ["--model", "v3small", "--res", "64"],
    "v3small-int8": ["--model", "v3small", "--res", "64", "--int8"],
}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_verify_on_cpu(run, capsys):
    if "--oracle" not in CLI_RUNS[run]:
        _need_gxx()
    cli_main(["verify", *CLI_RUNS[run], "--device", "cpu"])
    out = capsys.readouterr().out
    want = ("ROUTING VERIFY OK" if "--routing" in CLI_RUNS[run]
            else "INT8 VERIFY OK" if "--int8" in CLI_RUNS[run] else "VERIFY OK: all")
    assert want in out and "FAIL" not in out


def test_cli_verify_fails_a_planted_fault(monkeypatch, capsys):
    """One wrong tap (block 3's pointwise output moved by 1e-3) makes the
    per-layer gate fail there and exit 1."""
    real = mobilenet_v1.ops.pointwise_conv
    calls = []

    def planted(x, w, **kw):
        y = real(x, w, **kw)
        calls.append(1)
        return y + 1e-3 if len(calls) == 4 else y

    monkeypatch.setattr(mobilenet_v1.ops, "pointwise_conv", planted)
    with pytest.raises(SystemExit) as exc:
        cli_main(["verify", "--alpha", "0.25", "--res", "96", "--oracle", "numpy",
                  "--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "VERIFY FAILED at block03_pw" in out and "[FAIL] block03_pw" in out


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_verify_layers_fails_an_unpaired_tap(fault, monkeypatch, capsys):
    """A tap the route does not produce, or one the oracle lacks, fails the
    per-layer gate there (VERIFY FAILED at <tap>), with no traceback."""
    from mobilenet_tpu_torch.runtime import eval as teval
    from mobilenet_tpu_torch.runtime import pipeline as tpipeline

    real = tpipeline.InferencePipeline.activations

    def unpaired(self, x):
        logits, acts = real(self, x)
        if fault == "missing":
            del acts["block05_dw"]
        else:
            acts["block99_dw"] = acts["block05_dw"]
        return logits, acts

    monkeypatch.setattr(tpipeline.InferencePipeline, "activations", unpaired)
    assert not teval.verify_layers(V1, _v1_folded(), _x(3, 1, V1.resolution), device="cpu")
    tap = "block05_dw" if fault == "missing" else "block99_dw"
    out = capsys.readouterr().out
    assert f"VERIFY FAILED at {tap}" in out and f"[FAIL] {tap}" in out


def test_cli_verify_rejects_dw_on_v2():
    with pytest.raises(SystemExit, match="MobileNet-V1 routing"):
        cli_main(["verify", "--model", "v2", "--alpha", "0.35", "--res", "64", "--routing",
                  "dw", "--device", "cpu"])
