"""The floor probes' plain versions (which their wrappers run on CPU tensors)
against the JAX package's probe kernels (tools/microbench_floors.py) through
`pl.pallas_call(..., interpret=True)` at a small tile, and the port's
roofline floors against tools/roofline.py's with the same rates in its
globals."""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mobilenet_tpu import ModelConfig as JaxModelConfig
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu_torch import floors, roofline

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_floors():
    return _load("microbench_floors")


@pytest.fixture(scope="module")
def jax_roofline():
    return _load("roofline")


def _stencil_pallas(mod, x, w, reps, variant):
    n, h, wd, c = x.shape
    kern = functools.partial(mod._stencil_kernel, reps=reps, h=h, w=wd, variant=variant)
    return pl.pallas_call(
        kern, grid=(n,),
        in_specs=[pl.BlockSpec((1, h, wd, c), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((3, 3, c), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, h, wd, c), lambda i: (i, 0, 0, 0)),
        out_shape=jnp.zeros((n, h, wd, c), jnp.bfloat16), interpret=True)(x, w)


@pytest.mark.parametrize("variant", floors.VARIANTS)
def test_stencil_vs_pallas(jax_floors, variant):
    """Each variant at an 8x8x16 tile (two tiles), 2 and 4 rounds (const's
    output is mostly its 127 clamp by round 4, not by round 2): the same
    bf16 outputs, bit for bit (both sum in separate float32 multiplies and
    adds, or round every step in bf16)."""
    rng = np.random.default_rng(floors.VARIANTS.index(variant))
    x = rng.uniform(0, 1, (2, 8, 8, 16)).astype(np.float32)
    w = rng.uniform(0.05, 0.2, (3, 3, 16)).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    for reps in (2, 4):
        want = np.asarray(_stencil_pallas(jax_floors, jnp.asarray(x, jnp.bfloat16),
                                          jnp.asarray(w, jnp.bfloat16), reps, variant),
                          np.float32)
        got = floors.stencil(tx, tw, reps, variant)
        torch.testing.assert_close(got, floors.stencil_plain(tx, tw, reps, variant), atol=0,
                                   rtol=0)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("variant", floors.VARIANTS)
def test_check_stencil_is_not_blind(monkeypatch, variant):
    """`check_stencil`, the card's stencil check, passes the plain version
    at 2, 8 and 64 rounds and fails a stencil that ignores x or writes
    zeros at 2 rounds and, but for const (saturated by round 4), at 8."""
    for reps in (2, 8, 64):
        floors.check_stencil(variant, 1, 8, 8, 16, reps, "cpu")
    fakes = (lambda x, w, reps, v: floors.stencil_plain(torch.full_like(x, 0.5), w, reps, v),
             lambda x, w, reps, v: torch.zeros_like(x))
    for fake in fakes:
        monkeypatch.setattr(floors, "stencil", fake)
        for reps in (2,) if variant == "const" else (2, 8):
            with pytest.raises(AssertionError):
                floors.check_stencil(variant, 1, 8, 8, 16, reps, "cpu")


def test_copies_vs_pallas(jax_floors):
    """Both copies against the JAX copy kernel, the 4-d and the flat
    framing, in interpret mode: equal."""
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    spec = pl.BlockSpec((1, 4, 4, 64), lambda b: (b, 0, 0, 0))
    want = np.asarray(pl.pallas_call(jax_floors._copy_kernel, grid=(2,), in_specs=[spec],
                                     out_specs=spec, out_shape=jx, interpret=True)(jx),
                      np.float32)
    flat = jx.reshape(2, 8, 128)
    fspec = pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0))
    want_flat = np.asarray(pl.pallas_call(jax_floors._copy_kernel, grid=(2,), in_specs=[fspec],
                                          out_specs=fspec, out_shape=flat, interpret=True)(flat),
                           np.float32).reshape(x.shape)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for fn in (floors.hbm_copy, floors.hbm_copy_flat):
        got = fn(tx)
        assert got.data_ptr() != tx.data_ptr()
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(got.float().numpy(), want_flat)
    with pytest.raises(ValueError):
        floors.hbm_copy(tx[..., :3])  # not contiguous
    with pytest.raises(ValueError):
        floors.stencil(tx, torch.ones(3, 3, 64, dtype=torch.bfloat16), 2, "fma4")


def _cfgs(model):
    if model == "v1":
        return roofline.model_config("v1"), JaxModelConfig(alpha=1.0, resolution=224,
                                                           compute_dtype="bfloat16")
    if model == "v2":
        return roofline.model_config("v2"), JaxV2Config(alpha=1.0, resolution=224,
                                                        compute_dtype="bfloat16")
    variant = "large" if model == "v3" else "small"
    return roofline.model_config(model), JaxV3Config(variant=variant, alpha=1.0,
                                                     resolution=224, compute_dtype="bfloat16")


def _close(got, want):
    assert got.keys() == want.keys()
    for label in want:
        for key, v in want[label].items():
            if isinstance(v, str):
                assert got[label][key] == v, (label, key)
            else:
                assert got[label][key] == pytest.approx(v, rel=1e-12, abs=1e-300), (label, key)


RATES = [roofline.H100,
         roofline.Rates(mxu_flops=7.1e14, vpu_fmas=2.9e13,
                        hbm_by_channels={64: 2.1e12, 128: 2.6e12, 256: 2.9e12, 512: 3.0e12,
                                         1024: 3.05e12})]


@pytest.mark.parametrize("rates", RATES, ids=["published", "achievable"])
@pytest.mark.parametrize("model", ["v1", "v2", "v3", "v3small"])
def test_roofline_vs_jax(jax_roofline, monkeypatch, model, rates):
    """1.0-224, batch 256, bf16 and int8 activations: every floor, its
    binding unit and (V2/V3) the serial-phase composition within 1e-12
    relative of tools/roofline.py with the same rates in its globals."""
    monkeypatch.setattr(jax_roofline, "MXU_FLOPS", rates.mxu_flops)
    monkeypatch.setattr(jax_roofline, "VPU_FMAS", rates.vpu_fmas)
    monkeypatch.setattr(jax_roofline, "HBM_BPS", rates.hbm_bps)
    monkeypatch.setattr(jax_roofline, "HBM_RATES", rates.hbm_by_channels)
    cfg, jcfg = _cfgs(model)
    for esz in (2, 1):
        if model == "v1":
            _close(roofline.segment_floors(cfg, 256, esz, rates),
                   jax_roofline.segment_floors(jcfg, 256, esz))
        else:
            _close(roofline.family_block_floors(cfg, 256, esz, rates),
                   jax_roofline.family_block_floors(jcfg, 256, esz))
    if model != "v1":
        _close(roofline.family_block_composition(cfg, 256, rates),
               jax_roofline.family_block_composition(jcfg, 256))


def test_roofline_cli_and_achievable(tmp_path, capsys):
    """The entry point prints the table from the published rates, and from
    a floors run's JSON with --achievable."""
    assert roofline.main(["--model", "v3small", "--composition"]) == 0
    out = capsys.readouterr().out
    assert "mobilenet_v3_small_1_224 batch=256 bf16" in out and "TOTAL" in out
    path = tmp_path / "achievable.json"
    path.write_text('{"nvidia_smi": "card, 700.00 W", "mxu_tflops": 700.0, '
                    '"stencil_tfmas": 30.0, "hbm_copy_gbps": {"112x64": 2000.0, '
                    '"7x1024": 3000.0}}')
    rates, _ = roofline.achievable_rates(path)
    assert rates.hbm(96) == 2000e9 and rates.hbm(600) == 3000e9
    assert roofline.main(["--model", "v1", "--achievable", str(path)]) == 0
    assert "achievable rates (card, 700.00 W)" in capsys.readouterr().out
