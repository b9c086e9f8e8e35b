"""The port's quantization-aware training (quant/qat.py) on the CPU against
the JAX package's and the int8 oracles.

The headline gate is the int8 invariant applied to QAT: with collect=True
every integer-domain tap equals the JAX package's `qat_forward*` and the
port's int8 oracles (`quant/oracle.forward_all`, `quant/v2.
forward_all_v2_i8`, `quant/v3.forward_all_v3_i8`) bit for bit, logits too,
at V1 0.25-64 and 1.0-32 (the widest accumulation: pointwise Cin 1024), V2
1.0-96 and V3-Small 1.0-96. Then: the V1 loss and every gradient leaf
within 1e-6 + 1e-4 x the leaf's absmax of `jax.grad`; V3's gradients
reaching the SE weights; descending losses; the export round trip (after
two steps, `quantize` of the port's trained weights reproduces the port's
QAT taps exactly, on its own weights); `cli train --qat --model v2`.

The JAX functions run under jit with XLA's algebraic simplifier off
(`_jax_exact`): with it on, XLA folds `s_h * s_w / s_h` into `s_w *
0.99999994` and divides by a constant as a product with its reciprocal,
and the JAX QAT forward then misses its own int8 oracle by one at some
taps (the JAX package's test runs it op by op, ~20-55 s a model here)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import default_folded as jax_default_folded
from mobilenet_tpu.checkpoints import to_device as jax_to_device
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu.quant import qat as jax_qat
from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import to_device
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.models.train import tree_leaves, tree_map
from mobilenet_tpu_torch.ops.conv import no_tf32
from mobilenet_tpu_torch.quant import oracle, qat
from mobilenet_tpu_torch.quant.quantize import quantize, quantize_input
from mobilenet_tpu_torch.quant.v2 import forward_all_v2_i8, quantize_v2
from mobilenet_tpu_torch.quant.v3 import calibrate_v3, forward_all_v3_i8, quantize_v3

from test_torch_train import assert_tree_close

N_CALIB = 8
_NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}

# name -> (port config, JAX config, batch)
MODELS = {
    "v1_0.25_64": (ModelConfig(0.25, 64), JaxConfig(alpha=0.25, resolution=64), 4),
    "v1_1.0_32": (ModelConfig(1.0, 32), JaxConfig(alpha=1.0, resolution=32), 2),
    "v2_1.0_96": (V2Config(1.0, 96), JaxV2Config(alpha=1.0, resolution=96), 2),
    "v3small_1.0_96": (V3Config("small", 1.0, 96),
                       JaxV3Config(variant="small", alpha=1.0, resolution=96), 2),
}
GRADS = ("v1_0.25_64",)  # also held against jax.grad


def _jax_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_NO_ALGSIMP)(*args)


def _input(res, n, seed=7):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _labels(n):
    return np.arange(n, dtype=np.int32) % 3


def _forwards(cfg, folded):
    """(port forward, JAX forward, oracle taps fn) of a model: each forward
    takes (params, x, collect); the oracle fn takes the float input."""
    if isinstance(cfg, V3Config):
        cal = calibrate_v3(folded, cfg, n_images=N_CALIB)
        q = quantize_v3(folded, cfg, n_calib=N_CALIB)
        return (lambda p, x, c: qat.qat_forward_v3(p, x, cfg, cal, collect=c),
                lambda jc, p, x: jax_qat.qat_forward_v3(p, x, jc, cal, collect=True),
                lambda x: forward_all_v3_i8(q, quantize_input(x), cfg))
    if isinstance(cfg, V2Config):
        q = quantize_v2(folded, cfg, n_calib=N_CALIB)
        s_blk = tuple(float(s) for s in q.s_blk)
        return (lambda p, x, c: qat.qat_forward_v2(p, x, cfg, s_blk, collect=c),
                lambda jc, p, x: jax_qat.qat_forward_v2(p, x, jc, s_blk, collect=True),
                lambda x: forward_all_v2_i8(q, quantize_input(x), cfg))
    return (lambda p, x, c: qat.qat_forward(p, x, cfg, collect=c),
            lambda jc, p, x: jax_qat.qat_forward(p, x, jc, collect=True),
            lambda x: oracle.forward_all(quantize(folded, cfg), quantize_input(x), cfg))


def _nll(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def _assert_taps_equal(got, want, label):
    assert set(want) <= set(got), (label, sorted(set(want) - set(got)))
    for k, ref in want.items():
        g = (got[k].detach().numpy() if isinstance(got[k], torch.Tensor)
             else np.asarray(got[k])).astype(np.float32)
        r = np.asarray(ref).astype(np.float32)
        assert np.array_equal(g, r), (label, k, float(np.abs(g - r).max()), (g != r).mean())


@pytest.mark.parametrize("name", list(MODELS))
def test_qat_taps_bit_exact(name):
    """Every tap (and the logits) of the port's QAT forward equals the JAX
    package's and the port's int8 oracle's; at V1 0.25-64 the loss and the
    gradients also match jax.grad."""
    cfg, jcfg, n = MODELS[name]
    folded = jax_default_folded(jcfg, seed=0)
    x = _input(cfg.resolution, n)
    fwd, jfwd, oracle_taps = _forwards(cfg, folded)
    params = to_device(folded, "cpu", torch.float32)
    xt = torch.from_numpy(x)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with no_tf32(xt):
        logits, acts = fwd(params, xt, True)
    ref_logits, ref_acts = oracle_taps(x)
    _assert_taps_equal({**acts, "logits": logits}, {**ref_acts, "logits": ref_logits},
                       "oracle")

    if name not in GRADS:
        _, jacts = _jax_exact(lambda p, x: jfwd(jcfg, p, x), jax_to_device(folded),
                              jnp.asarray(x))
        _assert_taps_equal(acts, jacts, "jax")
        return

    def jloss(p, x, y):
        lg, ja = jfwd(jcfg, p, x)
        logp = jax.nn.log_softmax(lg, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1)), ja

    (jl, jacts), jgrads = _jax_exact(jax.value_and_grad(jloss, has_aux=True),
                                     jax_to_device(folded), jnp.asarray(x),
                                     jnp.asarray(_labels(n)))
    _assert_taps_equal(acts, jacts, "jax")
    with no_tf32(xt):
        loss = _nll(logits, torch.from_numpy(_labels(n)))
        grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().sum()) > 0  # the STE reaches the stem's weights
    it = iter(grads)
    assert_tree_close(tree_map(lambda _: next(it), params), jax.device_get(jgrads), "grads")


def test_qat_v1_trainer_descends_and_export_roundtrip():
    """Two QAT steps on V1 0.25-64, then more: the loss descends; after the
    first two, `quantize` of the trained weights and the int8 oracle
    reproduce the QAT forward's taps exactly on those weights."""
    cfg, jcfg, _ = MODELS["v1_0.25_64"]
    folded = jax_default_folded(jcfg, seed=0)
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 1000, (8,)))
    params = to_device(folded, "cpu", torch.float32)
    step = qat.make_qat_trainer(cfg, params, lr=5e-2)
    losses = []
    for _ in range(2):
        loss, top1 = step(xb, yb)
        losses.append(float(loss))
        assert 0.0 <= float(top1) <= 1.0
    trained = tree_map(lambda t: t.detach().numpy().copy(), params)
    x = _input(64, 4)
    with torch.no_grad():
        logits, acts = qat.qat_forward(to_device(trained, "cpu"), torch.from_numpy(x), cfg,
                                       collect=True)
    ref_logits, ref_acts = oracle.forward_all(quantize(trained, cfg), quantize_input(x), cfg)
    _assert_taps_equal({**acts, "logits": logits}, {**ref_acts, "logits": ref_logits},
                       "export")
    for _ in range(2):
        losses.append(float(step(xb, yb)[0]))
    assert losses[-1] < losses[0]


def test_qat_v3_trainer_descends_and_grads_reach_se():
    cfg, jcfg, _ = MODELS["v3small_1.0_96"]
    folded = jax_default_folded(jcfg, seed=0)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.uniform(-1, 1, (4, 96, 96, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 1000, (4,)))
    params = to_device(folded, "cpu", torch.float32)
    step, cal = qat.make_qat_trainer_v3(cfg, folded, params, lr=2e-3, n_calib=N_CALIB)
    assert len(cal["blocks"]) == len(cfg.block_defs)
    i = next(i for i, bd in enumerate(cfg.block_defs) if bd.se_mid)
    losses = []
    for _ in range(3):
        before = params["blocks"][i]["se"]["w1"].detach().clone()
        loss, _ = step(xb, yb)
        losses.append(float(loss))
        # the STE gradients reach the SE's in-gate matmuls: its weights move
        assert float((params["blocks"][i]["se"]["w1"].detach() - before).abs().sum()) > 0
    assert losses[-1] < losses[0]


def test_qat_v2_trainer_and_cli_train_qat(capsys):
    """make_qat_trainer_v2 calibrates one scale a block and descends at lr
    2e-3 (5e-2 diverges on V2 in the JAX package's test); `cli train --qat
    --model v2` runs its steps."""
    cfg = V2Config(0.35, 64)
    folded = jax_default_folded(JaxV2Config(alpha=0.35, resolution=64), seed=0)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 1000, (4,)))
    params = to_device(folded, "cpu", torch.float32)
    step, s_blk = qat.make_qat_trainer_v2(cfg, folded, params, lr=2e-3, n_calib=N_CALIB)
    assert len(s_blk) == len(cfg.block_defs)
    losses = [float(step(xb, yb)[0]) for _ in range(3)]
    assert losses[-1] < losses[0]

    cli_main(["train", "--qat", "--model", "v2", "--alpha", "0.35", "--res", "64",
              "--batch", "2", "--steps", "2", "--lr", "2e-3", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(np.isfinite(ln["loss"]) and 0 <= ln["top1"] <= 1 for ln in lines)
