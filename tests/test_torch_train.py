"""The port's training path (models/train.py, `cli train`) against the JAX
package's on the CPU: the float32 loss within rtol 1e-5 and every gradient
leaf within 1e-6 + 1e-4 x the leaf's absmax of `jax.grad`, at V1 0.25-64,
V2 1.0-96 and V3-Small 1.0-96; two `make_trainer` steps against two
`make_optax_trainer` steps (loss, top1 and every parameter at the same
tolerance); a descending loss; `cli train` against the JAX `cli train`,
its --out read by the JAX `load_npz` and by the port's `cli classify`.
Weights are the JAX package's seeded folded trees, carried across as
numpy.

Two correct float32 forwards may put an activation that lies within their
rounding of a ReLU6 bound on opposite sides of it, and the gradients of
every earlier layer then differ by ~0.5% (V2 1.0-96's batch of seed 0 has
one such input, 3.8e-5 above 6 in float64: JAX clips it, the port does
not). The gradient test first asserts that no tap has a clipped element
(exactly 0 or 6) in one package and not in the other, and V2 draws its
batch from seed 1, where none has."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import default_folded as jax_default_folded
from mobilenet_tpu.checkpoints import load_npz as jax_load_npz
from mobilenet_tpu.checkpoints import to_device as jax_to_device
from mobilenet_tpu.cli import main as jax_cli_main
from mobilenet_tpu.models import mobilenet_v1 as jax_v1
from mobilenet_tpu.models import mobilenet_v2 as jax_v2
from mobilenet_tpu.models import mobilenet_v3 as jax_v3
from mobilenet_tpu.models import train as jax_train
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import to_device
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.models import mobilenet_v1, mobilenet_v2, mobilenet_v3, train
from mobilenet_tpu_torch.ops.conv import no_tf32

LOSS_RTOL = 1e-5
TOL_ABS, TOL_REL = 1e-6, 1e-4  # a leaf: |port - jax| <= TOL_ABS + TOL_REL x absmax

# name -> (port config, JAX config, batch, input seed)
MODELS = {
    "v1_0.25_64": (ModelConfig(0.25, 64), JaxConfig(alpha=0.25, resolution=64), 4, 0),
    "v2_1.0_96": (V2Config(1.0, 96), JaxV2Config(alpha=1.0, resolution=96), 2, 1),
    "v3small_1.0_96": (V3Config("small", 1.0, 96),
                       JaxV3Config(variant="small", alpha=1.0, resolution=96), 2, 0),
}
_FORWARDS = {
    ModelConfig: (jax_v1.forward, mobilenet_v1.forward, {"use_pallas_dw": False}),
    V2Config: (jax_v2.forward_v2, mobilenet_v2.forward_v2, {"dw_backend": "xla"}),
    V3Config: (jax_v3.forward_v3, mobilenet_v3.forward_v3, {}),
}


def _batch(res, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    return x, rng.integers(0, 1000, (n,)).astype(np.int32)


def assert_tree_close(got, want, path="params"):
    """Every leaf of the port's tree within TOL_ABS + TOL_REL x absmax of
    the JAX tree's, matched by key (JAX sorts dict keys)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{path}/{i}")
        return
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, path
    tol = TOL_ABS + TOL_REL * float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert err <= tol, f"{path}: max |port - jax| {err:.3e} > {tol:.3e}"


def assert_same_clips(cfg, jcfg, folded, x):
    """No tap of the two float32 forwards has an element clipped (exactly 0
    or 6) in one and not in the other."""
    jfwd, fwd, kw = _FORWARDS[type(cfg)]
    _, jacts = jax.jit(lambda p, x: jfwd(p, x, jcfg, collect=True, **kw))(
        jax_to_device(folded), jnp.asarray(x))
    with torch.no_grad():
        _, acts = fwd(to_device(folded, "cpu", torch.float32), torch.from_numpy(x), cfg,
                      dw_backend="plain", collect=True)
    for k, v in acts.items():
        j, p = np.asarray(jacts[k]), v.numpy()
        for bound in (0.0, 6.0):
            flips = int(((j == bound) != (p == bound)).sum())
            assert flips == 0, f"{k}: {flips} elements at {bound} in one package only"


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_grads_match_jax(name):
    cfg, jcfg, n, seed = MODELS[name]
    folded = jax_default_folded(jcfg, seed=0)
    x, y = _batch(cfg.resolution, n, seed)
    assert_same_clips(cfg, jcfg, folded, x)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x, y: jax_train.cross_entropy_loss(p, x, y, jcfg)))(
            jax_to_device(folded), jnp.asarray(x), jnp.asarray(y))

    params = to_device(folded, "cpu", torch.float32)
    leaves = train.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    xt = torch.from_numpy(x)
    with no_tf32(xt):
        loss = train.cross_entropy_loss(params, xt, torch.from_numpy(y), cfg)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert_tree_close(train.tree_map(lambda _: next(it), params), jax.device_get(jgrads),
                      "grads")


def test_two_trainer_steps_match_optax():
    """make_trainer (torch.optim.SGD) equals make_optax_trainer step for
    step: loss, top1 and every parameter after each of two steps."""
    cfg, jcfg, _, _ = MODELS["v1_0.25_64"]
    folded = jax_default_folded(jcfg, seed=0)
    x, y = _batch(cfg.resolution, 8, seed=1)
    y = y % 4  # top1 moves off 0 within two steps
    init_fn, step_fn = jax_train.make_optax_trainer(jcfg, lr=5e-2)
    jparams = jax_to_device(folded)
    opt_state = init_fn(jparams)
    jstep = jax.jit(step_fn)

    params = to_device(folded, "cpu", torch.float32)
    step = train.make_trainer(cfg, params, lr=5e-2)
    for _ in range(2):
        jparams, opt_state, jloss, jtop1 = jstep(jparams, opt_state, jnp.asarray(x),
                                                 jnp.asarray(y))
        loss, top1 = step(torch.from_numpy(x), torch.from_numpy(y))
        assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
        assert float(top1) == float(jtop1)
        assert_tree_close(params, jax.device_get(jparams))


def test_trainer_descends_and_sgd_step():
    cfg, jcfg, _, _ = MODELS["v1_0.25_64"]
    folded = jax_default_folded(jcfg, seed=0)
    x, y = (torch.from_numpy(a) for a in _batch(cfg.resolution, 8))
    params = to_device(folded, "cpu", torch.float32)
    step = train.make_trainer(cfg, params, lr=5e-2)
    losses = []
    for _ in range(4):
        loss, top1 = step(x, y)
        losses.append(float(loss))
        assert 0.0 <= float(top1) <= 1.0
    assert losses[-1] < losses[0]
    # the plain SGD step leaves its input tree as it was and descends too
    p0 = to_device(folded, "cpu", torch.float32)
    p1, l1 = train.sgd_train_step(p0, x, y, cfg, lr=1e-2)
    p2, _ = train.sgd_train_step(p1, x, y, cfg, lr=1e-2)
    _, l3 = train.sgd_train_step(p2, x, y, cfg, lr=1e-2)
    assert float(l3) < float(l1)
    assert torch.equal(p0["fc"]["w"], torch.from_numpy(np.asarray(folded["fc"]["w"])))


def test_cli_train_matches_jax_and_out_loads(tmp_path, capsys):
    """`cli train` at 0.25-64, batch 4, 2 steps: its JSON lines against the
    JAX `cli train` (the lines carry 4 decimals: loss within 1e-4 + rtol
    1e-5, top1 equal); its --out loads in the JAX load_npz, within the
    parameter tolerance of the JAX command's --out, and in `cli classify
    --ckpt`."""
    size = ["--alpha", "0.25", "--res", "64", "--batch", "4", "--steps", "2"]
    jax_cli_main(["--backend", "cpu", "train", *size, "--out", str(tmp_path / "jax.npz")])
    jax_lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
    cli_main(["train", *size, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [ln["step"] for ln in jax_lines] == [0, 1]
    for got, want in zip(lines, jax_lines):
        assert abs(got["loss"] - want["loss"]) <= 1e-4 + LOSS_RTOL * abs(want["loss"])
        assert got["top1"] == want["top1"]
    trained = jax_load_npz(str(tmp_path / "port.npz"))
    assert_tree_close(to_device(trained, "cpu"), jax_load_npz(str(tmp_path / "jax.npz")))

    png = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (64, 64, 3), np.uint8)).save(png)
    cli_main(["classify", str(png), "--alpha", "0.25", "--res", "64", "--device", "cpu",
              "--ckpt", str(tmp_path / "port.npz")])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 and out[0].startswith("top-1: class ")
