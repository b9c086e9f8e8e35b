"""Pipeline parallelism of the port (parallel/pp.py) and the block runners'
`start`/`stop` against the JAX package on the CPU.

The JAX side runs `pp.make_pipe_mesh(S)` on the conftest's 8 virtual CPU
devices, the port `make_pipe_mesh(S, ["cpu"] * S)`, from the same seeded
folded weights at the JAX tests' sizes: V1 0.25-64, V2 and V3-Small 1.0-96,
batch 8. The stage bounds equal the JAX package's for every family and every
S; V1 logits within 1e-5 of JAX `forward_pp` (its "xla" route against the
port's "plain"), V2 and V3-Small within golden.V2_TOL / V3_TOL and equal to
the port's forward on each microbatch; `pp_train_step`'s loss and every updated leaf within 1e-5
of the leaf's absmax of JAX `pp_train_step`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import default_folded as jax_default_folded
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu.parallel import pp as jax_pp
from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import to_device
from mobilenet_tpu_torch.models import mobilenet_v1, mobilenet_v2, mobilenet_v3
from mobilenet_tpu_torch.models.train import sgd_train_step, tree_leaves
from mobilenet_tpu_torch.parallel import pp
from mobilenet_tpu_torch.utils import golden

TOL = dict(atol=1e-5, rtol=0)
N = 8

# name -> (port config, JAX config, resolution)
FAMILIES = {
    "v1": (ModelConfig(0.25, 64, compute_dtype="float32"),
           JaxConfig(alpha=0.25, resolution=64), 64),
    "v2": (V2Config(1.0, 96, compute_dtype="float32"),
           JaxV2Config(alpha=1.0, resolution=96), 96),
    "v3small": (V3Config("small", 1.0, 96, compute_dtype="float32"),
                JaxV3Config(variant="small", alpha=1.0, resolution=96), 96),
}


@pytest.fixture(scope="module")
def fam():
    """Per family: the JAX folded tree, the port's float32 device tree and
    the batch (seed 7)."""
    out = {}
    for name, (cfg, jcfg, res) in FAMILIES.items():
        host = jax_default_folded(jcfg, seed=0)
        x = np.random.default_rng(7).uniform(-1, 1, (N, res, res, 3)).astype(np.float32)
        out[name] = dict(cfg=cfg, jcfg=jcfg, host=host, x=x,
                         params=to_device(host, "cpu", torch.float32))
    return out


def _mesh(s):
    return pp.make_pipe_mesh(s, ["cpu"] * s)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_plan_stages_equal_jax(fam, name):
    f = fam[name]
    n_units = pp._units_for(f["cfg"], f["params"], "plain", 1)[0]
    assert n_units == jax_pp._units_for(f["jcfg"], f["host"], "xla", 1)[0]
    assert pp._units_for(f["cfg"], f["params"], "plain", 1)[2] == pytest.approx(
        jax_pp._units_for(f["jcfg"], f["host"], "xla", 1)[2], rel=0, abs=0)
    for s in range(1, n_units + 1):
        assert pp.plan_stages(f["cfg"], f["params"], s) == \
            jax_pp.plan_stages(f["jcfg"], f["host"], s), s
    with pytest.raises(ValueError, match="n_stages"):
        pp.plan_stages(f["cfg"], f["params"], n_units + 1)


def _jax_forward_pp(f, s, m):
    return np.asarray(jax_pp.forward_pp(f["host"], jnp.asarray(f["x"]), f["jcfg"],
                                        jax_pp.make_pipe_mesh(s), n_microbatches=m))


@pytest.mark.parametrize("s,m", [(2, 2), (4, 4)])
def test_forward_pp_v1(fam, s, m):
    f = fam["v1"]
    got = pp.forward_pp(f["params"], torch.from_numpy(f["x"]), f["cfg"], _mesh(s),
                        n_microbatches=m, dw_backend="plain")
    assert got.dtype == torch.float32 and got.shape == (N, f["cfg"].num_classes)
    np.testing.assert_allclose(got.numpy(), _jax_forward_pp(f, s, m), **TOL)


@pytest.mark.parametrize("name", ["v1", "v2", "v3small"])
def test_forward_pp_auto_is_the_forward_per_microbatch(fam, name):
    """The "auto" route (the kernels' plain versions here) equals the
    single-device forward run on each microbatch."""
    f = fam[name]
    fwd = {"v1": mobilenet_v1.forward, "v2": mobilenet_v2.forward_v2,
           "v3small": mobilenet_v3.forward_v3}[name]
    x = torch.from_numpy(f["x"])
    got = pp.forward_pp(f["params"], x, f["cfg"], _mesh(4), n_microbatches=4)
    want = torch.cat([fwd(f["params"], mb, f["cfg"], dw_backend="auto") for mb in x.split(2)])
    torch.testing.assert_close(got, want.float(), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["v2", "v3small"])
def test_forward_pp_families(fam, name):
    """Against JAX forward_pp within the family's float32 gate of the two
    packages (golden.V2_TOL, V3_TOL: the unclipped linear bottlenecks carry
    float32 rounding further than V1's 1e-5), and bit-equal to the port's
    own forward on each microbatch."""
    f = fam[name]
    fwd = mobilenet_v2.forward_v2 if name == "v2" else mobilenet_v3.forward_v3
    x = torch.from_numpy(f["x"])
    got = pp.forward_pp(f["params"], x, f["cfg"], _mesh(4), n_microbatches=4,
                        dw_backend="plain")
    atol, rtol = golden.V2_TOL if name == "v2" else golden.V3_TOL
    np.testing.assert_allclose(got.numpy(), _jax_forward_pp(f, 4, 4), atol=atol, rtol=rtol)
    want = torch.cat([fwd(f["params"], mb, f["cfg"], dw_backend="plain") for mb in x.split(2)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_forward_pp_bad_microbatch_count(fam):
    f = fam["v1"]
    with pytest.raises(ValueError, match="not divisible"):
        pp.forward_pp(f["params"], torch.from_numpy(f["x"]), f["cfg"], _mesh(2),
                      n_microbatches=3)
    with pytest.raises(ValueError, match="need 3 devices"):
        pp.make_pipe_mesh(3, ["cpu"] * 2)


def test_pp_train_step(fam):
    f = fam["v1"]
    labels = np.random.default_rng(3).integers(0, 1000, (N,)).astype(np.int32)
    jmesh = jax_pp.make_pipe_mesh(4)
    jnew, jloss = jax.jit(lambda p, x, y: jax_pp.pp_train_step(
        p, x, y, f["jcfg"], jmesh, n_microbatches=4))(
            jax.tree.map(jnp.asarray, f["host"]), jnp.asarray(f["x"]), jnp.asarray(labels))
    new, loss = pp.pp_train_step(f["params"], torch.from_numpy(f["x"]),
                                 torch.from_numpy(labels), f["cfg"], _mesh(4), lr=1e-3,
                                 n_microbatches=4)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    # the port's own single-device step: the schedule adds nothing
    new1, loss1 = sgd_train_step(f["params"], torch.from_numpy(f["x"]),
                                 torch.from_numpy(labels), f["cfg"], lr=1e-3)
    assert abs(loss.item() - loss1.item()) <= 1e-6

    def check(got, want, path):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                check(got[k], want[k], f"{path}/{k}")
        elif isinstance(want, (list, tuple)):
            for i, (g, w) in enumerate(zip(got, want)):
                check(g, w, f"{path}/{i}")
        else:
            w = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=path)

    check(new, jnew, "params")
    for a, b in zip(tree_leaves(new), tree_leaves(new1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


# -- the block runners' start and stop -------------------------------------------


def _split_points(n):
    return [(0, 3), (3, n // 2), (n // 2, n)]


def test_v1_run_blocks_split(fam):
    f = fam["v1"]
    cfg, p = f["cfg"], f["params"]
    routing = ("fused",) * 13
    for batch in (2, 1):
        y0 = mobilenet_v1.ops.conv2d_same(torch.from_numpy(f["x"][:batch]), p["conv1"]["w"], 2,
                                          bias=p["conv1"]["b"], relu6=True)
        y = y0
        for a, b in _split_points(13):
            y = mobilenet_v1._run_blocks(p, y, cfg, routing, True, start=a, stop=b)
        whole = mobilenet_v1._run_blocks(p, y0, cfg, routing, True, start=0, stop=13)
        torch.testing.assert_close(y, whole, rtol=0, atol=0)


def test_v1_stop_forms_no_chain(monkeypatch):
    """A call with `stop` forms no batch-1 chain run (JAX `_run_blocks`)."""
    cfg = ModelConfig(1.0, 224)
    calls = []
    monkeypatch.setattr(mobilenet_v1, "chain", lambda *a, **k: calls.append(a) or a[0])
    monkeypatch.setattr(mobilenet_v1, "separable_block", lambda y, *a, **k: y)
    blocks = [{"dw": {"w": None, "b": None}, "pw": {"w": torch.zeros(ci, co), "b": None}}
              for ci, co in zip(mobilenet_v1_cins(cfg), cfg.block_channels)]
    y = torch.zeros(1, 14, 14, 512, dtype=torch.bfloat16)
    params = {"blocks": blocks}
    mobilenet_v1._run_blocks(params, y, cfg, ("fused",) * 13, True, start=6, stop=11)
    assert calls == []
    assert mobilenet_v1._chain_runs(params, cfg, ("fused",) * 13, y.shape, 2, 6)


def mobilenet_v1_cins(cfg):
    return [cfg.stem_channels, *cfg.block_channels[:-1]]


@pytest.mark.parametrize("name", ["v2", "v3small"])
def test_family_run_blocks_split(fam, name):
    f = fam[name]
    cfg, p = f["cfg"], f["params"]
    mod, run = ((mobilenet_v2, mobilenet_v2.run_blocks_v2) if name == "v2"
                else (mobilenet_v3, mobilenet_v3.run_blocks_v3))
    routing = ("fused",) * len(cfg.block_defs)
    kw = {"relu6": True} if name == "v2" else {"act": cfg.head_act}
    y0 = mod.ops.conv2d_same(torch.from_numpy(f["x"][:2]), p["conv1"]["w"], 2,
                             bias=p["conv1"]["b"], **kw)
    y = y0
    for a, b in _split_points(len(cfg.block_defs)):
        y = run(p, y, cfg, routing, start=a, stop=b)
    torch.testing.assert_close(y, run(p, y0, cfg, routing), rtol=0, atol=0)


def test_v3_chain_never_crosses_stop(monkeypatch):
    cfg = V3Config("large", 1.0, 224)
    routing = ("fused",) * len(cfg.block_defs)
    monkeypatch.setattr(mobilenet_v3, "CHAIN_V3", True)
    whole = mobilenet_v3.chain_runs(cfg, routing, 1, 112, 112, 2)
    assert whole, whole
    start, stop = min(whole), min(whole) + 2
    h = 112
    for bd in cfg.block_defs[:start]:
        h = -(-h // bd.stride)
    part = mobilenet_v3.chain_runs(cfg, routing, 1, h, h, 2, start, stop)
    assert all(start <= a and b <= stop for a, b in part.items()), part
    assert part == {start: stop}
