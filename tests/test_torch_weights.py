"""The port's weight subsystem against the JAX package's: seeded init and BN
folding bit for bit, .npz files across packages, and the device tree that
`from_jax_params` builds."""

import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn as jax_fold_bn
from mobilenet_tpu.checkpoints import init_params as jax_init_params
from mobilenet_tpu.checkpoints import load_npz as jax_load_npz
from mobilenet_tpu.checkpoints import save_npz as jax_save_npz
from mobilenet_tpu_torch import ModelConfig
from mobilenet_tpu_torch.checkpoints import (
    fold_bn, from_jax_params, init_params, load_npz, save_npz, to_device,
)
from mobilenet_tpu_torch.checkpoints.io import _flatten


def _assert_trees_identical(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("folded", [False, True])
def test_init_and_fold_bit_identical(seed, folded):
    """Same seed -> bit-identical raw and folded weights in both packages."""
    cfg, jcfg = ModelConfig(0.25, 128), JaxConfig(0.25, 128)
    ours, theirs = init_params(cfg, seed), jax_init_params(jcfg, seed)
    if folded:
        ours, theirs = fold_bn(ours, cfg.bn_eps), jax_fold_bn(theirs, jcfg.bn_eps)
    _assert_trees_identical(ours, theirs)


def test_config_mirrors_reference():
    for alpha in (0.25, 0.5, 0.75, 1.0):
        cfg, jcfg = ModelConfig(alpha, 224), JaxConfig(alpha, 224)
        assert cfg.block_channels == jcfg.block_channels
        assert cfg.block_strides == jcfg.block_strides
        assert list(cfg.layer_shapes()) == list(jcfg.layer_shapes())
        assert cfg.variant_name() == jcfg.variant_name()
    with pytest.raises(ValueError):
        ModelConfig(0.3, 224)
    with pytest.raises(ValueError):
        ModelConfig(1.0, 200)
    with pytest.raises(ValueError):
        ModelConfig(1.0, 224, compute_dtype="float16")


def test_load_npz_reads_reference_file(tmp_path):
    """A folded .npz the JAX package saved loads here, and back."""
    tree = jax_fold_bn(jax_init_params(JaxConfig(0.25, 128), 3))
    jax_path = str(tmp_path / "jax.npz")
    jax_save_npz(jax_path, tree)
    _assert_trees_identical(load_npz(jax_path), tree)
    ours_path = str(tmp_path / "ours.npz")
    save_npz(ours_path, load_npz(jax_path))
    _assert_trees_identical(jax_load_npz(ours_path), tree)


def test_from_jax_params_roundtrip():
    cfg = ModelConfig(0.25, 128)
    tree = jax_fold_bn(jax_init_params(JaxConfig(0.25, 128), 0))
    dev = from_jax_params(tree, "cpu", torch.float32, cfg.block_strides)
    back = {
        "conv1": {k: v.numpy() for k, v in dev["conv1"].items()},
        "blocks": [{layer: {k: v.numpy() for k, v in blk[layer].items()}
                    for layer in ("dw", "pw")} for blk in dev["blocks"]],
        "fc": {k: v.numpy() for k, v in dev["fc"].items()},
    }
    _assert_trees_identical(back, {k: tree[k] for k in ("conv1", "blocks", "fc")})
    # the chain kernel's stacked weights, prepared once: blocks 6-10
    assert sorted(dev["chain"]) == [6]
    dw_ws, dw_bs, pw_ws, pw_bs = dev["chain"][6]
    c = cfg.block_channels[6]
    assert dw_ws.shape == (5, 3, 3, c) and pw_ws.shape == (5, c, c)
    np.testing.assert_array_equal(dw_ws[2].numpy(),
                                  tree["blocks"][8]["dw"]["w"].reshape(3, 3, c))
    np.testing.assert_array_equal(pw_bs[4].numpy(), tree["blocks"][10]["pw"]["b"])
    with pytest.raises(ValueError):
        from_jax_params({"conv1": tree["conv1"]}, "cpu", torch.float32,
                        cfg.block_strides)


def test_to_device_casts_every_float32_leaf():
    """Biases too are cast to the compute dtype, as the JAX package does."""
    tree = fold_bn(init_params(ModelConfig(0.25, 128), 0))
    tree["extra_i8"] = np.arange(4, dtype=np.int8)
    dev = to_device(tree, "cpu", torch.bfloat16)
    assert dev["blocks"][0]["dw"]["b"].dtype == torch.bfloat16
    assert dev["fc"]["b"].dtype == torch.bfloat16
    assert dev["extra_i8"].dtype == torch.int8
    np.testing.assert_array_equal(
        dev["blocks"][3]["pw"]["w"].float().numpy(),
        torch.from_numpy(tree["blocks"][3]["pw"]["w"]).to(torch.bfloat16).float().numpy())
