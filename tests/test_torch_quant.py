"""The port's int8 quantizer, channel padding and plain int8 ops against the
JAX package's (`mobilenet_tpu/quant/quantize.py`, `checkpoints/padding.py`,
`quant/ops.py`, `quant/oracle.py`). Every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.checkpoints import padding as jax_padding
from mobilenet_tpu.ops import preprocess as jax_prep
from mobilenet_tpu.quant import oracle as jax_oracle
from mobilenet_tpu.quant import ops as jax_qops
from mobilenet_tpu.quant import quantize as jax_quantize
from mobilenet_tpu.quant.quantize import ACT_IN_SCALE as JAX_ACT_IN_SCALE
from mobilenet_tpu_torch import ModelConfig
from mobilenet_tpu_torch.checkpoints import padding
from mobilenet_tpu_torch.ops import preprocess as prep
from mobilenet_tpu_torch.quant import ACT_IN_SCALE, oracle, quantize, quantize_input
from mobilenet_tpu_torch.quant import ops as qops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_layers_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("alpha", [0.25, 0.75])
def test_quantize_and_padding_match_jax(alpha):
    """Field by field on the same folded tree; at alpha 0.75 (24/48/96
    channels) both padding passes apply first."""
    jcfg = JaxConfig(alpha, 128)
    folded = fold_bn(init_params(jcfg, seed=3), eps=jcfg.bn_eps)
    assert padding.needs_padding(folded) == jax_padding.needs_padding(folded) == (alpha == 0.75)
    ours_tree, ref_tree = padding.pad_channels(folded), jax_padding.pad_channels(folded)
    for path in (("conv1", "w"), ("conv1", "b"), ("fc", "w")):
        np.testing.assert_array_equal(ours_tree[path[0]][path[1]], ref_tree[path[0]][path[1]])
    ours = quantize(ours_tree, ModelConfig(alpha, 128))
    ref = jax_quantize(ref_tree, jcfg)
    _assert_layers_equal(ours.conv1, ref.conv1)
    assert len(ours.blocks) == len(ref.blocks) == 13
    for ob, rb in zip(ours.blocks, ref.blocks):
        _assert_layers_equal(ob["dw"], rb["dw"])
        _assert_layers_equal(ob["pw"], rb["pw"])
    for name in ("fc_w_i8", "fc_s_w", "fc_b_f32"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    if alpha == 0.75:
        assert ours.conv1.w_i8.shape[-1] == 32 and ours.blocks[0]["pw"].w_i8.shape == (32, 64)


def test_dw_bias_bound_refuses_degenerate_scale():
    jcfg = JaxConfig(0.25, 128)
    folded = fold_bn(init_params(jcfg, seed=0), eps=jcfg.bn_eps)
    folded["blocks"][2]["dw"]["w"] = folded["blocks"][2]["dw"]["w"] * 1e-5
    with pytest.raises(ValueError, match="dw bias"):
        quantize(folded, ModelConfig(0.25, 128))


@pytest.mark.parametrize("relu6", [True, False])
def test_requant_rounding(relu6):
    """acc * m on .5 boundaries rounds half to even (0.5 -> 0, 1.5 -> 2,
    2.5 -> 2); negatives clip to 0; relu6=False clips at 127, not six_q."""
    acc = np.array([[1, 3, 5, -1, -3, 7, 300, 1000]], np.int32)
    m = np.full((8,), 0.5, np.float32)
    six_q = np.float32(100.0)
    got = qops.requantize(_t(acc), _t(m), float(six_q), relu6).numpy()
    np.testing.assert_array_equal(got, oracle._requant(acc, m, six_q, relu6))
    np.testing.assert_array_equal(
        got, np.asarray(jax_qops.requantize(jnp.asarray(acc), jnp.asarray(m), float(six_q),
                                            relu6)))
    expect = [0, 2, 2, 0, 0, 4, 100 if relu6 else 127, 100 if relu6 else 127]
    np.testing.assert_array_equal(got[0], expect)


def test_quantize_input_all_uint8():
    """preprocess + quantize_input_dev over all 256 uint8 values equals the
    JAX device path and the host twin."""
    imgs = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    x = prep.preprocess(_t(imgs), 16)
    jx = jax_prep.preprocess(jnp.asarray(imgs), 16)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    got = qops.quantize_input_dev(x, ACT_IN_SCALE)
    assert got.dtype == torch.int8
    ref = np.asarray(jax_qops.quantize_input_dev(jx, JAX_ACT_IN_SCALE))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), quantize_input(np.asarray(jx)))
    assert got.min() == -127 and got.max() == 127


def _layer(rng, c, scale):
    return (rng.integers(-5000, 5000, (c,)).astype(np.int32),
            (rng.uniform(0.2, 1.5, (c,)) * scale).astype(np.float32))


@pytest.mark.parametrize("stride,h,c", [(1, 16, 8), (2, 16, 8), (1, 15, 24), (2, 14, 64),
                                        (2, 9, 16)])
def test_depthwise_i8_vs_jax(stride, h, c):
    rng = np.random.default_rng(h * c + stride)
    x = rng.integers(-127, 128, (2, h, h, c)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    b, m = _layer(rng, c, 4e-3)
    got = qops.depthwise_i8(_t(x), _t(w), _t(b), _t(m), 100.0, stride, True).numpy()
    np.testing.assert_array_equal(got, jax_oracle.dw3x3_i8(x, w, b, m, np.float32(100), stride))
    ref = jax_qops.depthwise_i8_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(m), 100.0, stride, True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert 0 < (got == 100).sum() < got.size


def test_pointwise_i8_vs_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (2, 5, 7, 96)).astype(np.int8)
    w = rng.integers(-127, 128, (96, 40)).astype(np.int8)
    b, m = _layer(rng, 40, 1e-4)
    got = qops.pointwise_i8(_t(x), _t(w), _t(b), _t(m), 127.0).numpy()
    np.testing.assert_array_equal(got, jax_oracle.pw_i8(x, w, b, m, np.float32(127)))
    ref = jax_qops.pointwise_i8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(m), 127.0)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("h", [16, 15])
def test_conv1_i8_vs_jax(h):
    """The stem at even and odd input sizes (TF-SAME lo=0 and lo=1 at s2),
    on int8 and on float-carried integers."""
    rng = np.random.default_rng(h)
    x = rng.integers(-127, 128, (2, h, h, 3)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, 16)).astype(np.int8)
    b, m = _layer(rng, 16, 2e-3)
    ref = jax_oracle.conv3x3_i8(x, w, b, m, np.float32(127), 2)
    for xq in (_t(x), _t(x).float()):
        got = qops.conv1_i8(xq, _t(w), _t(b), _t(m), 127.0).numpy()
        np.testing.assert_array_equal(got, ref)
    ref_jax = jax_qops.conv1_i8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(m), 127.0)
    np.testing.assert_array_equal(got, np.asarray(ref_jax))


def test_avgpool_and_fc_vs_jax():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 128, (3, 7, 7, 64)).astype(np.int8)
    got = qops.avgpool_i8(_t(x)).numpy()
    np.testing.assert_array_equal(got, jax_oracle.avgpool_i8(x))
    np.testing.assert_array_equal(got, np.asarray(jax_qops.avgpool_i8(jnp.asarray(x))))
    w = rng.integers(-127, 128, (64, 10)).astype(np.int8)
    s_w = rng.uniform(1e-3, 1e-2, (10,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (10,)).astype(np.float32)
    s_in = np.float32(6.0 / 127.0)
    logits = qops.fc_i8_logits(_t(got), _t(w), s_in, _t(s_w), _t(bias)).numpy()
    np.testing.assert_array_equal(logits, jax_oracle.fc_i8_logits(got, w, s_in, s_w, bias))
    ref = jax_qops.fc_i8_logits(jnp.asarray(got), jnp.asarray(w), s_in, jnp.asarray(s_w),
                                jnp.asarray(bias))
    np.testing.assert_array_equal(logits, np.asarray(ref))


def test_port_oracle_equals_jax_oracle():
    jcfg = JaxConfig(0.25, 128)
    q = jax_quantize(fold_bn(init_params(jcfg, seed=2), eps=jcfg.bn_eps), jcfg)
    x = quantize_input(np.random.default_rng(2).uniform(-1, 1, (1, 128, 128, 3)))
    ours, ours_acts = oracle.forward_all(q, x, ModelConfig(0.25, 128))
    ref, ref_acts = jax_oracle.forward_all(q, x, jcfg)
    assert list(ours_acts) == list(ref_acts)
    for k in ref_acts:
        np.testing.assert_array_equal(ours_acts[k], ref_acts[k], err_msg=k)
