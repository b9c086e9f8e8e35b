"""The port's int8 MobileNet-V3 bottleneck kernel (its plain version, which
the wrapper runs on CPU tensors) against the JAX package's int8 kernels in
interpret mode, EXACT: `v3_block_pallas_i8` at the V3-Large and -Small
block classes (identity and expansion, k 3 and 5, stride 1 and 2, the
quantized SE gate with non-zero biases, relu and hswish, residual on and
off, one that saturates), the lane-packed named-act kernels of V3-Large's
blocks 0 and 1, `packed_block_i8_named` and `packed_block_i8_named_s2`
(after `packed_expand_i8_named`), and V3-Small's block 0,
`packed_block_i8_named_s2_se` (identity, stride 2, the quantized SE), which
the port's kernel also takes. Every JAX kernel gets `fold=` explicitly:
True (the folded requant order, the only one the port has), and for
V3-Small's block 0 also False, whose relu and linear requants the port's
folded order matches there. Also the kernel's plan (`v3_i8_wgmma_plan`),
which is its fits-function."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack
from mobilenet_tpu.quant.pallas_block_packed_i8 import (
    packed_block_i8_named, packed_block_i8_named_s2, packed_block_i8_named_s2_se,
    packed_expand_i8_named,
)
from mobilenet_tpu.quant.pallas_ir_v3_i8 import v3_block_pallas_i8
from mobilenet_tpu_torch import V3Config
from mobilenet_tpu_torch.checkpoints import fold_bn_v3, init_params_v3
from mobilenet_tpu_torch.ops.v3_block import SMEM_MAX
from mobilenet_tpu_torch.ops.v3_block_i8 import (
    FULL, GATED, I8W_TM, POOL, v3_block_i8, v3_block_i8_plain, v3_i8_wgmma_plan,
    v3_i8_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.quant.v3 import _quant_named, device_layer_v3, quantize_v3


def _layers(seed, cin, e, cout, k, se, identity, prj_gain=1.0):
    """QLayerN's of one block, quantized from random float weights with
    non-zero biases at fixed scales (input 0.05, expansion and depthwise
    0.06, SE mid 0.03, the projection at the input's scale / prj_gain)."""
    rng = np.random.default_rng(seed)

    def lay(shape, axis, s_in, s_out, scale, b_scale, **kw):
        w = rng.normal(0, scale, shape).astype(np.float32)
        b = rng.normal(0, b_scale, (shape[axis],)).astype(np.float32)
        return _quant_named(w, b, axis, s_in, s_out, **kw)

    s_x, s_e, s_d, s_g = 0.05, 0.06, 0.06, 0.03
    q = {"dw": lay((k, k, 1, e), 3, s_x if identity else s_e, s_d, 0.3, 0.2, k_taps=k * k),
         "prj": lay((e, cout), 1, s_d, s_x / prj_gain, e ** -0.5, 0.2)}
    if not identity:
        q["exp"] = lay((cin, e), 1, s_x, s_e, 1.5 * cin ** -0.5, 0.3)
    if se:
        q["se1"] = lay((e, se), 1, s_d, s_g, e ** -0.5, 0.3)
        q["se2"] = lay((se, e), 1, s_g, 1.0, se ** -0.5, 0.3)
    return q


def _jax(layer):
    return {"w": jnp.asarray(layer.w_i8), "b": jnp.asarray(layer.bias_i32),
            "a": jnp.asarray(layer.a), "inv_s": float(layer.inv_s)}


def _port(x_i8, q, **kw):
    dev = {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}
    got = v3_block_i8(torch.from_numpy(x_i8), dev.get("exp"), dev["dw"], dev["prj"],
                      se1=dev.get("se1"), se2=dev.get("se2"), **kw)
    assert got.dtype == torch.int8
    return got.numpy()


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 8, 16, 16, 16, 3, 1, 0, "relu", True, True),          # V3-L b00: identity
    (2, 8, 16, 64, 24, 3, 2, 0, "relu", False, False),        # b01: expansion at s2
    (2, 8, 24, 72, 24, 3, 1, 0, "relu", True, False),         # b02
    (2, 8, 24, 72, 40, 5, 2, 24, "relu", False, False),       # b03: k5 s2 SE, E tail chunk
    (1, 6, 40, 120, 40, 5, 1, 32, "relu", True, False),       # b04: SE + residual
    (2, 8, 40, 240, 80, 3, 2, 0, "hswish", False, False),     # b06
    (1, 5, 80, 184, 80, 3, 1, 0, "hswish", True, False),      # b08: odd side
    (1, 4, 80, 480, 112, 3, 1, 120, "hswish", False, False),  # b10: SE at k 3
    (1, 6, 112, 672, 160, 5, 2, 168, "hswish", False, False),  # b12
    (1, 4, 160, 960, 160, 5, 1, 240, "hswish", True, False),  # b13: the widest
    (2, 8, 16, 16, 16, 3, 2, 8, "relu", False, True),         # V3-S b00: identity, s2, SE
    (1, 6, 48, 144, 48, 5, 1, 40, "hswish", True, False),     # V3-S b07
])
def test_vs_v3_block_pallas_i8(n, h, cin, e, cout, k, stride, se, act, residual, identity):
    q = _layers(n * h + cin + e + k, cin, e, cout, k, se, identity)
    x = np.random.default_rng(e).integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    kw = dict(k=k, stride=stride, act=act, residual=residual)
    want = v3_block_pallas_i8(jnp.asarray(x), None if identity else _jax(q["exp"]),
                              _jax(q["dw"]), _jax(q["prj"]),
                              se1=_jax(q["se1"]) if se else None,
                              se2=_jax(q["se2"]) if se else None, interpret=True, fold=True,
                              **kw)
    got = _port(x, q, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got < 0).any() and (got > 0).any()


def test_saturating_residual_vs_pallas():
    """Inputs at the rails and a projection driven past the int8 range: the
    residual add saturates at both rails, equal to the JAX kernel."""
    q = _layers(3, 40, 120, 40, 5, 32, False, prj_gain=8.0)
    rng = np.random.default_rng(4)
    x = np.where(rng.random((1, 6, 6, 40)) < 0.5, 120, -120).astype(np.int8)
    kw = dict(k=5, stride=1, act="hswish", residual=True)
    want = v3_block_pallas_i8(jnp.asarray(x), _jax(q["exp"]), _jax(q["dw"]), _jax(q["prj"]),
                              se1=_jax(q["se1"]), se2=_jax(q["se2"]), interpret=True,
                              fold=True, **kw)
    got = _port(x, q, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got == 127).any() and (got == -128).any()


@pytest.mark.parametrize("residual", [False, True])
def test_block0_vs_packed_block_i8_named(residual):
    """V3-Large block 0 (112² x 16 in the network; 8 x 16 here): the JAX
    package's lane-packed named-act kernel on the bf16-carried input, with
    the residual added outside it in the packed domain as quant/v3.py does,
    against the port's kernel with the identity expansion."""
    q = _layers(11, 16, 16, 16, 3, 0, True)
    x = np.random.default_rng(12).integers(-128, 128, (2, 8, 16, 16)).astype(np.int8)
    xp = pack(jnp.asarray(x, jnp.bfloat16), 16)
    d, p = q["dw"], q["prj"]
    yp = packed_block_i8_named(xp, jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32),
                               jnp.asarray(d.a), jnp.asarray(p.w_i8), jnp.asarray(p.bias_i32),
                               jnp.asarray(p.a), 16, 16, "relu", float(d.inv_s),
                               float(p.inv_s), out_dtype="bfloat16", interpret=True, fold=True)
    if residual:
        yp = jnp.clip(yp.astype(jnp.float32) + xp.astype(jnp.float32), -128, 127)
    want = np.asarray(yp.astype(jnp.float32)).reshape(2, 8, 16, 16).astype(np.int8)
    got = _port(x, q, k=3, stride=1, act="relu", residual=residual)
    np.testing.assert_array_equal(got, want)


def test_block1_vs_packed_block_i8_named_s2():
    """V3-Large block 1 (112² x 16 -> E64 -> 24 at stride 2; 8 x 16 here):
    the JAX package's XLA expansion `packed_expand_i8_named`, then the
    lane-packed stride-2 named-act kernel with the projection padded to 128
    zero columns, against the port's kernel with its own expansion."""
    q = _layers(13, 16, 64, 24, 3, 0, False)
    x = np.random.default_rng(14).integers(-128, 128, (2, 8, 16, 16)).astype(np.int8)
    ex, d, p = q["exp"], q["dw"], q["prj"]
    ye = packed_expand_i8_named(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ex.w_i8),
                                jnp.asarray(ex.bias_i32), jnp.asarray(ex.a), ex.inv_s, "relu")
    pad = ((0, 0), (0, 128 - 24))
    yp = packed_block_i8_named_s2(
        pack(ye, 64), jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32), jnp.asarray(d.a),
        jnp.pad(jnp.asarray(p.w_i8), pad), jnp.pad(jnp.asarray(p.bias_i32), pad[1]),
        jnp.pad(jnp.asarray(p.a), pad[1]), 64, 128, "relu", float(d.inv_s), float(p.inv_s),
        out_dtype="int8", interpret=True, fold=True)
    want = np.asarray(yp).reshape(2, 4, 8, 128)[..., :24]
    got = _port(x, q, k=3, stride=2, act="relu")
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _small_224_b0():
    """V3-Small 1.0-224's block-0 QLayerN's (dw, se1, se2, prj), calibrated
    on 8 images from the seed-0 weights."""
    cfg = V3Config("small", 1.0, 224)
    q = quantize_v3(fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps), cfg, n_calib=8)
    return q.blocks[0]


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("shape,layers", [((1, 112, 112, 16), "small_224_b0"),
                                          ((2, 56, 56, 16), "random")])
def test_small_block0_vs_packed_block_i8_named_s2_se(shape, layers, fold):
    """V3-Small block 0 (112² x 16 -> 16, identity, k 3, stride 2, SE 8,
    relu): the JAX package's lane-packed kernel with the in-kernel
    quantized SE, called as quant/v3.py calls it (the bf16-carried input
    packed, the projection padded to cout_p zero columns, the output
    reshaped and sliced back to 16 channels), against the port's kernel
    with the identity expansion, exactly, with fold= True and False."""
    q = _small_224_b0() if layers == "small_224_b0" else _layers(21, 16, 16, 16, 3, 8, True)
    x = np.random.default_rng(22).integers(-128, 128, shape).astype(np.int8)
    d, p, s1, s2 = q["dw"], q["prj"], q["se1"], q["se2"]
    assert tuple(s1.w_i8.shape) == (16, 8)
    cin, r2 = 16, (128 // 16) // 2
    cout_p = -(-16 // (128 // r2)) * (128 // r2)
    pad = (0, cout_p - 16)
    yp = packed_block_i8_named_s2_se(
        pack(jnp.asarray(x, jnp.bfloat16), cin), jnp.asarray(d.w_i8), jnp.asarray(d.bias_i32),
        jnp.asarray(d.a), jnp.asarray(s1.w_i8), jnp.asarray(s1.bias_i32), jnp.asarray(s1.a),
        jnp.asarray(s2.w_i8), jnp.asarray(s2.bias_i32), jnp.asarray(s2.a),
        jnp.pad(jnp.asarray(p.w_i8), ((0, 0), pad)), jnp.pad(jnp.asarray(p.bias_i32), pad),
        jnp.pad(jnp.asarray(p.a), pad), cin, cout_p, "relu", float(d.inv_s), float(s1.inv_s),
        float(p.inv_s), out_dtype="int8", interpret=True, fold=fold)
    yp = np.asarray(yp)
    want = yp.reshape(yp.shape[0], yp.shape[1], -1, cout_p)[..., :16]
    got = _port(x, {"dw": d, "prj": p, "se1": s1, "se2": s2}, k=3, stride=2, act="relu")
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 16)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got > 0).any()
    for n in (256, 1):
        assert v3_i8_wgmma_plan(n, 112, 112, 16, 16, 16, 3, 2, 8, True) is not None


@pytest.mark.parametrize("variant", ["large", "small"])
def test_every_v3_block_has_an_int8_tile(variant):
    """Every V3 block at 1.0-224 has a plan of the int8 kernel at batch 1
    and 256: every pass it launches within the shared-memory limit, a tile
    of at most 128 outputs, whole parts of Cout."""
    h = 112
    for bd in V3Config(variant, 1.0, 224).block_defs:
        ident = not bd.has_expand
        for n in (1, 256):
            p = v3_i8_wgmma_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                 bd.se_mid, ident)
            for mode in ((POOL, GATED) if bd.se_mid else (FULL,)):
                assert v3_i8_wgmma_smem_bytes(p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel,
                                              bd.stride, p.cw, p.ws, p.bs, ident,
                                              mode) <= SMEM_MAX
            assert p.th * p.tw <= I8W_TM and p.split * p.cw == bd.cout
        h //= bd.stride


def test_wrapper_rejects_what_no_kernel_takes():
    q = _layers(1, 16, 64, 16, 3, 16, False)
    dev = {name: device_layer_v3(layer, "cpu") for name, layer in q.items()}
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    args = (x, dev["exp"], dev["dw"], dev["prj"])
    se = dict(se1=dev["se1"], se2=dev["se2"])
    with pytest.raises(ValueError):  # a residual at stride 2
        v3_block_i8(*args, k=3, stride=2, act="relu", residual=True, **se)
    with pytest.raises(ValueError):  # half of the SE
        v3_block_i8(*args, k=3, stride=1, act="relu", se1=dev["se1"])
    with pytest.raises(ValueError):  # 3x3 weights at k 5
        v3_block_i8(*args, k=5, stride=1, act="relu", **se)
    with pytest.raises(ValueError):  # relu6 is not a named int8 activation
        v3_block_i8(*args, k=3, stride=1, act="relu6", **se)
    with pytest.raises(ValueError):  # a float input
        v3_block_i8(x.float(), *args[1:], k=3, stride=1, act="relu", **se)
    with pytest.raises(ValueError):  # odd input at stride 2
        v3_block_i8(x[:, :7].contiguous(), *args[1:], k=3, stride=2, act="relu", **se)
    assert v3_i8_wgmma_plan(1, 8, 8, 16, 64, 16, 7, 1, 0, False) is None  # no k 7
    want = v3_block_i8_plain(x, dev["exp"], dev["dw"], dev["prj"], k=3, stride=1, act="relu")
    assert torch.equal(v3_block_i8(*args, k=3, stride=1, act="relu"), want)
