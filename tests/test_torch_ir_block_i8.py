"""The port's int8 MobileNet-V2 block kernels (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas int8 kernels
in interpret mode, exactly: the int8 inverted-residual block at the shape
classes of tests/test_pallas_ir_i8.py (whole-tile and rows mode, forced
residual saturation); at stride 2 the lane-packed named-act expand block it
replaces on V2 block 1, and the V3 int8 kernel in the bridge form the JAX
package sends V2 block 13 through at batch 256; and the int8 separable
block's linear mode against the packed kernel's pw_linear=True (V2 block 0).
Also the plans of the Hopper tiles that V2's expanded blocks run on the card
(`v3_wgmma_plan` for bf16, `v3_i8_wgmma_plan` for int8, each its kernel's
fits-function), and the int8 tile's plain version with the ReLU6 requant
(`v3_block_i8_plain(act="relu6")`) against the V2 block's, at six_q 127 and
at a recalibrated bound below it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack, unpack
from mobilenet_tpu.quant import oracle as jax_oracle
from mobilenet_tpu.quant.pallas_block_packed_i8 import separable_block_packed_i8
from mobilenet_tpu.quant.pallas_expand_s2_i8 import expand_block_packed_s2_i8
from mobilenet_tpu.quant.pallas_ir_i8 import inverted_residual_pallas_i8
from mobilenet_tpu.quant.pallas_ir_v3_i8 import v3_block_pallas_i8
from mobilenet_tpu.quant.quantize import ACT_HIDDEN_SCALE, _quant_layer
from mobilenet_tpu.quant.v2 import pw_i8_linear
from mobilenet_tpu_torch import V2Config
from mobilenet_tpu_torch.ops.inverted_residual_i8 import (
    inverted_residual_i8, inverted_residual_i8_plain,
)
from mobilenet_tpu_torch.ops.separable_block_i8 import separable_block_i8
from mobilenet_tpu_torch.ops.v3_block import (
    V3W_SMEM_LIMIT, V3W_TM, v3_wgmma_plan, v3_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_block_i8 import (
    FULL, I8W_SMEM_LIMIT, I8W_TM, v3_block_i8_plain, v3_i8_wgmma_plan, v3_i8_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.quant.model import device_layer


def _qcase(rng, cin, e, cout, s_out=np.float32(0.05)):
    """The JAX int8 IR tests' quantized block (tests/test_pallas_ir_i8.py
    _qcase): the expansion and depthwise at the fixed 6/127 scale (six_q
    127), the projection into a bottleneck scale s_out."""
    qe = _quant_layer((rng.normal(0, 1, (cin, e)) * cin ** -0.5).astype(np.float32),
                      rng.normal(0, 0.1, (e,)).astype(np.float32), out_axis=1,
                      s_in=s_out, s_out=ACT_HIDDEN_SCALE)
    qd = _quant_layer(rng.normal(0, 0.3, (3, 3, 1, e)).astype(np.float32),
                      rng.normal(0, 0.1, (e,)).astype(np.float32), out_axis=3,
                      s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE, f32_bias_bound=True)
    qp = _quant_layer((rng.normal(0, 1, (e, cout)) * e ** -0.5).astype(np.float32),
                      rng.normal(0, 0.1, (cout,)).astype(np.float32), out_axis=1,
                      s_in=ACT_HIDDEN_SCALE, s_out=s_out)
    return qe, qd, qp


def _ours(x_i8, qe, qd, qp, stride, residual):
    t = torch.from_numpy
    return inverted_residual_i8(
        t(x_i8), t(qe.w_i8), t(qe.bias_i32), t(qe.m), float(qe.six_q), t(qd.w_i8),
        t(qd.bias_i32), t(qd.m), float(qd.six_q), t(qp.w_i8), t(qp.bias_i32), t(qp.m),
        stride, residual).numpy()


def _pallas(x_i8, qe, qd, qp, stride, residual):
    return np.asarray(inverted_residual_pallas_i8(
        jnp.asarray(x_i8), jnp.asarray(qe.w_i8), jnp.asarray(qe.bias_i32), qe.m,
        float(qe.six_q), jnp.asarray(qd.w_i8), jnp.asarray(qd.bias_i32), qd.m,
        float(qd.six_q), jnp.asarray(qp.w_i8), jnp.asarray(qp.bias_i32), qp.m, stride,
        residual, interpret=True))


@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    # whole-tile classes: E not a multiple of 32 chunks, both strides, the
    # 960-wide tail
    (2, 14, 64, 384, 64, 1, True),
    (2, 14, 96, 576, 160, 2, False),
    (2, 7, 160, 960, 320, 1, False),
    (2, 28, 24, 144, 32, 2, False),
    (1, 8, 160, 960, 160, 1, True),
    # rows-mode classes: the big-spatial blocks (s2 halo, residual across tiles)
    (2, 112, 16, 96, 24, 2, False),
    (2, 56, 24, 144, 24, 1, True),
    (1, 48, 24, 144, 24, 1, True),
])
def test_ir_i8_vs_pallas(n, h, cin, e, cout, stride, residual):
    rng = np.random.default_rng(n * h + cin + e)
    qe, qd, qp = _qcase(rng, cin, e, cout)
    x_i8 = rng.integers(-100, 101, (n, h, h, cin)).astype(np.int8)
    got = _ours(x_i8, qe, qd, qp, stride, residual)
    assert got.dtype == np.int8 and got.shape == (n, -(-h // stride), -(-h // stride), cout)
    np.testing.assert_array_equal(got, _pallas(x_i8, qe, qd, qp, stride, residual))


def test_ir_i8_residual_saturation():
    """Inputs at the int8 rails: the saturating add clips as the Pallas
    kernel's and the oracle's int32-add-then-clip does."""
    rng = np.random.default_rng(80)
    qe, qd, qp = _qcase(rng, 32, 192, 32, s_out=np.float32(0.5))
    x_i8 = np.where(rng.random((1, 8, 8, 32)) < 0.5, 120, -120).astype(np.int8)
    got = _ours(x_i8, qe, qd, qp, 1, True)
    np.testing.assert_array_equal(got, _pallas(x_i8, qe, qd, qp, 1, True))
    assert (np.abs(got.astype(np.int32)) >= 127).any()


@pytest.mark.parametrize("fold", [False, True])
def test_stride2_vs_expand_block_packed_s2_i8(fold):
    """V2 block 1's class (16 -> 24, E 96, s2) against the lane-packed
    named-act kernel, called as the JAX V2 route calls it: a = m, inv_s =
    1.0, "relu" (six_q == 127), Cout padded 24 -> 32 with zero channels, the
    input carried as bf16 integers. The folded and unfolded named requants
    agree at inv_s = 1.0."""
    rng = np.random.default_rng(1)
    n, h, cin, e, cout, coutp = 2, 16, 16, 96, 24, 32
    qe, qd, qp = _qcase(rng, cin, e, cout)
    assert float(qe.six_q) == 127.0 and float(qd.six_q) == 127.0
    x_i8 = rng.integers(-100, 101, (n, h, h, cin)).astype(np.int8)
    j = jnp.asarray
    pad = coutp - cout
    out = expand_block_packed_s2_i8(
        pack(j(x_i8).astype(jnp.bfloat16), cin), j(qe.w_i8), j(qe.bias_i32), j(qe.m),
        j(qd.w_i8), j(qd.bias_i32), j(qd.m), j(np.pad(qp.w_i8, ((0, 0), (0, pad)))),
        j(np.pad(qp.bias_i32, (0, pad))), j(np.pad(qp.m, (0, pad))), cin, "relu", 1.0, 1.0,
        1.0, out_dtype="int8", interpret=True, fold=fold)
    ref = np.asarray(out).reshape(n, h // 2, h // 2, coutp)
    assert not ref[..., cout:].any()
    np.testing.assert_array_equal(_ours(x_i8, qe, qd, qp, 2, False), ref[..., :cout])


def test_block13_vs_v3_bridge():
    """V2 block 13's class (14^2 96 -> 160, E 576, s2) against the named V3
    int8 kernel in the form the JAX V2 route bridges it onto at batch 256
    (k 3, relu, no SE, a = m, inv_s = 1.0)."""
    rng = np.random.default_rng(13)
    n, h, cin, e, cout = 2, 14, 96, 576, 160
    qe, qd, qp = _qcase(rng, cin, e, cout)
    x_i8 = rng.integers(-100, 101, (n, h, h, cin)).astype(np.int8)

    def named(q):
        return {"w": jnp.asarray(q.w_i8), "b": jnp.asarray(q.bias_i32),
                "a": jnp.asarray(q.m), "inv_s": 1.0}

    ref = v3_block_pallas_i8(jnp.asarray(x_i8), named(qe), named(qd), named(qp), k=3,
                             stride=2, act="relu", residual=False, out_dtype=jnp.int8,
                             interpret=True, fold=True)
    np.testing.assert_array_equal(_ours(x_i8, qe, qd, qp, 2, False), np.asarray(ref))


def test_block0_linear_vs_packed_i8():
    """V2 block 0's class (32 -> 16, s1, linear projection): the int8
    separable block with pw_linear=True against the packed kernel's
    pw_linear=True, called as the JAX V2 route calls it (Cout padded 16 ->
    32 with zero w/b/m; the padded channels are exact zeros, dropped here)."""
    rng = np.random.default_rng(0)
    n, h, cin, cout, coutp = 2, 16, 32, 16, 32
    qd = _quant_layer(rng.normal(0, 0.3, (3, 3, 1, cin)).astype(np.float32),
                      rng.normal(0, 0.1, (cin,)).astype(np.float32), out_axis=3,
                      s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE, f32_bias_bound=True)
    qp = _quant_layer((rng.normal(0, 1, (cin, cout)) * cin ** -0.5).astype(np.float32),
                      rng.normal(0, 0.1, (cout,)).astype(np.float32), out_axis=1,
                      s_in=ACT_HIDDEN_SCALE, s_out=np.float32(0.02))
    x_i8 = rng.integers(0, 128, (n, h, h, cin)).astype(np.int8)  # a ReLU6 activation
    pad = coutp - cout
    j = jnp.asarray
    out = separable_block_packed_i8(
        pack(j(x_i8), cin), j(qd.w_i8), j(qd.bias_i32), j(qd.m),
        j(np.pad(qp.w_i8, ((0, 0), (0, pad)))), j(np.pad(qp.bias_i32, (0, pad))),
        j(np.pad(qp.m, (0, pad))), cin, coutp, 1, float(qd.six_q), 0.0, True,
        pw_linear=True, interpret=True)
    ref = np.asarray(unpack(out, coutp))
    t = torch.from_numpy
    got = separable_block_i8(t(x_i8), t(qd.w_i8), t(qd.bias_i32), t(qd.m), t(qp.w_i8),
                             t(qp.bias_i32), t(qp.m), 1, float(qd.six_q), 0.0, True,
                             pw_linear=True).numpy()
    np.testing.assert_array_equal(got, ref[..., :cout])
    assert (got < 0).any() and not ref[..., cout:].any()  # linear: negatives survive


def test_plain_pads_the_expanded_activation():
    """SAME padding pads the int8 expansion with zeros (the oracle's
    dw3x3_i8 pads its int8 input), not with requant(bias): with a large
    expand bias, padding the input instead changes the border outputs."""
    rng = np.random.default_rng(5)
    qe, qd, qp = _qcase(rng, 8, 16, 8)
    qe.bias_i32[:] = 200000  # requant(bias) = six_q at a zero input pixel
    x_i8 = rng.integers(-100, 101, (1, 4, 4, 8)).astype(np.int8)
    got = _ours(x_i8, qe, qd, qp, 1, False)
    z = jax_oracle.pw_i8(x_i8, qe.w_i8, qe.bias_i32, qe.m, qe.six_q)
    want = pw_i8_linear(jax_oracle.dw3x3_i8(z, qd.w_i8, qd.bias_i32, qd.m, qd.six_q, 1),
                        qp.w_i8, qp.bias_i32, qp.m)
    np.testing.assert_array_equal(got, want)
    zp = jax_oracle.pw_i8(np.pad(x_i8, ((0, 0), (1, 1), (1, 1), (0, 0))), qe.w_i8,
                          qe.bias_i32, qe.m, qe.six_q)
    acc = sum(zp[:, dy:dy + 4, dx:dx + 4].astype(np.int32) * qd.w_i8[dy, dx, 0]
              for dy in range(3) for dx in range(3))
    wrong = pw_i8_linear(jax_oracle._requant(acc + qd.bias_i32, qd.m, qd.six_q), qp.w_i8,
                         qp.bias_i32, qp.m)
    assert not np.array_equal(got[:, 0], wrong[:, 0])
    np.testing.assert_array_equal(got[:, 1:3, 1:3], wrong[:, 1:3, 1:3])


@pytest.mark.parametrize("alpha", [0.35, 1.0, 1.4])
def test_every_v2_block_has_a_tile(alpha):
    """Every expanded block of V2 at 224 has a plan of both Hopper tiles at
    batch 1 and 256 (bf16: `v3_wgmma_plan`; int8: `v3_i8_wgmma_plan`, block
    13 included, which the JAX package bridges onto its V3 kernel), each
    within the shared-memory limit: the port has no fallback."""
    h = 112
    for t, cin, cout, stride in V2Config(alpha, 224).block_defs:
        if t > 1:
            e = t * cin
            for n in (1, 256):
                p = v3_wgmma_plan(n, h, h, cin, e, cout, 3, stride, 0, False)
                assert p is not None and p.th * p.tw <= V3W_TM, (n, h, cin, cout, stride)
                assert v3_wgmma_smem_bytes(p.th, p.tw, cin, e, cout, 3, stride, p.cw, p.ws,
                                           p.bs, False) <= V3W_SMEM_LIMIT
                q = v3_i8_wgmma_plan(n, h, h, cin, e, cout, 3, stride, 0, False)
                assert q is not None and q.th * q.tw <= I8W_TM, (n, h, cin, cout, stride)
                assert v3_i8_wgmma_smem_bytes(q.th, q.tw, cin, e, cout, 3, stride, q.cw, q.ws,
                                              q.bs, False, FULL) <= I8W_SMEM_LIMIT
        h //= stride


@pytest.mark.parametrize("six_q", [127.0, 100.37])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 8, 16, 96, 24, 2, False),     # b01's widths at stride 2
    (2, 7, 24, 144, 24, 1, True),     # b02: Cin 24, residual, odd side
    (1, 6, 64, 384, 96, 1, False),    # b10: E 384 = three 128-channel chunks
    (1, 4, 160, 960, 320, 1, False),  # b16: E tail of 64 past 7 chunks
    (2, 9, 8, 48, 8, 1, True),        # alpha 0.35's narrowest: Cin 8
])
def test_v3_block_i8_relu6_is_the_v2_block(six_q, n, h, cin, e, cout, stride, residual):
    """The int8 tile's plain version with the ReLU6 requant on V2's layers
    (`quant/model.device_layer`) equals the V2 block's plain version bit for
    bit, with six_q at the fixed 127 and at a recalibrated 100.37, where the
    bound clips."""
    rng = np.random.default_rng(n + h + e + int(six_q))
    qe, qd, qp = _qcase(rng, cin, e, cout)
    qe.six_q = qd.six_q = np.float32(six_q)
    x_i8 = rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    exp, dw, prj = (device_layer(q, "cpu") for q in (qe, qd, qp))
    t = torch.from_numpy
    want = inverted_residual_i8_plain(
        t(x_i8), exp["w"], exp["b"], exp["m"], exp["six_q"], dw["w"], dw["b"], dw["m"],
        dw["six_q"], prj["w"], prj["b"], prj["m"], stride, residual)
    got = v3_block_i8_plain(t(x_i8), exp, dw, prj, k=3, stride=stride, act="relu6",
                            residual=residual)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert np.array_equal(want.numpy(), _ours(x_i8, qe, qd, qp, stride, residual))
    z = jax_oracle.pw_i8(x_i8, qe.w_i8, qe.bias_i32, qe.m, qe.six_q)
    assert int(z.max()) == min(round(six_q), 127)  # the bound is reached


@pytest.mark.parametrize("case", ["dtype_x", "dtype_m", "shape", "stride", "residual_s2",
                                  "channels", "odd_s2", "misaligned"])
def test_wrapper_rejects(case):
    """The wrapper checks dtypes, shapes, stride, the residual's shape,
    channel counts (multiples of 8), the tile plan and alignment before any
    launch."""
    rng = np.random.default_rng(2)
    qe, qd, qp = _qcase(rng, 16, 96, 16)
    t = torch.from_numpy
    x = t(rng.integers(-100, 101, (1, 6, 6, 16)).astype(np.int8))
    args = [x, t(qe.w_i8), t(qe.bias_i32), t(qe.m), 127.0, t(qd.w_i8), t(qd.bias_i32),
            t(qd.m), 127.0, t(qp.w_i8), t(qp.bias_i32), t(qp.m), 1, True]
    if case == "dtype_x":
        args[0] = x.float()
    elif case == "dtype_m":
        args[3] = args[3].double()
    elif case == "shape":
        args[10] = args[10][:8].contiguous()
    elif case == "stride":
        args[12], args[13] = 3, False
    elif case == "residual_s2":
        args[12] = 2
    elif case == "channels":
        args[0] = x[..., :12].contiguous()
        args[1] = args[1][:12].contiguous()
    elif case == "odd_s2":
        args[0], args[12], args[13] = x[:, :5, :5].contiguous(), 2, False
    elif case == "misaligned":
        args[0] = torch.empty(x.numel() + 1, dtype=torch.int8)[1:].view(x.shape)
    with pytest.raises(ValueError):
        inverted_residual_i8(*args)


def test_int8_plan_tie_goes_to_fewer_units():
    """V2 1.0-224 b11-b12 (14^2 x 96, E 576): the int8 plan's time model puts
    5x14 and 7x14 within its tie band (0.26% apart); the tie goes to 7x14's
    fewer units, the tile the card ran 20% faster."""
    p = v3_i8_wgmma_plan(256, 14, 14, 96, 576, 96, 3, 1, 0, False)
    assert (p.th, p.tw, p.split) == (7, 14, 1)
