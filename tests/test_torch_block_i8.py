"""The port's int8 kernels' plain versions (which the wrappers run on CPU
tensors) against the JAX package's Pallas int8 kernels in interpret mode:
the dense fused block at both strides, the lane-packed narrow block that
the port's dense kernel replaces, and the standalone depthwise. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack, unpack
from mobilenet_tpu.quant.pallas_block_i8 import separable_block_i8 as jax_block_i8
from mobilenet_tpu.ops.pallas_block_packed_mxu import separable_block_packed_i8_mxu
from mobilenet_tpu.quant.pallas_block_packed_i8 import separable_block_packed_i8
from mobilenet_tpu.quant.pallas_dw_i8 import depthwise_i8_pallas
from mobilenet_tpu_torch.ops.depthwise_i8 import depthwise_i8
from mobilenet_tpu_torch.ops.separable_block_i8 import separable_block_i8

DW_SIX_Q, PW_SIX_Q = 100.0, 90.0  # below 127: the in-domain ReLU6 clip is reached


def _inputs(seed, n, h, cin, cout):
    """x in [-127, 127], int8 weights, int32 biases, float32 multipliers
    that spread the requantized values over [0, six_q]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (n, h, h, cin)).astype(np.int8),
            rng.integers(-127, 128, (3, 3, 1, cin)).astype(np.int8),
            rng.integers(-5000, 5000, (cin,)).astype(np.int32),
            (rng.uniform(0.2, 1.5, (cin,)) * 4e-3).astype(np.float32),
            rng.integers(-127, 128, (cin, cout)).astype(np.int8),
            rng.integers(-5000, 5000, (cout,)).astype(np.int32),
            (rng.uniform(0.2, 1.5, (cout,)) * 2 / 60 / cin ** 0.5).astype(np.float32))


def _ours(arrs, stride, relu6=True):
    return separable_block_i8(*[torch.from_numpy(a) for a in arrs], stride, DW_SIX_Q,
                              PW_SIX_Q, relu6).numpy()


@pytest.mark.parametrize("stride,cout", [(1, 128), (1, 256), (2, 128), (2, 256)])
def test_dense_vs_pallas(stride, cout):
    arrs = _inputs(stride * 10 + cout, 2, 8, 128, cout)
    ref = jax_block_i8(*map(jnp.asarray, arrs), stride, DW_SIX_Q, PW_SIX_Q, True,
                       interpret=True)
    got = _ours(arrs, stride)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert 0 < (got == PW_SIX_Q).sum() < (got > 0).sum()


@pytest.mark.parametrize("cin,cout,stride", [(32, 64, 1), (64, 128, 2)])
def test_narrow_vs_packed(cin, cout, stride):
    """Blocks 0 and 1 at alpha 1.0 (32 -> 64 s1, 64 -> 128 s2): the TPU's
    lane-packed int8 kernel, through pack/unpack."""
    arrs = _inputs(cin, 2, 8, cin, cout)
    x, *w = map(jnp.asarray, arrs)
    ref = unpack(separable_block_packed_i8(pack(x, cin), *w, cin, cout, stride, DW_SIX_Q,
                                           PW_SIX_Q, True, interpret=True), cout)
    np.testing.assert_array_equal(_ours(arrs, stride), np.asarray(ref))


@pytest.mark.parametrize("n,h,cin,cout,stride", [
    (2, 16, 32, 64, 1), (2, 16, 64, 128, 2), (2, 16, 8, 16, 1), (2, 16, 16, 32, 2),
    (2, 8, 64, 128, 1), (1, 16, 64, 128, 2)])
def test_narrow_vs_packed_i8_mxu(n, h, cin, cout, stride):
    """V1's narrow int8 blocks against separable_block_packed_i8_mxu (both
    convolutions as s8 x s8 -> s32 matmuls, behind the DW_MXU_* knobs) in
    interpret mode, exactly: the port's int8 kernel computes its function
    (B20)."""
    arrs = _inputs(cin * 5 + stride, n, h, cin, cout)
    x, *w = map(jnp.asarray, arrs)
    ref = unpack(separable_block_packed_i8_mxu(pack(x, cin), *w, cin, cout, stride,
                                               DW_SIX_Q, PW_SIX_Q, True, interpret=True),
                 cout)
    got = _ours(arrs, stride)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert 0 < (got == PW_SIX_Q).sum() < (got > 0).sum()


def test_relu_without_clip():
    arrs = _inputs(3, 1, 6, 16, 24)
    arrs = arrs[:-1] + (arrs[-1] * 4,)  # outputs well above six_q
    got = _ours(arrs, 1, relu6=False)
    ref = jax_block_i8(*map(jnp.asarray, arrs), 1, DW_SIX_Q, PW_SIX_Q, False,
                       interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.max() > PW_SIX_Q


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_vs_pallas(stride):
    x, w, b, m, *_ = _inputs(stride, 2, 16, 64, 8)
    ref = depthwise_i8_pallas(*map(jnp.asarray, (x, w, b, m)), stride, DW_SIX_Q, True,
                              interpret=True)
    got = depthwise_i8(*[torch.from_numpy(a) for a in (x, w, b, m)], DW_SIX_Q, stride, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["dtype_x", "dtype_bias", "dtype_m", "shape", "stride",
                                  "noncontig", "channels", "misaligned"])
def test_wrappers_reject(case):
    """Both wrappers check dtypes (int8 x and weights, int32 biases, float32
    multipliers), shapes, strides, contiguity, alignment and channel counts
    (multiples of 8) before any launch."""
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = [torch.from_numpy(a)
                                             for a in _inputs(0, 1, 8, 16, 16)]
    stride = 1
    if case == "dtype_x":
        x = x.float()
    elif case == "dtype_bias":
        dw_b = dw_b.long()
    elif case == "dtype_m":
        dw_m = dw_m.double()
    elif case == "shape":
        dw_b = dw_b[:8].contiguous()
    elif case == "stride":
        stride = 3
    elif case == "noncontig":
        x = x.transpose(1, 2)
    elif case == "channels":
        x, dw_w, dw_b, dw_m = (x[..., :12].contiguous(), dw_w[..., :12].contiguous(),
                               dw_b[:12].contiguous(), dw_m[:12].contiguous())
        pw_w = pw_w[:12].contiguous()
    elif case == "misaligned":
        x = torch.empty(x.numel() + 1, dtype=torch.int8)[1:].view(x.shape)
    with pytest.raises(ValueError):
        separable_block_i8(x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride, DW_SIX_Q,
                           PW_SIX_Q, True)
    with pytest.raises(ValueError):
        depthwise_i8(x, dw_w, dw_b, dw_m, DW_SIX_Q, stride, True)
