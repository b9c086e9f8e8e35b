"""The port's standalone depthwise kernel (its plain version, which the
wrapper runs on CPU tensors) against the JAX package's
`depthwise_conv_pallas` in interpret mode, at the shapes of
tests/test_pallas_dw.py (float32 within atol 2e-6, rtol 1e-6), relu and
relu6, bf16, an odd spatial size at stride 2; and the wrapper's checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_dw import depthwise_conv_pallas
from mobilenet_tpu_torch.ops import depthwise as dw_mod
from mobilenet_tpu_torch.ops.conv import depthwise_conv
from mobilenet_tpu_torch.ops.depthwise import depthwise, depthwise_plain


def _operands(seed, n, h, c, dtype=np.float32, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, h, h, c)).astype(dtype)
    w = rng.normal(0, 0.5, (3, 3, 1, c)).astype(dtype)
    b = rng.normal(0, 0.2, (c,)).astype(dtype) if bias else None
    return x, w, b


def _both(x, w, b, stride, relu6, jdtype=None):
    jx = lambda a: None if a is None else jnp.asarray(a, jdtype)  # noqa: E731
    want = depthwise_conv_pallas(jx(x), jx(w), stride, jx(b), relu6, interpret=True)
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = depthwise(tt(x), tt(w), stride, tt(b), relu6)
    return got, want


# The shapes of tests/test_pallas_dw.py: V1 layers at 1.0-224 and 0.25-128.
@pytest.mark.parametrize("h,c,stride", [
    (112, 32, 1),   # block00 @ 1.0-224
    (112, 64, 2),   # block01
    (56, 128, 1),   # block02
    (28, 256, 2),   # block05
    (14, 512, 1),   # block06..10
    (7, 1024, 1),   # block12
    (64, 8, 1),     # 0.25-128 stem out
    (16, 64, 2),    # 0.25 late block
    (8, 256, 2),    # small spatial stride 2
    (4, 256, 1),    # 0.25-128 final 4x4
])
def test_vs_depthwise_conv_pallas(h, c, stride):
    x, w, b = _operands(h + c + stride, 2, h, c)
    got, want = _both(x, w, b, stride, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("relu6", [True, False])
def test_relu_and_relu6(relu6):
    x, w, b = _operands(1, 1, 14, 128)
    got, want = _both(x, w, b, 1, relu6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)
    assert (got.numpy() > 6).any() != relu6


def test_bfloat16():
    """bf16 in and out, float32 accumulation, one rounding at the end: the
    JAX kernel on bf16 operands gives the same bits or one bf16 step apart
    (a last-bit difference of the float32 sums)."""
    x, w, b = _operands(2, 1, 14, 256)
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = depthwise(tb(x), tb(w), 1, tb(b), True)
    want = depthwise_conv_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1,
                                 jnp.asarray(b, jnp.bfloat16), True, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0, rtol=2 ** -8)


def test_odd_spatial_stride2():
    """7x7 at stride 2 -> 4x4: TF-SAME pads (1, 1), no bias."""
    x, w, _ = _operands(3, 1, 7, 32, bias=False)
    got, want = _both(x, w, None, 2, True)
    assert got.shape == (1, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


def test_float32_equals_the_plain_route_op():
    """In float32 the kernel's function is the plain route's depthwise op
    (the bias after the float32 sum either way), bit for bit."""
    x, w, b = (torch.from_numpy(a) for a in _operands(4, 2, 15, 48))
    for stride in (1, 2):
        assert torch.equal(depthwise_plain(x, w, stride, b),
                           depthwise_conv(x, w, stride, bias=b, relu6=True))


def test_cpu_tensors_never_launch():
    x, w, b = (torch.from_numpy(a) for a in _operands(5, 1, 8, 16))
    before = dw_mod.depthwise.launches
    depthwise(x, w, 1, b)
    assert dw_mod.depthwise.launches == before


def test_wrapper_validation():
    x, w, b = (torch.from_numpy(a) for a in _operands(6, 1, 8, 16))
    with pytest.raises(ValueError, match="does not fit"):
        depthwise(x, w[..., :8].contiguous(), 1, b)
    with pytest.raises(ValueError, match="does not fit"):
        depthwise(x, w, 1, b[:8].contiguous())
    with pytest.raises(ValueError, match="stride"):
        depthwise(x, w, 3, b)
    with pytest.raises(ValueError, match="NHWC"):
        depthwise(x[0], w, 1, b)
    with pytest.raises(ValueError, match="dtypes"):
        depthwise(x, w.double(), 1, b)
    with pytest.raises(ValueError, match="dtype"):
        depthwise(x.double(), w.double(), 1, b.double())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise(x.transpose(1, 2), w, 1, b)
    xc, wc, bc = (torch.from_numpy(a) for a in _operands(7, 1, 8, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        depthwise(xc, wc, 1, bc)
