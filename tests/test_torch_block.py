"""The port's separable block (its plain version, which the wrapper runs on
CPU tensors) against the JAX package's Pallas kernels in interpret mode:
the dense kernel at both strides, and the lane-packed narrow kernels that
the port's dense kernel replaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block import separable_block_pallas
from mobilenet_tpu.ops.pallas_block_packed import (
    pack, separable_block_packed, separable_block_packed_s2, unpack,
)
from mobilenet_tpu_torch.ops.separable_block import separable_block

# float32: the JAX kernel tests' tolerance (tests/test_pallas_block.py).
F32_TOL = dict(atol=3e-5, rtol=1e-5)
# bfloat16: both sides round the depthwise result to bf16 before the
# product and the output after it; a last-bit difference in an f32 sum can
# move either rounding by one bf16 step (2^-8 relative, 1/32 at [4, 8)).
BF16_TOL = dict(atol=1 / 32, rtol=2 ** -7)

_DT = {"float32": (np.float32, jnp.float32, torch.float32),
       "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, n, h, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, h, h, cin)).astype(np.float32),
            rng.normal(0, 0.5, (3, 3, 1, cin)).astype(np.float32),
            rng.normal(0, 0.2, (cin,)).astype(np.float32),
            rng.normal(0, 0.3, (cin, cout)).astype(np.float32),
            rng.normal(0, 0.2, (cout,)).astype(np.float32))


def _ours(arrs, dtype, stride):
    tdt = _DT[dtype][2]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    return separable_block(*t, stride, True).float().numpy()


def _jax(arrs, dtype):
    jdt = _DT[dtype][1]
    return [jnp.asarray(a, jdt) for a in arrs]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,cout", [(1, 128), (1, 256), (2, 128), (2, 256)])
def test_dense_vs_pallas(dtype, stride, cout):
    arrs = _inputs(stride * 10 + cout, 2, 8, 128, cout)
    ref = separable_block_pallas(*_jax(arrs, dtype), stride, True, interpret=True)
    np.testing.assert_allclose(_ours(arrs, dtype, stride),
                               np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_s1_vs_packed(dtype):
    """Block 0's shape class (32 -> 64, s1): the TPU's lane-packed kernel."""
    arrs = _inputs(1, 2, 8, 32, 64)
    x, *w = _jax(arrs, dtype)
    ref = unpack(separable_block_packed(pack(x, 32), *w, 32, 64, True,
                                        interpret=True), 64)
    np.testing.assert_allclose(_ours(arrs, dtype, 1),
                               np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_s2_vs_packed(dtype):
    """Block 1's shape class (64 -> 128, s2): the packed kron-selection kernel."""
    arrs = _inputs(2, 2, 8, 64, 128)
    x, *w = _jax(arrs, dtype)
    ref = unpack(separable_block_packed_s2(pack(x, 64), *w, 64, 128, True,
                                           interpret=True), 128)
    np.testing.assert_allclose(_ours(arrs, dtype, 2),
                               np.asarray(ref, np.float32), **_tol(dtype))


def test_relu_without_clip():
    x, dw_w, dw_b, pw_w, pw_b = _inputs(3, 1, 6, 16, 24)
    arrs = (x, dw_w * 4, dw_b, pw_w * 4, pw_b)  # large enough to pass 6
    t = [torch.from_numpy(a) for a in arrs]
    got = separable_block(*t, 1, False).numpy()
    ref = separable_block_pallas(*_jax(arrs, "float32"), 1, False, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)
    assert got.max() > 6.0


@pytest.mark.parametrize("case", ["odd_s2", "channels", "dtype", "shape",
                                  "stride", "noncontig"])
def test_wrapper_rejects(case):
    """The wrapper checks shapes, strides, dtypes, contiguity and channel
    counts (multiples of 8) before any launch."""
    x, dw_w, dw_b, pw_w, pw_b = [torch.from_numpy(a) for a in _inputs(0, 1, 8, 16, 16)]
    stride = 1
    if case == "odd_s2":
        x, stride = x[:, :7, :7].contiguous(), 2
    elif case == "channels":
        x, dw_w, dw_b = x[..., :12].contiguous(), dw_w[..., :12].contiguous(), dw_b[:12]
        pw_w = pw_w[:12].contiguous()
    elif case == "dtype":
        x = x.double()
    elif case == "shape":
        pw_w = pw_w[:8].contiguous()
    elif case == "stride":
        stride = 3
    elif case == "noncontig":
        x = x.transpose(1, 2)
    with pytest.raises(ValueError):
        separable_block(x, dw_w, dw_b, pw_w, pw_b, stride, True)
