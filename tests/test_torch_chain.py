"""The port's chain (its plain version, which the wrapper runs on CPU
tensors) against the JAX package's Pallas `chain_systolic` in interpret
mode, and against K separable blocks in sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_chain import chained_blocks_pallas
from mobilenet_tpu.ops.pallas_chain_systolic import chain_systolic
from mobilenet_tpu_torch.ops.chain import L2_BUDGET_BYTES, chain, chain_fits, chain_plain
from mobilenet_tpu_torch.ops.separable_block import separable_block
from mobilenet_tpu_torch.utils.golden import MM_TOL

# float32: the JAX chain test's tolerance (tests/test_pallas_chain_systolic.py).
F32_TOL = dict(atol=5e-5, rtol=1e-4)
# bfloat16: one bf16 step per rounding, compounded over K stages.
BF16_TOL = dict(atol=1 / 16, rtol=2 ** -6)


def _inputs(seed, n, h, c, k):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, h, h, c)).astype(np.float32),
            rng.normal(0, 0.4, (k, 3, 3, c)).astype(np.float32),
            rng.normal(0, 0.2, (k, c)).astype(np.float32),
            (rng.normal(0, 1.0, (k, c, c)) / np.sqrt(c)).astype(np.float32),
            rng.normal(0, 0.2, (k, c)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,c,k", [(1, 8, 128, 5), (2, 7, 128, 3)])
def test_vs_chain_systolic(dtype, n, h, c, k):
    arrs = _inputs(n * 10 + k, n, h, c, k)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    ref = chain_systolic(*[jnp.asarray(a, jdt) for a in arrs], True, interpret=True)
    got = chain(*[torch.from_numpy(a).to(tdt) for a in arrs], True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_vs_chained_blocks_pallas():
    """The plain chain against chained_blocks_pallas (the un-pipelined
    forerunner of chain_systolic, which nothing calls) in interpret mode at
    its test's shape, K = 3 at 14x14x64, batch 2: chain.cu computes its
    function (B23)."""
    arrs = _inputs(23, 2, 14, 64, 3)
    ref = chained_blocks_pallas(*map(jnp.asarray, arrs), True, interpret=True)
    got = chain_plain(*map(torch.from_numpy, arrs), True)
    atol, rtol = MM_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_equals_blocks_in_sequence():
    """The chain's contract: K separable blocks in sequence, exactly."""
    x, dw_ws, dw_bs, pw_ws, pw_bs = [torch.from_numpy(a).to(torch.bfloat16)
                                     for a in _inputs(5, 1, 6, 32, 4)]
    ref = x
    for k in range(4):
        ref = separable_block(ref, dw_ws[k].reshape(3, 3, 1, 32).contiguous(),
                              dw_bs[k], pw_ws[k], pw_bs[k], 1, True)
    assert torch.equal(chain(x, dw_ws, dw_bs, pw_ws, pw_bs, True), ref)


def test_chain_fits():
    assert chain_fits(1, 14, 14, 512, 5, 2)  # the batch-1 stretch: 400 KB
    assert not chain_fits(1, 14, 14, 500, 5, 2)  # not a multiple of 8
    n_over = L2_BUDGET_BYTES // (2 * 14 * 14 * 512 * 2) + 1
    assert not chain_fits(n_over, 14, 14, 512, 5, 2)
    x, *w = [torch.from_numpy(a) for a in _inputs(0, n_over, 1, 8, 2)]
    assert chain_fits(n_over, 1, 1, 8, 2, 4)
    with pytest.raises(ValueError):
        chain(x, w[0], w[1], w[2][:, :, :4].contiguous(), w[3], True)
