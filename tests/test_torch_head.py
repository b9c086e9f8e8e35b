"""The port's fused pool+fc head (its plain version, which the wrapper runs
on CPU tensors) against the JAX package's Pallas `fused_head` in interpret
mode, V1's form: no conv_last, one linear fc."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_head import fused_head as jax_fused_head
from mobilenet_tpu_torch.ops.head import fused_head

# float32: f32 mean and f32 product on both sides, summation order differs.
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bfloat16: the pooled value is rounded to bf16 before the product and the
# logits after it; one bf16 step (2^-8 relative) at either rounding.
BF16_TOL = dict(atol=1 / 64, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hw,c,classes", [(8, 7, 128, 1000), (2, 4, 64, 100)])
def test_vs_pallas(dtype, n, hw, c, classes):
    rng = np.random.default_rng(n + c)
    x = rng.uniform(0, 6, (n, hw, hw, c)).astype(np.float32)
    w = (rng.normal(0, 1, (c, classes)) / np.sqrt(c)).astype(np.float32)
    b = rng.normal(0, 0.1, (classes,)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    ref = jax_fused_head(jnp.asarray(x, jdt), None,
                         [(jnp.asarray(w, jdt), jnp.asarray(b, jdt), "linear")],
                         interpret=True)
    tw, tb = torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt)
    got = fused_head(torch.from_numpy(x).to(tdt), None, [(tw, tb, "linear")])
    assert got.shape == (n, classes) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_other_forms_not_ported():
    x = torch.zeros(1, 7, 7, 16)
    w, b = torch.zeros(16, 10), torch.zeros(10)
    with pytest.raises(NotImplementedError):
        fused_head(x, (torch.zeros(16, 16), torch.zeros(16), "relu6"),
                   [(w, b, "linear")])
    with pytest.raises(NotImplementedError):
        fused_head(x, None, [(torch.zeros(16, 16), torch.zeros(16), "hswish"),
                             (w, b, "linear")])
    with pytest.raises(ValueError):
        fused_head(torch.zeros(1, 7, 7, 2048), None,
                   [(torch.zeros(2048, 10), b, "linear")])
