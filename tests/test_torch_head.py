"""The port's fused head (its plain version, which the wrapper runs on CPU
tensors) against the JAX package's Pallas `fused_head` in interpret mode, in
V1's form (no conv_last, one linear fc), V2's (conv_last + ReLU6, pool, fc)
and V3-Large's and V3-Small's (conv_last + hswish, pool, head matmul +
hswish, fc), V1's and V3-Small's at their 1.0-224 widths at batch 1 too."""

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
@pytest.mark.parametrize("n,hw,c,classes", [(8, 7, 128, 1000), (2, 4, 64, 100),
                                            (1, 8, 1024, 1000)])
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


def _layer(rng, k, m, act):
    return (rng.normal(0, 1, (k, m)).astype(np.float32) / np.sqrt(k),
            rng.normal(0, 0.1, (m,)).astype(np.float32), act)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,n,hw,c,e,posts", [
    ("v2", 8, 3, 32, 160, [(100, "linear")]),                 # conv_last relu6 -> fc
    ("v3", 4, 2, 24, 96, [(160, "hswish"), (100, "linear")]),  # two posts
    ("v3", 2, 2, 16, 48, []),                                  # no post: the pooled rows
    ("v3", 1, 8, 96, 576, [(1024, "hswish"), (1000, "linear")]),  # V3-Small, batch 1
])
def test_conv_last_forms_vs_pallas(dtype, form, n, hw, c, e, posts):
    rng = np.random.default_rng(e + len(posts))
    x = rng.uniform(0, 6, (n, hw, hw, c)).astype(np.float32)
    conv = _layer(rng, c, e, "relu6" if form == "v2" else "hswish")
    post, k = [], e
    for m, act in posts:
        post.append(_layer(rng, k, m, act))
        k = m
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)

    def jx(layer):
        return (jnp.asarray(layer[0], jdt), jnp.asarray(layer[1], jdt), layer[2])

    def tx(layer):
        return (torch.from_numpy(layer[0]).to(tdt), torch.from_numpy(layer[1]).to(tdt),
                layer[2])

    ref = jax_fused_head(jnp.asarray(x, jdt), jx(conv), [jx(p) for p in post],
                         interpret=True)
    got = fused_head(torch.from_numpy(x).to(tdt), tx(conv), [tx(p) for p in post])
    assert got.shape == (n, k) and got.dtype == tdt
    # bf16 rounds at each of the 2-4 cast points: two bf16 steps
    tol = F32_TOL if dtype == "float32" else dict(atol=1 / 32, rtol=2 ** -6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_other_forms_not_ported():
    """More than two post matmuls, an unknown activation and a weight that
    does not follow the previous width are refused at the call."""
    x = torch.zeros(1, 7, 7, 16)
    w, b = torch.zeros(16, 10), torch.zeros(10)
    sq = (torch.zeros(16, 16), torch.zeros(16), "relu")
    with pytest.raises(NotImplementedError):
        fused_head(x, None, [sq, sq, (w, b, "linear")])
    with pytest.raises(ValueError):
        fused_head(x, (torch.zeros(16, 16), torch.zeros(16), "gelu"), [(w, b, "linear")])
    with pytest.raises(ValueError):
        fused_head(x, None, [(torch.zeros(8, 10), b, "linear")])
    # no 1024-channel width limit: V2 alpha 1.4 pools 1792 channels
    got = fused_head(torch.ones(1, 2, 2, 1792), None, [(torch.zeros(1792, 10), b, "linear")])
    assert got.shape == (1, 10)
