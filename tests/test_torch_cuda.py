"""The port's CUDA kernels against their plain versions on the card, at the
ragged and narrow shapes of the whole alpha grid (partial pixel and channel
tiles, C = 8 .. 1024). Marked `cuda`: skipped without a card. Imports no
JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from mobilenet_tpu_torch import InferencePipeline, ModelConfig
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.ops.chain import chain, chain_plain
from mobilenet_tpu_torch.ops.head import fused_head, fused_head_plain
from mobilenet_tpu_torch.ops.separable_block import (
    separable_block, separable_block_plain,
)

pytestmark = pytest.mark.cuda

# Tolerances of chip_smoke.py: f32 sums reassociate only; bf16 may move a
# rounding by one step at the depthwise and at the output cast.
TOL = {torch.float32: (1e-4, 3e-4), torch.bfloat16: (6e-2, 1.6e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _t(rng, shape, dtype, dev, scale=1.0, lo=None):
    a = rng.uniform(lo, 1, shape) if lo is not None else rng.normal(0, scale, shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,cout,stride", [
    (2, 64, 8, 16, 1),      # alpha 0.25 block 0: one partial K chunk
    (3, 10, 24, 48, 2),     # alpha 0.75 widths, ragged pixel tile
    (1, 7, 1024, 1024, 1),  # 49 pixels: one partial pixel tile
    (2, 14, 96, 192, 2),    # partial channel tiles at both ends
    (1, 9, 40, 136, 1),     # odd spatial size, Cout just over one tile
])
def test_separable_block(dev, dtype, n, h, cin, cout, stride):
    rng = np.random.default_rng(cin + cout)
    args = (_t(rng, (n, h, h, cin), dtype, dev, lo=-1), _t(rng, (3, 3, 1, cin), dtype, dev, 0.5),
            _t(rng, (cin,), dtype, dev, 0.2), _t(rng, (cin, cout), dtype, dev, cin ** -0.5),
            _t(rng, (cout,), dtype, dev, 0.2), stride, True)
    before = separable_block.launches
    got = separable_block(*args)
    assert separable_block.launches == before + 1
    assert got.is_cuda and got.dtype == dtype
    _close(got, separable_block_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,c,classes", [(1, 7, 1024, 1000), (13, 4, 256, 1000),
                                            (9, 5, 200, 130)])
def test_fused_head(dev, dtype, n, hw, c, classes):
    rng = np.random.default_rng(n)
    x = _t(rng, (n, hw, hw, c), dtype, dev, lo=0)
    w, b = _t(rng, (c, classes), dtype, dev, c ** -0.5), _t(rng, (classes,), dtype, dev, 0.1)
    _close(fused_head(x, None, [(w, b, "linear")]), fused_head_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,c,k", [(1, 14, 512, 5), (3, 7, 128, 3), (2, 8, 64, 2),
                                     (1, 4, 32, 1)])
def test_chain(dev, dtype, n, h, c, k):
    rng = np.random.default_rng(c + k)
    args = (_t(rng, (n, h, h, c), dtype, dev, lo=-1), _t(rng, (k, 3, 3, c), dtype, dev, 0.4),
            _t(rng, (k, c), dtype, dev, 0.2), _t(rng, (k, c, c), dtype, dev, c ** -0.5),
            _t(rng, (k, c), dtype, dev, 0.2), True)
    got = chain(*args)
    _close(got, chain_plain(*args), dtype)
    # equal, bit for bit, to K per-block kernel launches
    y = args[0]
    for i in range(k):
        y = separable_block(y, args[1][i].reshape(3, 3, 1, c).contiguous(), args[2][i],
                            args[3][i], args[4][i], 1, True)
    torch.cuda.synchronize()
    assert torch.equal(got, y)


@pytest.mark.parametrize("alpha,res", [(0.25, 128), (0.75, 160)])
def test_pipeline_routes_agree(dev, alpha, res):
    """bf16 kernel route vs plain route, batch 1 (chain) and batch 4."""
    cfg = ModelConfig(alpha, res, compute_dtype="bfloat16")
    pipe = InferencePipeline(cfg, device="cuda")
    rng = np.random.default_rng(0)
    for batch in (1, 4):
        x = torch.from_numpy(rng.uniform(-1, 1, (batch, res, res, 3)).astype(
            np.float32)).to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = mobilenet_v1.forward(pipe.params, x, cfg, dw_backend="auto").float()
            ref = mobilenet_v1.forward(pipe.params, x, cfg, dw_backend="plain").float()
        atol = max(6e-2, 4.5e-2 * float(ref.abs().max()))
        torch.testing.assert_close(got, ref, atol=atol, rtol=0)


def test_cpu_tensor_never_launches(dev):
    x = torch.zeros(1, 8, 8, 8)
    w = (torch.zeros(3, 3, 1, 8), torch.zeros(8), torch.zeros(8, 8), torch.zeros(8))
    before = separable_block.launches
    separable_block(x, *w, 1, True)
    assert separable_block.launches == before
