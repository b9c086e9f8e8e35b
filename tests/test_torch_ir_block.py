"""The port's MobileNet-V2 block kernels (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode: the inverted-residual block at both strides, the same
function at stride 2 against the lane-packed `expand_block_packed_s2` it
replaces, and the separable block's linear-projection mode against the
packed kernel's `pw_epilogue=False`. Also the plans of the V3 bottleneck's
tiles, which the block runs on the card (bf16: the Hopper tile's
`v3_wgmma_plan`; float32: the CUDA-core tile's `v3_plan`), each its tile's
fits-function, and their plain version with ReLU6
(`v3_block_plain(act="relu6")`) against the V2 block's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack, separable_block_packed, unpack
from mobilenet_tpu.ops.pallas_expand_s2 import expand_block_packed_s2
from mobilenet_tpu.ops.pallas_ir_block import inverted_residual_pallas
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import V2Config
from mobilenet_tpu_torch.ops.inverted_residual import inverted_residual, inverted_residual_plain
from mobilenet_tpu_torch.ops.separable_block import separable_block
from mobilenet_tpu_torch.ops.v3_block import (
    MAX_TM, V3F_SMEM_LIMIT, V3W_SMEM_LIMIT, V3W_TM, v3_block_plain, v3_plan, v3_smem_bytes,
    v3_wgmma_plan, v3_wgmma_smem_bytes,
)

MM_TOL = dict(atol=golden.MM_TOL[0], rtol=golden.MM_TOL[1])
# bfloat16: three roundings to bf16 inside the block (expansion, depthwise,
# output) and one after the residual add; a last-bit difference in an f32
# sum moves a rounding by one bf16 step (2^-8 relative): the JAX IR kernel
# tests' bf16 class (tests/test_pallas_ir_block.py) is 0.15 absolute.
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _block(seed, n, h, cin, e, cout):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for shape, scale in (
        ((n, h, h, cin), 0.5), ((cin, e), cin ** -0.5), ((e,), 0.1), ((3, 3, 1, e), 0.2),
        ((e,), 0.1), ((e, cout), e ** -0.5), ((cout,), 0.1))]


def _ours(arrs, dtype, *args):
    return inverted_residual(*[torch.from_numpy(a).to(_DT[dtype][1]) for a in arrs],
                             *args).float().numpy()


def _jax(arrs, dtype):
    return [jnp.asarray(a, _DT[dtype][0]) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 8, 24, 144, 24, 1, True),     # V2 b02's widths: Cin not a multiple of 32
    (2, 16, 16, 96, 24, 2, False),    # V2 b01's widths at stride 2
    (1, 7, 40, 240, 48, 1, False),    # odd spatial, E a ragged number of chunks
    (2, 6, 64, 384, 96, 2, False),    # stride 2 into an odd output side
])
def test_ir_vs_pallas(dtype, n, h, cin, e, cout, stride, residual):
    arrs = _block(n * h + cin, n, h, cin, e, cout)
    ref = inverted_residual_pallas(*_jax(arrs, dtype), stride, residual, interpret=True)
    np.testing.assert_allclose(_ours(arrs, dtype, stride, residual),
                               np.asarray(ref, np.float32),
                               **(MM_TOL if dtype == "float32" else BF16_TOL))


def test_ir_stride2_vs_expand_block_packed_s2():
    """At stride 2 the IR function computes what the lane-packed narrow
    expand block computes (f32: the packed kernel keeps its expansion in
    f32, the IR function rounds it to f32, the same values)."""
    arrs = _block(7, 2, 16, 32, 128, 64)
    xj, *wj = _jax(arrs, "float32")
    ref = expand_block_packed_s2(pack(xj, 32), *wj, 32, True, interpret=True)
    ref = np.asarray(ref).reshape(2, 8, 8, 64)
    np.testing.assert_allclose(_ours(arrs, "float32", 2, False), ref, **MM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block0_linear_vs_packed(dtype):
    """V2 block 0 (t == 1, linear projection): the separable block with
    pw_act=False against `separable_block_packed(..., pw_epilogue=False)`."""
    rng = np.random.default_rng(3)
    cin, cout = 32, 32
    arrs = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
        ((2, 8, 8, cin), 1.0), ((3, 3, 1, cin), 0.5), ((cin,), 0.2), ((cin, cout), 0.3),
        ((cout,), 0.2))]
    jdt, tdt = _DT[dtype]
    xj, *wj = [jnp.asarray(a, jdt) for a in arrs]
    ref = unpack(separable_block_packed(pack(xj, cin), *wj, cin, cout, True,
                                        pw_epilogue=False, interpret=True), cout)
    got = separable_block(*[torch.from_numpy(a).to(tdt) for a in arrs], 1, True,
                          pw_act=False)
    ref = np.asarray(ref, np.float32)
    assert (ref < 0).any()  # linear: negative projections survive
    tol = dict(atol=3e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1 / 32, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_plain_pads_the_expanded_activation():
    """SAME padding pads the expansion, not the input: with a large expand
    bias, a border output differs from what a zero-padded input would give
    (relu6(bias) at the halo), and the plain version uses zeros."""
    arrs = _block(5, 1, 4, 8, 16, 8)
    arrs[2][:] = 3.0  # exp_b: relu6(exp_b) = 3 at a zero input pixel
    t = [torch.from_numpy(a) for a in arrs]
    got = inverted_residual_plain(*t, 1, False)
    x_pad = torch.nn.functional.pad(t[0], (0, 0, 1, 1, 1, 1))
    z = torch.clamp(x_pad @ t[1] + t[2], 0, 6)  # expanded with the halo at 3
    zd = torch.zeros(1, 4, 4, 16)
    w = t[3].reshape(3, 3, 16)
    for dy in range(3):
        for dx in range(3):
            zd = zd + z[:, dy:dy + 4, dx:dx + 4] * w[dy, dx]
    wrong = torch.clamp(zd + t[4], 0, 6) @ t[5] + t[6]
    assert not torch.allclose(got, wrong, atol=1e-3)
    # interior pixels do not see the padding and agree
    torch.testing.assert_close(got[:, 1:3, 1:3], wrong[:, 1:3, 1:3], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("alpha", [0.35, 1.0, 1.4])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_v2_block_has_a_tile(alpha, itemsize):
    """Every expanded block of V2 at 224 has a plan at batch 1 and 256 within
    the shared-memory limit: bf16 (itemsize 2) of the V3 bottleneck's Hopper
    tile (`v3_wgmma_plan`, ReLU6, k 3, no SE), whose units at batch 1 are at
    least as many as at batch 256 divided by the batch; float32 (itemsize 4)
    of the CUDA-core tile (`v3_plan`), whose batch-1 tiles are no larger than
    the batch-256 ones (more blocks where the batch does not fill the card)."""
    cfg = V2Config(alpha, 224)
    h = 112
    for t, cin, cout, stride in cfg.block_defs:
        e, ho = t * cin, -(-h // stride)
        if t > 1 and itemsize == 2:
            units = []
            for n in (1, 256):
                p = v3_wgmma_plan(n, h, h, cin, e, cout, 3, stride, 0, False)
                assert p is not None and p.th * p.tw <= V3W_TM, (n, h, cin, cout, stride)
                assert v3_wgmma_smem_bytes(p.th, p.tw, cin, e, cout, 3, stride, p.cw, p.ws,
                                           p.bs, False) <= V3W_SMEM_LIMIT
                units.append(-(-ho // p.th) * -(-ho // p.tw) * p.split)
            assert units[0] * 256 >= units[1]
        elif t > 1:
            plans = [v3_plan(n, h, h, cin, e, cout, 3, stride, 0) for n in (1, 256)]
            for p in plans:
                assert p is not None, (h, cin, cout, stride)
                assert v3_smem_bytes(p.th, p.tw, h, h, cin, e, cout, 0, 3, stride, p.ws,
                                     p.bs) <= V3F_SMEM_LIMIT
                assert p.th * p.tw <= MAX_TM
            assert plans[0].th * plans[0].tw <= plans[1].th * plans[1].tw
        h //= stride


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 8, 16, 96, 24, 2, False),     # b01's widths at stride 2
    (2, 7, 24, 144, 24, 1, True),     # b02: residual, odd side
    (1, 9, 32, 192, 32, 1, True),     # b04: E 192 = three 64-channel chunks
    (1, 6, 64, 384, 96, 1, False),    # b10
    (1, 4, 160, 960, 320, 1, False),  # b16: E tail past 15 chunks
    (2, 6, 8, 48, 8, 2, False),       # alpha 0.35's narrowest at stride 2
])
def test_v3_block_relu6_is_the_v2_block(dtype, n, h, cin, e, cout, stride, residual):
    """The V3 tile's plain version with ReLU6, k 3 and no SE, the function
    the V2 block runs on the card in both dtypes, equals the V2 block's plain version
    bit for bit: the same roundings in the same places."""
    t = [torch.from_numpy(a).to(_DT[dtype][1]) for a in _block(h + e, n, h, cin, e, cout)]
    want = inverted_residual_plain(*t, stride, residual)
    got = v3_block_plain(*t, k=3, stride=stride, act="relu6", residual=residual)
    assert torch.equal(got, want)
    assert (want < 0).any() and (want > 0).any()


def test_wrapper_rejects_what_no_kernel_takes():
    t = [torch.from_numpy(a) for a in _block(1, 1, 6, 16, 96, 16)]
    with pytest.raises(ValueError):
        inverted_residual(t[0][:, :5], *t[1:], 2, False)  # odd input at stride 2
    with pytest.raises(ValueError):
        inverted_residual(*t, 2, True)  # residual at stride 2
    with pytest.raises(ValueError):
        inverted_residual(t[0], *t[1:5], t[5][:, :12].contiguous(), t[6][:12], 1, False)
    assert v3_plan(1, 6, 5, 16, 96, 16, 3, 2, 0) is None
    assert v3_wgmma_plan(1, 6, 5, 16, 96, 16, 3, 2, 0, False) is None
    with pytest.raises(ValueError, match="v3_plan"):  # float32: the CUDA-core tile's plan
        inverted_residual(t[0][:, :, :5].contiguous(), *t[1:], 2, False)
    with pytest.raises(ValueError, match="v3_wgmma_plan"):  # bf16: the Hopper tile's plan
        inverted_residual(t[0][:, :, :5].contiguous().bfloat16(),
                          *[w.bfloat16() for w in t[1:]], 2, False)
