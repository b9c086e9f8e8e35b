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
from mobilenet_tpu.ops.pallas_block_packed_mxu import separable_block_packed_mxu
from mobilenet_tpu_torch.ops.separable_block import (
    CHUNK, H100_SMS, SMEM_LIMIT, chunk_groups, separable_block, separable_block_plain,
    separable_plan, separable_smem_bytes, slice_widths,
)
from mobilenet_tpu_torch.utils.golden import MM_TOL

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


# V1's narrow shapes of tests/test_pallas_block_packed_mxu.py at h <= 16:
# block 0 (32 -> 64 s1) and block 1 (64 -> 128 s2) of alpha 1.0, alpha
# 0.25's, and the packed -> dense boundary.
MXU_SHAPES = [(2, 16, 32, 64, 1), (2, 16, 64, 128, 2), (2, 16, 8, 16, 1),
              (2, 16, 16, 32, 2), (2, 8, 64, 128, 1), (1, 16, 64, 128, 2)]
# bfloat16: chip_smoke.py's BF16_ATOL/RTOL (the banded-matmul depthwise sums
# in another order than the 9-tap stencil).
MXU_BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cin,cout,stride", MXU_SHAPES)
def test_narrow_vs_packed_mxu(dtype, n, h, cin, cout, stride):
    """The plain separable block against separable_block_packed_mxu (the
    depthwise as banded matmuls, behind the DW_MXU_* knobs) in interpret
    mode: the port's dense kernel computes its function (B20)."""
    arrs = _inputs(cin * 7 + stride, n, h, cin, cout)
    x, *w = _jax(arrs, dtype)
    ref = unpack(separable_block_packed_mxu(pack(x, cin), *w, cin, cout, stride, True,
                                            interpret=True), cout)
    got = separable_block_plain(*[torch.from_numpy(a).to(_DT[dtype][2]) for a in arrs],
                                stride, True)
    atol, rtol = MM_TOL
    tol = dict(atol=atol, rtol=rtol) if dtype == "float32" else MXU_BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


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


# -- the bf16 kernel's plan (csrc/separable_wgmma.cuh), mirrored on the CPU --


def _v1_shapes(alpha, res, batch):
    from mobilenet_tpu_torch import ModelConfig
    cfg = ModelConfig(alpha, res)
    hw, cin, out = res // 2, cfg.stem_channels, []
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        out.append((batch, hw, hw, cin, cout, stride))
        hw, cin = -(-hw // stride), cout
    return out


PLAN_GRID = ([s for a in (0.25, 0.5, 0.75, 1.0) for r in (128, 160, 224) for b in (1, 8, 256)
              for s in _v1_shapes(a, r, b)]
             + [(256, 112, 112, 32, 16, 1), (1, 112, 112, 32, 16, 1),  # V2 block 0
                (2, 9, 9, 40, 136, 1), (3, 18, 18, 24, 40, 2), (2, 7, 7, 2048, 200, 1),
                (1, 3, 1000, 8, 8, 1), (1, 4, 2000, 8, 16, 2), (4, 1, 1, 64, 64, 1),
                (2, 5, 11, 3072, 24, 1), (7, 30, 2, 16, 8, 2)])


@pytest.mark.parametrize("shape", PLAN_GRID[::7] + PLAN_GRID[-12:])
def test_plan_fits_the_card(shape):
    """Every plan fits 227 KB of shared memory, a tile at most 64 pixels a
    warpgroup, window sides within a TMA box, a panel of whole 64-channel
    atoms no wider than Cin needs, parts covering Cout."""
    n, h, w, cin, cout, stride = shape
    p = separable_plan(*shape)
    assert separable_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride) <= SMEM_LIMIT
    assert p.nwg in (1, 2) and 1 <= p.th * p.tw <= 64 * p.nwg
    assert (p.th - 1) * stride + 3 <= 256 and (p.tw - 1) * stride + 3 <= 256
    assert p.kp % CHUNK == 0 and CHUNK <= p.kp <= -(-cin // CHUNK) * CHUNK
    assert p.cw % 8 == 0 and p.split * p.cw >= cout > (p.split - 1) * p.cw
    assert 1 <= p.ws <= 2 and 2 <= p.bs <= 4


@pytest.mark.parametrize("shape", [(2, 9, 9, 40, 136, 1), (3, 18, 18, 24, 40, 2),
                                   (1, 14, 14, 512, 512, 1), (5, 14, 14, 64, 72, 2),
                                   (2, 7, 7, 2048, 200, 1), (1, 4, 2000, 8, 16, 2),
                                   (3, 28, 28, 256, 512, 2), (7, 30, 2, 16, 8, 2)])
def test_plan_covers_every_output_once(shape):
    """The kernel's unit decode (unit_of) and slices (slice_width): every
    output pixel and channel written exactly once, each slice a wgmma width
    (a multiple of 8 up to 128), and the depthwise of a unit's pixels over
    all of Cin in whole chunks."""
    n, h, w, cin, cout, stride = shape
    p = separable_plan(*shape)
    ho, wo = -(-h // stride), -(-w // stride)
    rows = n * ho
    tiles_c = -(-wo // p.tw)
    units = -(-rows // p.th) * tiles_c * p.split
    seen = np.zeros((rows, wo, cout), np.int32)
    for u in range(units):
        t, part = divmod(u, p.split)
        r0, w0 = (t // tiles_c) * p.th, (t % tiles_c) * p.tw
        c0, c1 = part * p.cw, min(cout, part * p.cw + p.cw)
        widths = slice_widths(c1 - c0)
        assert all(wd in (8, 16, 32, 64, 128) for wd in widths) and sum(widths) == c1 - c0
        for m in range(64 * p.nwg):
            ih, iw = divmod(m, p.tw)
            if m < p.th * p.tw and r0 + ih < rows and w0 + iw < wo:
                seen[r0 + ih, w0 + iw, c0:c1] += 1
    assert (seen == 1).all()
    assert sum(chunk_groups(cin)) * 8 == cin


def test_plan_cout_split():
    """Parts of Cout only where pixel tiles are too few for the SMs: every
    V1 1.0-224 block at batch 256 whole, blocks 1-12 split at batch 1, b11
    and b12 split at batch 64 (3,136 pixels in 64-pixel tiles)."""
    big = [separable_plan(*s) for s in _v1_shapes(1.0, 224, 256)]
    one = [separable_plan(*s) for s in _v1_shapes(1.0, 224, 1)]
    mid = [separable_plan(*s) for s in _v1_shapes(1.0, 224, 64)]
    assert all(p.split == 1 for p in big)
    assert all(p.split > 1 for p in one[1:])
    assert mid[11].split > 1 and mid[12].split > 1
    for shape, p in zip(_v1_shapes(1.0, 224, 1), one):
        n, h, w, cin, cout, stride = shape
        ho = -(-h // stride)
        tiles = -(-n * ho // p.th) * -(-ho // p.tw)
        assert tiles * p.split <= 2 * H100_SMS


@pytest.mark.parametrize("cin,groups", [(8, [1]), (24, [3]), (40, [5]), (64, [8]),
                                        (72, [8, 1]), (1000, [8] * 15 + [5])])
def test_plan_k_padding(cin, groups):
    """K is padded with zeros to the 64-channel chunk: Cin 8, 24 and 40 fill
    1, 3 and 5 of a chunk's 8 groups (their threads spread over the live
    groups only); the rest of the chunk's columns are zeros, so its four
    16-wide wgmma steps add nothing past Cin."""
    assert chunk_groups(cin) == groups
    p = separable_plan(2, 16, 16, cin, 16, 1)
    assert p.kp == -(-cin // CHUNK) * CHUNK


def test_plan_slices_are_wgmma_widths():
    """Every Cout on the alpha grid (a multiple of 8 up to 1024) splits into
    slices of 128, 64, 32, 16 and 8 columns with none padded, V1 b00's 64 and
    V2 b00's 16 as one slice each."""
    for cout in range(8, 1025, 8):
        widths = slice_widths(cout)
        assert sum(widths) == cout and all(wd % 8 == 0 and wd <= 128 for wd in widths)
        tail = [wd for wd in widths if wd < 128]
        assert widths == sorted(widths, reverse=True) and len(set(tail)) == len(tail)
    assert slice_widths(64) == [64] and slice_widths(16) == [16]


def test_plan_holds_cin_in_ranges():
    """A Cin whose panel does not fit at 64 pixels is taken in ranges of KP
    channels (the depthwise recomputed for each slice); V1's widest, 1024,
    fits whole."""
    assert separable_plan(2, 7, 7, 2048, 200, 1).kp < 2048
    assert separable_plan(256, 7, 7, 1024, 1024, 1).kp == 1024


@pytest.mark.parametrize("stride,cout,pw_act", [(1, 24, True), (2, 16, True), (1, 16, False)])
def test_library_yardstick_is_the_block(stride, cout, pw_act):
    """The unfused library sequence that `chip_smoke.py` and `block_times`
    time beside the kernel (cuDNN's grouped conv with TF-SAME padding, then
    matmul) computes the separable block's function: float32, against the
    plain version."""
    from mobilenet_tpu_torch.block_times import separable_library
    t = [torch.from_numpy(a) for a in _inputs(stride + cout, 2, 8, 16, cout)]
    ref = separable_block_plain(*t, stride, True, pw_act)
    got = separable_library(*t, stride, True, pw_act)().reshape(ref.shape)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32_TOL)
