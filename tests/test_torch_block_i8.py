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


# -- the Hopper kernel's plan, K-major weight and requant (CPU mirrors) ---------

from mobilenet_tpu_torch import ModelConfig, V2Config  # noqa: E402
from mobilenet_tpu_torch.checkpoints import (  # noqa: E402
    fold_bn, fold_bn_v2, init_params, init_params_v2,
)
from mobilenet_tpu_torch.ops.separable_block import SMEM_LIMIT, slice_widths  # noqa: E402
from mobilenet_tpu_torch.ops.separable_block_i8 import (  # noqa: E402
    CHUNK_I8, _pad_cin, chunk_groups_i8, kmajor, max_slice, padded_cin,
    separable_block_i8_plain, separable_i8_plan, separable_i8_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_block_i8 import kernel_weights  # noqa: E402
from mobilenet_tpu_torch.quant import ops as qops  # noqa: E402
from mobilenet_tpu_torch.quant.model import to_device_i8  # noqa: E402
from mobilenet_tpu_torch.quant.quantize import quantize  # noqa: E402
from mobilenet_tpu_torch.quant.v2 import quantize_v2, to_device_i8_v2  # noqa: E402


def _v1_i8_shapes(alpha, res, batch):
    cfg = ModelConfig(alpha, res)
    hw, cin, out = res // 2, cfg.stem_channels, []
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        out.append((batch, hw, hw, cin, cout, stride))
        hw, cin = -(-hw // stride), cout
    return out


V1_FULL = _v1_i8_shapes(1.0, 224, 256) + _v1_i8_shapes(1.0, 224, 1)
V2_B00 = [(256, 112, 112, 32, 16, 1), (1, 112, 112, 32, 16, 1)]
I8_PLAN_GRID = (V1_FULL + V2_B00
                + [s for a in (0.25, 0.5, 0.75) for r in (128, 160) for b in (1, 8)
                   for s in _v1_i8_shapes(a, r, b)][::5]
                + [(2, 9, 9, 40, 136, 1), (3, 18, 18, 24, 40, 2), (2, 7, 7, 2048, 200, 1),
                   (1, 3, 1000, 8, 8, 1), (1, 4, 2000, 8, 16, 2), (4, 1, 1, 64, 64, 1),
                   (2, 5, 11, 3072, 24, 1), (7, 30, 2, 16, 8, 2), (2, 9, 9, 64, 128, 2)])


@pytest.mark.parametrize("shape", I8_PLAN_GRID)
def test_i8_plan_fits_the_card(shape):
    """Every int8 plan fits 227 KB of shared memory: one, two or four
    consumer warpgroups, each with pixels, a tile at most 64 pixels a
    warpgroup, window sides within a TMA box, a panel of whole 128-channel
    atoms no wider than the padded Cin needs, parts covering Cout, ring slots
    in range."""
    n, h, w, cin, cout, stride = shape
    p = separable_i8_plan(*shape)
    cin16 = padded_cin(cin)
    assert separable_i8_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride,
                                   cin16) <= SMEM_LIMIT
    assert p.nwg in (1, 2, 4) and 64 * (p.nwg - 1) < p.th * p.tw <= 64 * p.nwg
    assert (p.th - 1) * stride + 3 <= 256 and (p.tw - 1) * stride + 3 <= 256
    assert p.kp % CHUNK_I8 == 0 and CHUNK_I8 <= p.kp <= -(-cin16 // CHUNK_I8) * CHUNK_I8
    assert p.cw % 8 == 0 and p.split * p.cw >= cout > (p.split - 1) * p.cw
    assert 1 <= p.ws <= 2 and 2 <= p.bs <= 4


def test_i8_plan_v1_whole_panels():
    """The int8 panel is half the bf16 one: every V1 1.0-224 block at batch
    256 keeps all of Cin in one panel of 128- or 256-pixel tiles (two or four
    warpgroups), Cin 1024 included, where the bf16 plan needs 64-pixel
    tiles."""
    for shape in _v1_i8_shapes(1.0, 224, 256):
        p = separable_i8_plan(*shape)
        assert p.kp >= shape[3] and p.nwg >= 2, (shape, p)


@pytest.mark.parametrize("shape", [(2, 9, 9, 40, 136, 1), (3, 18, 18, 24, 40, 2),
                                   (1, 14, 14, 512, 512, 1), (5, 14, 14, 64, 72, 2),
                                   (2, 7, 7, 2048, 200, 1), (1, 4, 2000, 8, 16, 2),
                                   (3, 28, 28, 256, 512, 2), (2, 9, 9, 64, 128, 2),
                                   (8, 112, 112, 32, 64, 1), (4, 112, 112, 64, 136, 2)])
def test_i8_plan_covers_every_output_once(shape):
    """The kernel's unit decode (unit_of) and slices (slice_width) on the
    int8 plan: every output pixel and channel written exactly once, each
    slice an s8 wgmma width the kernel instantiates (8 to 128), and the
    depthwise of a unit's pixels over all of the padded Cin in whole
    16-channel groups."""
    n, h, w, cin, cout, stride = shape
    p = separable_i8_plan(*shape)
    ho, wo = -(-h // stride), -(-w // stride)
    rows = n * ho
    tiles_c = -(-wo // p.tw)
    units = -(-rows // p.th) * tiles_c * p.split
    seen = np.zeros((rows, wo, cout), np.int32)
    for u in range(units):
        t, part = divmod(u, p.split)
        r0, w0 = (t // tiles_c) * p.th, (t % tiles_c) * p.tw
        c0, c1 = part * p.cw, min(cout, part * p.cw + p.cw)
        widths = slice_widths(c1 - c0, max_slice(p.nwg))
        assert all(wd in (8, 16, 32, 64, 128) for wd in widths) and sum(widths) == c1 - c0
        for m in range(64 * p.nwg):
            ih, iw = divmod(m, p.tw)
            if m < p.th * p.tw and r0 + ih < rows and w0 + iw < wo:
                seen[r0 + ih, w0 + iw, c0:c1] += 1
    assert (seen == 1).all()
    assert sum(chunk_groups_i8(cin)) * 16 == padded_cin(cin)


def test_i8_plan_slices_are_wgmma_widths():
    """s8 wgmma takes N = 8, 16, 24, 32, 48, ... 256; the kernel instantiates
    8, 16, 32, 64 and 128 (64 at most with four consumer warpgroups). Every
    Cout on the alpha grid splits into those, V1 b00's 64 and V2 b00's 16 as
    one slice each; four warpgroups only where Cin <= 32."""
    for cout in range(8, 1025, 8):
        for top in (128, 64):
            widths = slice_widths(cout, top)
            assert sum(widths) == cout and set(widths) <= {8, 16, 32, 64, 128}
            assert max(widths) <= top
    assert slice_widths(64) == [64] and slice_widths(16) == [16]
    assert slice_widths(136, 64) == [64, 64, 8]
    for shape in I8_PLAN_GRID:
        assert separable_i8_plan(*shape).nwg < 4 or padded_cin(shape[3]) <= 32


@pytest.mark.parametrize("cin,groups", [(8, [1]), (24, [2]), (40, [3]), (32, [2]),
                                        (64, [4]), (128, [8]), (136, [8, 1]),
                                        (1000, [8] * 7 + [7])])
def test_i8_plan_k_padding(cin, groups):
    """Cin is padded to a multiple of 16 (the TMA strides), then to the
    128-channel chunk: the live 16-channel groups of each chunk, the panel
    width, and the padded channels' zeros."""
    assert chunk_groups_i8(cin) == groups
    assert padded_cin(cin) == sum(groups) * 16 and padded_cin(cin) % 16 == 0
    p = separable_i8_plan(2, 16, 16, cin, 16, 1)
    assert p.kp == -(-padded_cin(cin) // CHUNK_I8) * CHUNK_I8


@pytest.mark.parametrize("cin,stride,linear", [(8, 1, False), (24, 2, False), (40, 1, True)])
def test_cin_padding_is_exact(cin, stride, linear):
    """The wrapper pads a Cin that is not a multiple of 16 with zero channels
    (x, the depthwise weight, bias and multiplier, the K-major weight's
    columns) before the kernel: the plain block on the padded operands gives
    the same int8 output."""
    arrs = [torch.from_numpy(a) for a in _inputs(cin, 2, 9, cin, 24)]
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = arrs
    cin16 = padded_cin(cin)
    padded = [_pad_cin(t, cin16) for t in (x, dw_w, dw_b, dw_m)]
    pw_wt = _pad_cin(kmajor(pw_w), cin16)
    assert pw_wt.shape == (24, cin16) and not pw_wt[:, cin:].any()
    ref = separable_block_i8_plain(*arrs, stride, DW_SIX_Q, PW_SIX_Q, True, linear)
    got = separable_block_i8_plain(*padded, pw_wt.t(), pw_b, pw_m, stride, DW_SIX_Q,
                                   PW_SIX_Q, True, linear)
    assert torch.equal(got, ref)


def test_kmajor_copy_uploaded():
    """The int8 device trees carry the K-major (Cout, Cin) copy of every
    weight the fused block kernel reads, made once at upload: V1's pointwise
    layers and V2 block 0's projection; equal to w.T. V2's blocks 1-16 carry
    the int8 bottleneck tile's forms instead (`v3_i8_kernel_weights`: the
    K-major copies padded to 16 channels and the depthwise table)."""
    cfg = ModelConfig(0.25, 128)
    dev = to_device_i8(quantize(fold_bn(init_params(cfg, seed=0), eps=cfg.bn_eps), cfg), "cpu")
    for blk in dev["blocks"]:
        wt = blk["pw"]["wt"]
        assert wt.is_contiguous() and wt.dtype == torch.int8
        assert torch.equal(wt, blk["pw"]["w"].t())
        assert "wt" not in blk["dw"]
    v2 = V2Config(0.35, 96)
    dev = to_device_i8_v2(quantize_v2(fold_bn_v2(init_params_v2(v2, seed=0), eps=v2.bn_eps),
                                      v2, n_calib=2), "cpu")
    b0 = dev["blocks"][0]
    assert "exp" not in b0 and torch.equal(b0["prj"]["wt"], b0["prj"]["w"].t())
    assert b0["prj"]["wt"].is_contiguous()
    for blk in dev["blocks"][1:]:
        want = kernel_weights({"w": blk["exp"]["w"]}, {"w": blk["dw"]["w"]},
                              {"w": blk["prj"]["w"]})
        assert all(torch.equal(blk[name]["wt"], want[name]) for name in ("exp", "dw", "prj"))


@pytest.mark.parametrize("case", ["shape", "dtype", "noncontig", "misaligned", "device"])
def test_wrapper_rejects_pw_wt(case):
    """pw_wt, the K-major copy, must be the (Cout, Cin) int8 tensor on x's
    device, contiguous and 16-byte aligned; the plain route (CPU tensors)
    checks it too, and with a valid copy returns what it returns without."""
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = [torch.from_numpy(a)
                                             for a in _inputs(1, 1, 8, 16, 32)]
    args = (x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, 1, DW_SIX_Q, PW_SIX_Q, True)
    assert torch.equal(separable_block_i8(*args, pw_wt=kmajor(pw_w)),
                       separable_block_i8(*args))
    wt = {"shape": pw_w.contiguous(),
          "dtype": kmajor(pw_w).int(),
          "noncontig": pw_w.t(),
          "misaligned": torch.empty(pw_w.numel() + 1, dtype=torch.int8)[1:].view(32, 16),
          "device": kmajor(pw_w).to("meta")}[case]
    with pytest.raises(ValueError):
        separable_block_i8(*args, pw_wt=wt)


# The kernel's requant (csrc/separable_i8_wgmma.cuh requant_bits) in float32
# torch ops: the depthwise converts float32(acc) as float(0x4B400000 + acc) -
# 1.5 * 2^23 for a group whose biases are within SMALL_BIAS; every requant
# clamps to [lo, hi] and then rounds by adding 1.5 * 2^23, the int8 result in
# the low byte of the sum's bits.
MAGIC_I, MAGIC_F, SMALL_BIAS, TAPS_MAX = 0x4B400000, 12582912.0, 1 << 21, 9 * 128 * 128


def _kernel_requant(acc, m, lo, hi, magic):
    if magic:
        f = (acc + MAGIC_I).view(torch.float32) - MAGIC_F
    else:
        f = acc.float()
    t = (f * m).clamp(lo, hi) + MAGIC_F
    return (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def _bands(ms, lo_rail, hi_rail, limit=1 << 24):
    """(acc, m) pairs: for each multiplier every accumulator whose requant is
    not at a rail (lo_rail = 0: from -1; else from lo_rail / m - 2) up to
    hi_rail / m + 2, in chunks of at most `limit` elements."""
    ms = torch.as_tensor(np.asarray(ms, np.float32))
    lo = (torch.floor(lo_rail / ms.double()) - 2 if lo_rail else torch.full_like(ms.double(), -1.0)).long()
    hi = (torch.ceil(hi_rail / ms.double()) + 2).long()
    lens = hi - lo + 1
    start = 0
    while start < len(ms):
        stop = start + 1
        while stop < len(ms) and int(lens[start:stop + 1].sum()) <= limit:
            stop += 1
        n = lens[start:stop]
        idx = torch.arange(int(n.sum())) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        yield ((idx + torch.repeat_interleave(lo[start:stop], n)).to(torch.int32),
               torch.repeat_interleave(ms[start:stop], n))
        start = stop


def test_magic_requant_mirror():
    """The kernel's requant equals quant/ops.py's, bit for bit: (1) the magic
    conversion equals float32(acc) for every accumulator the guard admits
    (|acc| < 2^22: nine taps of at most 128 x 128 on a bias within 2^21);
    (2) the whole sequence equals `requantize` (ReLU6, six_q 127) for every
    accumulator that does not land on a rail, at every V1 1.0-224 depthwise
    multiplier and V2 block 0's (seeded weights), and `requantize_linear`
    (the exact conversion, as the epilogue) at V2 block 0's projection
    multipliers; beyond those bands both sequences are monotone and at the
    same rail; (3) the rounding by 1.5 * 2^23 after the clamp equals rint
    then clamp at every half-integer of [-129, 128] and its neighbours."""
    assert SMALL_BIAS + TAPS_MAX < 1 << 22
    acc = torch.arange(-(1 << 22) + 1, 1 << 22, dtype=torch.int32)
    assert torch.equal((acc + MAGIC_I).view(torch.float32) - MAGIC_F, acc.float())

    cfg = ModelConfig(1.0, 224)
    q1 = quantize(fold_bn(init_params(cfg, seed=0), eps=cfg.bn_eps), cfg)
    v2 = V2Config(1.0, 96)
    q2 = quantize_v2(fold_bn_v2(init_params_v2(v2, seed=0), eps=v2.bn_eps), v2, n_calib=2)
    dw_ms = np.concatenate([b["dw"].m for b in q1.blocks] + [q2.blocks[0]["dw"].m])
    assert {float(b["dw"].six_q) for b in q1.blocks} == {127.0}
    for a, m in _bands(dw_ms, 0.0, 127.5):
        assert int(a.abs().max()) < 1 << 22
        assert torch.equal(_kernel_requant(a, m, 0.0, 127.0, True),
                           qops.requantize(a, m, 127.0, True))
    for a, m in _bands(q2.blocks[0]["prj"].m, -128.5, 127.5):
        assert torch.equal(_kernel_requant(a, m, -128.0, 127.0, False),
                           qops.requantize_linear(a, m))

    half = torch.arange(-258, 257, dtype=torch.float32) / 2
    v = torch.cat([half, torch.nextafter(half, half + 1), torch.nextafter(half, half - 1)])
    for lo in (0.0, -128.0):
        t = v.clamp(lo, 127.0) + MAGIC_F
        got = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
        assert torch.equal(got, torch.round(v).clamp(lo, 127).to(torch.int8))
