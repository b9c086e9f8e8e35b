"""The port's stem kernels (their plain versions, which the wrappers run on
CPU tensors) against the JAX package's Pallas stem kernels in interpret
mode, the fused-stem routing gate against the JAX one, and the fused-stem
forward and pipeline against the JAX package and the default pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.checkpoints import fold_bn as jax_fold_bn
from mobilenet_tpu.checkpoints import init_params as jax_init_params
from mobilenet_tpu.checkpoints import to_device as jax_to_device
from mobilenet_tpu.models import mobilenet_v1 as jax_v1
from mobilenet_tpu.ops.conv import conv2d_same as jax_conv2d_same
from mobilenet_tpu.ops.pallas_block_packed import unpack
from mobilenet_tpu.ops.pallas_stem import stem_conv_packed
from mobilenet_tpu.ops.pallas_stem_b0 import stem_block0_fused
from mobilenet_tpu_torch import InferencePipeline, ModelConfig
from mobilenet_tpu_torch.checkpoints import from_jax_params
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.ops.stem import stem_block0, stem_conv

# float32: the JAX stem kernel tests' tolerance (tests/test_pallas_stem.py,
# tests/test_pallas_stem_b0.py): the sums differ in order only.
F32_TOL = dict(atol=3e-5, rtol=1e-5)
# bfloat16: chip_smoke.py's BF16_ATOL/RTOL. Both sides round the stem and
# the depthwise results to bf16; a last-bit difference in a float32 sum can
# move a rounding by one bf16 step, which the next stage carries.
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _stem_args(seed, n, h, cout):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, h, h, 3)).astype(np.float32),
            rng.normal(0, 0.3, (3, 3, 3, cout)).astype(np.float32),
            rng.normal(0, 0.1, (cout,)).astype(np.float32))


def _b0_args(seed, n, h, cout):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, h, h, 3), dtype=np.uint8)
    img[:, -1, :, :] = 255  # the stride-2 stem reads the pad beside these
    img[:, :, -1, :] = 255
    return img, (rng.normal(0, 0.3, (3, 3, 3, 32)).astype(np.float32),
                 rng.normal(0, 0.1, (32,)).astype(np.float32),
                 rng.normal(0, 0.5, (3, 3, 1, 32)).astype(np.float32),
                 rng.normal(0, 0.2, (32,)).astype(np.float32),
                 rng.normal(0, 0.3, (32, cout)).astype(np.float32),
                 rng.normal(0, 0.2, (cout,)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cout", [(2, 64, 32), (1, 32, 16)])
def test_stem_conv_vs_pallas(dtype, n, h, cout):
    """stem_conv (B22) against stem_conv_packed in interpret mode."""
    jdt, tdt = _DT[dtype]
    arrs = _stem_args(h + cout, n, h, cout)
    ref = stem_conv_packed(*[jnp.asarray(a, jdt) for a in arrs], cout, True, interpret=True)
    got = stem_conv(*[torch.from_numpy(a).to(tdt) for a in arrs], True)
    assert got.dtype == tdt and got.shape == (n, h // 2, h // 2, cout)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("h,w", [(33, 33), (31, 40), (40, 17)])
def test_stem_conv_odd_vs_xla(h, w):
    """On an odd axis stem_conv pads (1, 1), as TF-SAME does: against the
    JAX package's XLA stem (ops/conv.conv2d_same), float32."""
    _, wt, b = _stem_args(h * w, 1, 2, 16)
    x = np.random.default_rng(w).uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    ref = jax_conv2d_same(jnp.asarray(x), jnp.asarray(wt), 2, bias=jnp.asarray(b), relu6=True)
    got = stem_conv(*(torch.from_numpy(a) for a in (x, wt, b)), True)
    assert got.shape == (2, -(-h // 2), -(-w // 2), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cout,relu6", [(2, 64, 64, True), (1, 32, 16, False)])
def test_stem_block0_vs_pallas(dtype, n, h, cout, relu6):
    """stem_block0 (B21) against unpack(stem_block0_fused) in interpret
    mode: normalize, the stem with its normalized-domain pad, block 0's
    depthwise and pointwise, each rounded to the dtype."""
    jdt, tdt = _DT[dtype]
    img, w = _b0_args(h + cout, n, h, cout)
    if not relu6:
        w = w[:4] + (w[4] * 4, w[5])  # outputs past 6
    ref = unpack(stem_block0_fused(jnp.asarray(img), *[jnp.asarray(a, jdt) for a in w],
                                   cout, relu6, interpret=True), cout)
    got = stem_block0(torch.from_numpy(img), *[torch.from_numpy(a).to(tdt) for a in w],
                      relu6)
    assert got.dtype == tdt and got.shape == (n, h // 2, h // 2, cout)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **_tol(dtype))
    if not relu6:
        assert got.max() > 6.0


@pytest.mark.parametrize("case", ["odd", "dtype_img", "dtype_w", "shape", "channels",
                                  "noncontig", "cout"])
def test_wrappers_reject(case):
    """Both wrappers check dtypes, shapes, contiguity and channel counts
    before any launch; stem_block0 also even sizes (stem_conv takes odd
    ones)."""
    img, w = _b0_args(0, 1, 16, 16)
    img = torch.from_numpy(img)
    x, sw, sb = (torch.from_numpy(a) for a in _stem_args(0, 1, 16, 16))
    w = [torch.from_numpy(a) for a in w]
    if case == "odd":
        img, x = img[:, :15].contiguous(), x[:, :, :15].contiguous()
    elif case == "dtype_img":
        img, x = img.float(), x.double()
    elif case == "dtype_w":
        w[4], sw = w[4].bfloat16(), sw.bfloat16()
    elif case == "shape":
        w[0], sb = w[0][..., :16].contiguous(), sb[:8].contiguous()
    elif case == "channels":
        w[4], w[5] = w[4][:, :12].contiguous(), w[5][:12].contiguous()
        sw, sb = sw[..., :12].contiguous(), sb[:12].contiguous()
    elif case == "noncontig":
        img, x = img.transpose(1, 2), x.transpose(1, 2)
    elif case == "cout":
        w[4], w[5] = torch.zeros(32, 12), torch.zeros(12)
        sw, sb = torch.zeros(3, 3, 3, 264), torch.zeros(264)
    with pytest.raises(ValueError):
        stem_block0(img, *w, True)
    if case == "odd":  # TF-SAME on an odd axis: stem_conv takes it
        assert stem_conv(x, sw, sb, True).shape == (1, 8, 8, 16)
        return
    with pytest.raises(ValueError):
        stem_conv(x, sw, sb, True)


_ROUTES = {  # name -> (JAX routing, port routing)
    "fused": (("fused",) * 13, ("fused",) * 13),
    "plain": (("xla",) * 13, ("plain",) * 13),
    "mixed": (("xla",) * 2 + ("fused",) * 11, ("plain",) * 2 + ("fused",) * 11),
    "b0_only": (("fused",) + ("xla",) * 12, ("fused",) + ("plain",) * 12),
}


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_stem_fusible_matches_jax(alpha):
    """The port's gate equals the JAX gate on routing x resolution x dtype;
    float32 at 224 does not fuse, bf16 at 224 does."""
    jcfg, cfg = JaxConfig(alpha, 224), ModelConfig(alpha, 224)
    tree = jax_fold_bn(jax_init_params(jcfg, 0), eps=jcfg.bn_eps)
    params = from_jax_params(tree, "cpu", torch.float32, cfg.block_strides)
    seen = set()
    for jroute, troute in _ROUTES.values():
        for res in (64, 128, 160, 224):
            for jdt, tdt in _DT.values():
                shape = (2, res, res, 3)
                want = jax_v1._stem_fusible(tree, jcfg, shape, jroute, jdt)
                assert mobilenet_v1._stem_fusible(params, cfg, shape, troute, tdt) == want
                seen.add(want)
    fused = _ROUTES["fused"][1]
    assert mobilenet_v1._stem_fusible(params, cfg, (2, 224, 224, 3), fused,
                                      torch.bfloat16) == (alpha == 1.0)
    assert not mobilenet_v1._stem_fusible(params, cfg, (2, 224, 224, 3), fused,
                                          torch.float32)
    assert seen == ({True, False} if alpha == 1.0 else {False})


def _spy(monkeypatch, name):
    calls = []
    real = getattr(mobilenet_v1, name)

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(mobilenet_v1, name, spy)
    return calls


def test_forward_u8_fused_stem_vs_jax(monkeypatch):
    """forward_u8(fuse_stem=True) at 1.0-64, batch 2, float32: block 0
    fused (the stem kernel) and the rest plain, against the JAX package's
    fused-stem forward on the same weights and images."""
    jcfg, cfg = JaxConfig(1.0, 64), ModelConfig(1.0, 64)
    tree = jax_fold_bn(jax_init_params(jcfg, 4), eps=jcfg.bn_eps)
    params = from_jax_params(tree, "cpu", torch.float32, cfg.block_strides)
    img = np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    jroute, troute = _ROUTES["b0_only"]
    ref = jax_v1.forward_u8(jax_to_device(tree), jnp.asarray(img), jcfg,
                            dw_backend=jroute, fuse_stem=True)
    calls = _spy(monkeypatch, "stem_block0")
    got = mobilenet_v1.forward_u8(params, torch.from_numpy(img), cfg, dw_backend=troute,
                                  fuse_stem=True)
    assert calls == [(2, 64, 64, 3)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


def test_pipeline_fuse_stem(monkeypatch):
    """InferencePipeline(fuse_stem=True) on the CPU: at model resolution it
    runs the fused stem and matches the default pipeline; a batch at
    another size takes the unfused path and gives the default's result."""
    cfg = ModelConfig(1.0, 128)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    base = InferencePipeline(cfg, seed=2, device="cpu", dtype=torch.float32)
    fused = InferencePipeline(cfg, seed=2, device="cpu", dtype=torch.float32,
                              fuse_stem=True)
    calls = _spy(monkeypatch, "stem_block0")
    np.testing.assert_allclose(fused.run_batch(img), base.run_batch(img),
                               atol=1e-5, rtol=1e-4)
    assert calls == [(2, 128, 128, 3)]
    other = rng.integers(0, 256, (1, 100, 90, 3), dtype=np.uint8)
    np.testing.assert_array_equal(fused.run_batch(other), base.run_batch(other))
    assert len(calls) == 1


@pytest.mark.parametrize("alpha,res", [(1.0, 224), (0.25, 128)])
def test_unfusible_shapes_run_the_stem_kernel(monkeypatch, alpha, res):
    """Where the gate refuses (float32 above 160 px; a stem narrower than
    32), fuse_stem=True runs preprocess + forward, the default pipeline's
    route, whose "fused" block 0 puts the stem on stem_conv: the same
    result as the default pipeline."""
    cfg = ModelConfig(alpha, res)
    img = np.random.default_rng(7).integers(0, 256, (1, res, res, 3), dtype=np.uint8)
    base = InferencePipeline(cfg, seed=3, device="cpu", dtype=torch.float32)
    fused = InferencePipeline(cfg, seed=3, device="cpu", dtype=torch.float32,
                              fuse_stem=True)
    b0, stem = _spy(monkeypatch, "stem_block0"), _spy(monkeypatch, "stem_conv")
    got = fused.run_batch(img)
    assert b0 == [] and stem == [(1, res, res, 3)]
    np.testing.assert_array_equal(got, base.run_batch(img))


@pytest.mark.parametrize("route,stem_calls", [("fused", 1), ("b0_only", 1), ("plain", 0),
                                              ("mixed", 0)])
def test_stem_follows_block0_route(monkeypatch, route, stem_calls):
    """forward runs the stem on stem_conv exactly when block 0 is "fused"
    (collect=True taps the plain stem), and stays within the JAX forward's
    float32 gate on every route."""
    jcfg, cfg = JaxConfig(0.25, 64), ModelConfig(0.25, 64)
    tree = jax_fold_bn(jax_init_params(jcfg, 8), eps=jcfg.bn_eps)
    params = from_jax_params(tree, "cpu", torch.float32, cfg.block_strides)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jroute, troute = _ROUTES[route]
    ref = jax_v1.forward(jax_to_device(tree), jnp.asarray(x), jcfg, dw_backend=jroute)
    stem = _spy(monkeypatch, "stem_conv")
    got = mobilenet_v1.forward(params, torch.from_numpy(x), cfg, dw_backend=troute)
    _, acts = mobilenet_v1.forward(params, torch.from_numpy(x), cfg, dw_backend=troute,
                                   collect=True)
    assert len(stem) == stem_calls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    assert acts["conv1"].shape == (2, 32, 32, 8)
