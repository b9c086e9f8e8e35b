"""The port's CUDA kernels against their plain versions on the card, at the
ragged and narrow shapes of the whole alpha grid (partial pixel and channel
tiles, C = 8 .. 1024), the V1 and V2 kernel routes (float and int8), the
V3-Large and -Small float and int8 routes against the plain routes, the V3
chain against the per-block kernel bit for bit, the floor probes, the
float32 stem and matmuls against float64 without any TF32 flag set or with
the float32 matmul precision at "high", and `cli verify` on the card.
Marked `cuda`: skipped without a card. Imports no JAX, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from mobilenet_tpu_torch import (
    InferencePipeline, Int8Pipeline, Int8PipelineV2, Int8PipelineV3, ModelConfig, V2Config,
    V3Config, floors,
)
from mobilenet_tpu_torch.block_times import HEAD_FORMS
from mobilenet_tpu_torch.checkpoints import (
    fold_bn, fold_bn_v2, fold_bn_v3, init_params, init_params_v2, init_params_v3,
)
from mobilenet_tpu_torch.models import mobilenet_v1, mobilenet_v2, mobilenet_v3
from mobilenet_tpu_torch.ops import _build
from mobilenet_tpu_torch.ops import preprocess as prep
from mobilenet_tpu_torch.ops.chain import chain, chain_plain
from mobilenet_tpu_torch.ops.depthwise import depthwise, depthwise_plain, dw_plan, dw_smem_bytes
from mobilenet_tpu_torch.ops.depthwise_i8 import depthwise_i8, depthwise_i8_plain
from mobilenet_tpu_torch.ops.head import fused_head, fused_head_plain
from mobilenet_tpu_torch.ops.inverted_residual import inverted_residual, inverted_residual_plain
from mobilenet_tpu_torch.ops.inverted_residual_i8 import (
    inverted_residual_i8, inverted_residual_i8_plain,
)
from mobilenet_tpu_torch.ops.separable_block import (
    f32_sep_plan, f32_sep_smem_bytes, separable_block, separable_block_plain, separable_plan,
    separable_smem_bytes,
)
from mobilenet_tpu_torch.ops.separable_block_i8 import (
    padded_cin, separable_block_i8, separable_block_i8_plain, separable_i8_plan,
    separable_i8_smem_bytes,
)
from mobilenet_tpu_torch.ops.stem import (
    f32_stem_plan, f32_stem_smem_bytes, stem_block0, stem_block0_plain, stem_conv,
    stem_conv_plain, stem_plan, stem_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_block import (
    v3_block, v3_block_plain, v3_plan, v3_smem_bytes, v3_wgmma_plan, v3_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_block_i8 import (
    FULL, GATED, POOL, kernel_weights, v3_block_i8, v3_block_i8_plain, v3_i8_kernel_weights,
    v3_i8_wgmma_plan, v3_i8_wgmma_smem_bytes,
)
from mobilenet_tpu_torch.ops.v3_chain import v3_chain, v3_chain_plain
from mobilenet_tpu_torch.quant import ACT_IN_SCALE, quantize_input
from mobilenet_tpu_torch.quant import ops as qops
from mobilenet_tpu_torch.quant.model import forward_i8
from mobilenet_tpu_torch.quant.v2 import forward_v2_i8
from mobilenet_tpu_torch.quant.v3 import _quant_named, device_layer_v3, forward_v3_i8
from mobilenet_tpu_torch.quant.verify import verify_int8, verify_int8_v2, verify_int8_v3
from mobilenet_tpu_torch.runtime.serving import build_server, selftest

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


# Shapes that reach each branch of the bf16 kernel's plan (separable_plan):
# K padded to 16 (Cin 8, 24, 40), Cin in ranges (2048), slices of 128 + 8
# and 32 + 8 columns, the Cout split at batch 1 (14^2, 7^2), one warpgroup
# (b12 at batch 256), a ragged pixel tile at stride 2.
PLAN_SHAPES = [
    (2, 20, 8, 24, 1),        # Cin 8: one 16-wide K step; slices 16 + 8
    (3, 18, 24, 40, 2),       # Cin 24, stride 2, ragged tile; slices 32 + 8
    (2, 9, 40, 136, 1),       # Cin 40; slices 128 + 8
    (1, 14, 512, 512, 1),     # batch 1, 14^2: Cout split
    (1, 7, 1024, 1024, 1),    # batch 1, 7^2: Cout split, one warpgroup
    (256, 7, 1024, 1024, 1),  # b12 at batch 256
    (2, 7, 2048, 200, 1),     # Cin 2048: the panel holds Cin in ranges; 128 + 64 + 8
    (5, 14, 64, 72, 2),       # stride 2, 7^2 outputs in 64-pixel tiles; slices 64 + 8
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,cout,stride", PLAN_SHAPES)
def test_separable_block_plan_shapes(dev, dtype, n, h, cin, cout, stride):
    rng = np.random.default_rng(n * cin + cout)
    args = (_t(rng, (n, h, h, cin), dtype, dev, lo=-1), _t(rng, (3, 3, 1, cin), dtype, dev, 0.5),
            _t(rng, (cin,), dtype, dev, 0.2), _t(rng, (cin, cout), dtype, dev, cin ** -0.5),
            _t(rng, (cout,), dtype, dev, 0.2), stride, True)
    _close(separable_block(*args), separable_block_plain(*args), dtype)


def test_separable_plan_smem_mirror(dev):
    """The kernel's shared-memory arithmetic equals separable_smem_bytes."""
    lib = _build.library()
    for n, h, cin, cout, stride in PLAN_SHAPES + [(256, 112, 32, 64, 1), (256, 112, 64, 128, 2),
                                                 (256, 14, 512, 1024, 2)]:
        p = separable_plan(n, h, h, cin, cout, stride)
        assert lib.separable_bf16_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride) == \
            separable_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,c,classes", [(1, 7, 1024, 1000), (13, 4, 256, 1000),
                                            (9, 5, 200, 130)])
def test_fused_head(dev, dtype, n, hw, c, classes):
    rng = np.random.default_rng(n)
    x = _t(rng, (n, hw, hw, c), dtype, dev, lo=0)
    w, b = _t(rng, (c, classes), dtype, dev, c ** -0.5), _t(rng, (classes,), dtype, dev, 0.1)
    post = [(w, b, "linear")]
    _close(fused_head(x, None, post), fused_head_plain(x, None, post), dtype)


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


# -- V2 ----------------------------------------------------------------------


def test_stem_is_true_float32_without_flags():
    """The float32 pipeline's stem (conv1 tap) against a float64 convolution
    on the card within golden.MM_TOL, with cuDNN's TF32 left at its default
    (on): the stem turns it off around its own call. The size matters: at
    1.0-224 batch 8 cuDNN picks a TF32 tensor-core kernel when allowed, at
    0.25-128 batch 2 it does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = True  # the default
    pipe = InferencePipeline(ModelConfig(1.0, 224), device="cuda", seed=3)
    x = np.random.default_rng(3).uniform(-1, 1, (8, 224, 224, 3)).astype(np.float32)
    _, acts = pipe.activations(x)
    w, b = pipe.params["conv1"]["w"].double(), pipe.params["conv1"]["b"].double()
    xc = torch.nn.functional.pad(torch.from_numpy(x).cuda().double().permute(0, 3, 1, 2),
                                 (0, 1, 0, 1))  # TF-SAME at stride 2: (0, 1)
    ref = torch.nn.functional.conv2d(xc, w.permute(3, 2, 0, 1), stride=2)
    ref = (ref.permute(0, 2, 3, 1) + b).clamp(0, 6).cpu().numpy()
    assert torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(acts["conv1"], ref, atol=1e-4, rtol=3e-4)


def test_matmuls_are_true_float32_under_high_precision():
    """The float32 pipeline's pointwise products under
    torch.set_float32_matmul_precision("high"), which lets cuBLAS run
    float32 matmuls in TF32: the block00_pw tap (K = 32) against its
    float64 recomputation from the block00_dw tap within golden.MM_TOL
    (1e-4, 3e-4). The precision is restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        pipe = InferencePipeline(ModelConfig(1.0, 224), device="cuda", seed=3)
        x = np.random.default_rng(4).uniform(-1, 1, (8, 224, 224, 3)).astype(np.float32)
        _, acts = pipe.activations(x)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    pw = pipe.params["blocks"][0]["pw"]
    dw = torch.from_numpy(acts["block00_dw"]).double()
    ref = (dw.reshape(-1, dw.shape[-1]) @ pw["w"].double().cpu() + pw["b"].double().cpu())
    ref = ref.clamp(0, 6).reshape(*dw.shape[:3], -1).numpy()
    np.testing.assert_allclose(acts["block00_pw"], ref, atol=1e-4, rtol=3e-4)


def _ir_args(rng, dev, dtype, n, h, cin, e, cout):
    return (_t(rng, (n, h, h, cin), dtype, dev, 0.5), _t(rng, (cin, e), dtype, dev, cin ** -0.5),
            _t(rng, (e,), dtype, dev, 0.3), _t(rng, (3, 3, 1, e), dtype, dev, 0.3),
            _t(rng, (e,), dtype, dev, 0.2), _t(rng, (e, cout), dtype, dev, e ** -0.5),
            _t(rng, (cout,), dtype, dev, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 12, 24, 144, 24, 1, True),    # residual, Cin not a multiple of 32
    (3, 10, 16, 96, 24, 2, False),    # V2 b01's widths at stride 2, ragged tiles
    (1, 7, 160, 960, 320, 1, False),  # V2 b16's widths: TM x Cout at the limit
    (2, 9, 8, 48, 8, 1, True),        # alpha 0.35's narrowest, odd side
])
def test_inverted_residual(dev, dtype, n, h, cin, e, cout, stride, residual):
    """The V3 bottleneck's tiles with ReLU6 and k 3 (bf16 the Hopper tile,
    float32 the CUDA-core tile); either counts on `inverted_residual`
    alone."""
    rng = np.random.default_rng(cin + e)
    args = _ir_args(rng, dev, dtype, n, h, cin, e, cout) + (stride, residual)
    before = (inverted_residual.launches, v3_block.launches)
    got = inverted_residual(*args)
    assert (inverted_residual.launches, v3_block.launches) == (before[0] + 1, before[1])
    _close(got, inverted_residual_plain(*args), dtype)


def test_ir_smem_plan_matches_kernel(dev):
    """The Python mirrors of the kernels' shared-memory plans equal the
    kernels' own for every expanded V2 block at alpha 0.35, 1.0 and 1.4,
    batch 1 and 256: bf16's Hopper tile (`v3_wgmma_plan`) and float32's
    CUDA-core tile (`v3_plan`)."""
    lib = _build.library()
    for alpha in (0.35, 1.0, 1.4):
        h = 112
        for t, cin, cout, stride in V2Config(alpha, 224).block_defs:
            for n in ((1, 256) if t > 1 else ()):
                p = v3_wgmma_plan(n, h, h, cin, t * cin, cout, 3, stride, 0, False)
                args = (p.th, p.tw, cin, t * cin, cout, 3, stride, p.cw, p.ws, p.bs, 0)
                assert lib.v3_wgmma_smem_bytes(*args) == v3_wgmma_smem_bytes(*args)
                fp = v3_plan(n, h, h, cin, t * cin, cout, 3, stride, 0)
                args = (fp.th, fp.tw, h, h, cin, t * cin, cout, 0, 3, stride, fp.ws, fp.bs, 0)
                assert lib.v3_f32_smem_bytes(*args) == v3_smem_bytes(*args)
            h //= stride


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,cout,stride", [(2, 16, 32, 16, 1), (3, 10, 8, 24, 2),
                                                 (4, 56, 32, 16, 1)])
def test_separable_block_linear(dev, dtype, n, h, cin, cout, stride):
    rng = np.random.default_rng(cin + cout + 1)
    args = (_t(rng, (n, h, h, cin), dtype, dev, lo=-1), _t(rng, (3, 3, 1, cin), dtype, dev, 0.5),
            _t(rng, (cin,), dtype, dev, 0.2), _t(rng, (cin, cout), dtype, dev, cin ** -0.5),
            _t(rng, (cout,), dtype, dev, 0.2), stride, True)
    got = separable_block(*args, pw_act=False)
    _close(got, separable_block_plain(*args, pw_act=False), dtype)
    assert (got < 0).any()


# The raw partial: no output rounding, so the bf16 gap is absolute: one
# depthwise value a bf16 step off (~2^-8 of up to 6) times a weight of the
# data's scale, Cin^-0.5 (chip_smoke.py partial_bf16_atol); no relative term.
def _partial_tol(dtype, cin):
    return (1e-4, 3e-4) if dtype == torch.float32 else (6 * 2 ** -8 / cin ** 0.5, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,cout,stride", [(2, 28, 128, 256, 1),  # V1 b04 at tp 2
                                                 (3, 14, 128, 1024, 2)])  # b11 at tp 4
def test_separable_block_raw_partial(dev, dtype, n, h, cin, cout, stride):
    """pw_epilogue=False at two V1 1.0-224 shard shapes: the float32 raw
    product (no pw bias, no activation) against its plain version."""
    rng = np.random.default_rng(cin + cout + 2)
    args = (_t(rng, (n, h, h, cin), dtype, dev, lo=-1), _t(rng, (3, 3, 1, cin), dtype, dev, 0.5),
            _t(rng, (cin,), dtype, dev, 0.2), _t(rng, (cin, cout), dtype, dev, cin ** -0.5),
            _t(rng, (cout,), dtype, dev, 5.0), stride, True)
    before = separable_block.partial_launches
    got = separable_block(*args, pw_epilogue=False)
    assert got.dtype == torch.float32 and separable_block.partial_launches == before + 1
    ref = separable_block_plain(*args, pw_epilogue=False)
    torch.cuda.synchronize()
    atol, rtol = _partial_tol(dtype, cin)
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    # no activation (negative outputs); the pw bias (scale 5) lies far outside atol
    assert (got < 0).any()
    # the planted control: an output rounded to bf16 misses the gate
    assert not torch.allclose(ref.bfloat16().float(), ref, atol=atol, rtol=rtol)


def test_separable_block_raw_partial_misaligned_shard(dev):
    """A channel shard sliced as a view that is not 16-byte aligned raises
    (check_aligned); forward_tp_fused makes each shard contiguous."""
    flat = torch.zeros(14 * 14 * 128 + 2, dtype=torch.bfloat16, device=dev)
    shard = flat[2:].view(1, 14, 14, 128)  # contiguous, 4 bytes past an aligned base
    w = (torch.zeros(3, 3, 1, 128, dtype=torch.bfloat16, device=dev),
         torch.zeros(128, dtype=torch.bfloat16, device=dev),
         torch.zeros(128, 64, dtype=torch.bfloat16, device=dev),
         torch.zeros(64, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        separable_block(shard, *w, 1, True, pw_epilogue=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,c,e,posts,conv_act", [
    (3, 7, 320, 1280, [(1000, "linear")], "relu6"),                    # V2
    (5, 7, 160, 960, [(1280, "hswish"), (1000, "linear")], "hswish"),  # V3-Large
    (1, 3, 24, 200, [], "relu"),                                        # no post
    # bf16: the eager ring (fewer slots than C's 64-channel chunks): two
    # warpgroups, 7 slots for 9 chunks; one, 11 for 16; one, 2 for 25 (the
    # widest C the bf16 kernel takes)
    (64, 7, 576, 256, [(128, "linear")], "relu6"),
    (1, 7, 1024, 128, [], "relu"),
    (16, 7, 1600, 192, [(64, "linear")], "hswish"),
])
def test_fused_head_conv_last(dev, dtype, n, hw, c, e, posts, conv_act):
    rng = np.random.default_rng(n + c)
    x = _t(rng, (n, hw, hw, c), dtype, dev, lo=0)
    conv = (_t(rng, (c, e), dtype, dev, c ** -0.5), _t(rng, (e,), dtype, dev, 0.1), conv_act)
    post, k = [], e
    for m, act in posts:
        post.append((_t(rng, (k, m), dtype, dev, k ** -0.5), _t(rng, (m,), dtype, dev, 0.1), act))
        k = m
    _close(fused_head(x, conv, post), fused_head_plain(x, conv, post), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8, 64, 65, 256])
@pytest.mark.parametrize("form", sorted(HEAD_FORMS))
def test_fused_head_forms(dev, dtype, batch, form):
    """Every model form at the serving buckets, batch 256 and a ragged 65
    (a second, one-image row tile; image groups of uneven length)."""
    c, conv_spec, posts = HEAD_FORMS[form]
    rng = np.random.default_rng(batch + c)
    x = _t(rng, (batch, 7, 7, c), dtype, dev, lo=0) * 6
    conv, k = None, c
    if conv_spec is not None:
        e, act = conv_spec
        conv = (_t(rng, (c, e), dtype, dev, c ** -0.5), _t(rng, (e,), dtype, dev, 0.1), act)
        k = e
    post = []
    for m, act in posts:
        post.append((_t(rng, (k, m), dtype, dev, k ** -0.5), _t(rng, (m,), dtype, dev, 0.1), act))
        k = m
    _close(fused_head(x, conv, post), fused_head_plain(x, conv, post), dtype)


@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("form", sorted(HEAD_FORMS))
def test_fused_head_f32_small_batches(dev, batch, form):
    """The float32 head (csrc/head_f32.cuh) in every form at batch 2 and 3
    (beside test_fused_head_forms' 1, 8, 64, 65 and 256): the 16-row post
    tiles with ragged rows and the K-split conv_last."""
    c, conv_spec, posts = HEAD_FORMS[form]
    rng = np.random.default_rng(batch + c + 1)
    dtype = torch.float32
    x = _t(rng, (batch, 7, 7, c), dtype, dev, lo=0) * 6
    conv, k = None, c
    if conv_spec is not None:
        e, act = conv_spec
        conv = (_t(rng, (c, e), dtype, dev, c ** -0.5), _t(rng, (e,), dtype, dev, 0.1), act)
        k = e
    post = []
    for m, act in posts:
        post.append((_t(rng, (k, m), dtype, dev, k ** -0.5), _t(rng, (m,), dtype, dev, 0.1), act))
        k = m
    _close(fused_head(x, conv, post), fused_head_plain(x, conv, post), dtype)


@pytest.mark.parametrize("n", [1, 3, 256])
def test_fused_head_f32_wide_conv_last(dev, n):
    """float32 takes a conv_last wider than the bf16 kernel's resident limit
    (1600): C 2048, its weight streamed."""
    rng = np.random.default_rng(n + 2048)
    dtype = torch.float32
    x = _t(rng, (n, 7, 7, 2048), dtype, dev, lo=0)
    conv = (_t(rng, (2048, 256), dtype, dev, 2048 ** -0.5), _t(rng, (256,), dtype, dev, 0.1),
            "relu6")
    post = [(_t(rng, (256, 104), dtype, dev, 256 ** -0.5), _t(rng, (104,), dtype, dev, 0.1),
             "linear")]
    _close(fused_head(x, conv, post), fused_head_plain(x, conv, post), dtype)


@pytest.mark.parametrize("batch", [1, 4])
def test_v2_pipeline_routes_agree(dev, batch):
    """V2 0.35-96: the float32 kernel route against the float32 plain route
    at golden.V2_TOL; the bf16 kernel route against the bf16 plain route at
    the JAX package's V2 routing gate (chip_smoke.py: the extreme-value term
    over the logits, and no farther from the float32 route in RMS than 1.5x
    the plain route's distance + 6e-2)."""
    x = np.random.default_rng(batch).uniform(-1, 1, (batch, 96, 96, 3)).astype(np.float32)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cfg = V2Config(0.35, 96, compute_dtype=dtype)
        pipe = InferencePipeline(cfg, device="cuda")
        xd = torch.from_numpy(x).to(dev, pipe.dtype)
        with torch.inference_mode():
            logits[dtype] = [mobilenet_v2.forward_v2(pipe.params, xd, cfg, dw_backend=r).float()
                             for r in ("auto", "plain")]
    (got32, ref32), (got, ref) = logits["float32"], logits["bfloat16"]
    torch.testing.assert_close(got32, ref32, atol=1e-3, rtol=1e-3)
    rms = lambda t: float(t.pow(2).mean().sqrt())  # noqa: E731
    atol = max(6e-2, 4.5e-2 * float(ref.abs().max()),
               1.5 * rms(got - ref) * float(np.sqrt(2 * np.log(got.numel()))))
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    assert rms(got - ref32) <= 1.5 * rms(ref - ref32) + 6e-2


def test_cpu_tensor_never_launches(dev):
    x = torch.zeros(1, 8, 8, 8)
    w = (torch.zeros(3, 3, 1, 8), torch.zeros(8), torch.zeros(8, 8), torch.zeros(8))
    img = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    ws = (torch.zeros(3, 3, 3, 32), torch.zeros(32), torch.zeros(3, 3, 1, 32), torch.zeros(32),
          torch.zeros(32, 16), torch.zeros(16))
    before = (separable_block.launches, stem_block0.launches, stem_conv.launches)
    separable_block(x, *w, 1, True)
    stem_block0(img, *ws, True)
    stem_conv(img.float(), ws[0], ws[1], True)
    assert (separable_block.launches, stem_block0.launches, stem_conv.launches) == before


# -- int8: every comparison is exact (torch.equal) ---------------------------


def _i8_layer(rng, c, dev, scale):
    """int8 weights in [-127, 127], int32 biases, float32 multipliers that
    put most requantized values inside (0, 127)."""
    return (torch.from_numpy(rng.integers(-5000, 5000, (c,)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.uniform(0.2, 1.5, (c,)).astype(np.float32) * scale).to(dev))


def _i8_block(rng, dev, n, h, cin, cout):
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, h, cin)).astype(np.int8)).to(dev)
    dw_w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, cin)).astype(np.int8)).to(dev)
    pw_w = torch.from_numpy(rng.integers(-127, 128, (cin, cout)).astype(np.int8)).to(dev)
    return (x, dw_w, *_i8_layer(rng, cin, dev, 4e-3), pw_w,
            *_i8_layer(rng, cout, dev, 0.5 / cin ** 0.5 / 60))


@pytest.mark.parametrize("n,h,cin,cout,stride", [
    (2, 64, 8, 16, 1),      # alpha 0.25 block 0: one partial K chunk
    (3, 10, 24, 48, 2),     # alpha 0.75 widths, ragged pixel tile
    (1, 7, 1024, 1024, 1),  # 49 pixels: one partial pixel tile
    (2, 14, 96, 192, 2),    # partial channel tiles at both ends
    (1, 9, 40, 136, 1),     # odd spatial size, Cout just over one tile
    (2, 9, 64, 128, 2),     # odd spatial size at stride 2 (TF-SAME lo=1)
])
@pytest.mark.parametrize("relu6", [True, False])
def test_separable_block_i8(dev, n, h, cin, cout, stride, relu6):
    rng = np.random.default_rng(cin + cout + stride)
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = _i8_block(rng, dev, n, h, cin, cout)
    # six_q below 127 so that the in-domain ReLU6 clip is reached
    args = (x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride, 100.0, 50.0, relu6)
    before = separable_block_i8.launches
    got = separable_block_i8(*args)
    assert separable_block_i8.launches == before + 1
    ref = separable_block_i8_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert 0 < int((ref > 0).sum()) < ref.numel() - int((ref == 127).sum())


def _v1_i8_block_shapes(batch):
    cfg = ModelConfig(1.0, 224)
    hw, cin, out = 112, cfg.stem_channels, []
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        out.append((batch, hw, cin, cout, stride))
        hw, cin = -(-hw // stride), cout
    return out


@pytest.mark.parametrize("n,h,cin,cout,stride", _v1_i8_block_shapes(1))
def test_separable_block_i8_v1_batch1(dev, n, h, cin, cout, stride):
    """The 13 V1 1.0-224 block shapes at batch 1 (the plan's Cout split), with
    the K-major copy passed as the int8 route passes it."""
    rng = np.random.default_rng(h * cin + cout)
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = _i8_block(rng, dev, n, h, cin, cout)
    args = (x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, stride, 127.0, 127.0, True)
    ref = separable_block_i8_plain(*args)
    _equal_i8(separable_block_i8(*args, pw_wt=pw_w.t().contiguous()), ref)
    assert 0 < int((ref > 0).sum()) < ref.numel()


@pytest.mark.parametrize("n", [1, 8])
def test_separable_block_i8_v2_b00_linear(dev, n):
    """V2 1.0-224 block 0 (112^2 x 32 -> 16, the linear mode)."""
    rng = np.random.default_rng(n)
    args = _i8_block(rng, dev, n, 112, 32, 16) + (1, 127.0, 0.0, True)
    ref = separable_block_i8_plain(*args, pw_linear=True)
    _equal_i8(separable_block_i8(*args, pw_linear=True, pw_wt=args[4].t().contiguous()), ref)
    assert (ref < 0).any() and (ref > 0).any()


@pytest.mark.parametrize("linear", [False, True])
def test_separable_block_i8_large_bias(dev, linear):
    """Depthwise biases beyond 2^21 on some 16-channel groups: those groups
    convert their sums with __int2float_rn (|acc| past 2^22), the others with
    the magic-number conversion; both exact. The pointwise bias too."""
    rng = np.random.default_rng(7)
    x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m = _i8_block(rng, dev, 2, 14, 256, 64)
    big = torch.from_numpy(rng.integers(-(1 << 27), 1 << 27, (256,)).astype(np.int32)).to(dev)
    group = torch.arange(256, device=dev) // 16
    dw_b = torch.where(group % 3 == 0, big, dw_b).contiguous()
    dw_m = torch.where(group % 3 == 0, dw_m / 2 ** 15, dw_m).contiguous()
    pw_b = (pw_b * 3000).contiguous()
    args = (x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, 1, 100.0, 50.0, True)
    ref = separable_block_i8_plain(*args, pw_linear=linear)
    _equal_i8(separable_block_i8(*args, pw_linear=linear), ref)
    dw = qops.depthwise_i8(x, dw_w, dw_b, dw_m, 100.0, 1, True)
    assert 0 < int((dw[..., group % 3 == 0] > 0).sum()) < dw[..., group % 3 == 0].numel()


@pytest.mark.parametrize("n,h,cin,cout,stride", [(2, 14, 96, 192, 2), (3, 10, 24, 48, 2)])
def test_separable_block_i8_pw_wt(dev, n, h, cin, cout, stride):
    """The stored K-major copy (pw_wt) and the wrapper's own transpose give
    the same output; a Cin not a multiple of 16 pads both."""
    rng = np.random.default_rng(cin)
    args = _i8_block(rng, dev, n, h, cin, cout) + (stride, 100.0, 50.0, True)
    ref = separable_block_i8_plain(*args)
    _equal_i8(separable_block_i8(*args), ref)
    _equal_i8(separable_block_i8(*args, pw_wt=args[4].t().contiguous()), ref)


@pytest.mark.parametrize("n,h,cin,cout,stride,linear", [
    (4, 112, 32, 136, 2, False),  # slices 64 + 64 + 8, Cout not a multiple of 16
    (2, 56, 32, 64, 1, True),     # the linear mode
    (3, 33, 24, 40, 2, False),    # odd input at stride 2, Cin padded to 32
])
def test_separable_block_i8_four_warpgroups(dev, n, h, cin, cout, stride, linear):
    """Narrow blocks (Cin <= 32) run four consumer warpgroups with the lean
    depthwise and slices of at most 64 columns."""
    assert separable_i8_plan(n, h, h, padded_cin(cin), cout, stride).nwg == 4
    rng = np.random.default_rng(n + cin)
    args = _i8_block(rng, dev, n, h, cin, cout) + (stride, 100.0, 50.0, True)
    ref = separable_block_i8_plain(*args, pw_linear=linear)
    _equal_i8(separable_block_i8(*args, pw_linear=linear), ref)
    assert 0 < int((ref > 0).sum()) < ref.numel()


def test_separable_i8_plan_smem_mirror(dev):
    """The int8 kernel's shared-memory arithmetic equals
    separable_i8_smem_bytes."""
    lib = _build.library()
    for n, h, cin, cout, stride in _v1_i8_block_shapes(256) + _v1_i8_block_shapes(1) + [
            (2, 7, 2048, 200, 1), (3, 10, 24, 48, 2), (256, 112, 32, 16, 1)]:
        cin16 = padded_cin(cin)
        p = separable_i8_plan(n, h, h, cin16, cout, stride)
        assert lib.separable_i8_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride,
                                           cin16) == \
            separable_i8_smem_bytes(p.nwg, p.th, p.tw, p.kp, p.ws, p.bs, stride, cin16)


@pytest.mark.parametrize("n,h,c,stride", [(2, 64, 8, 1), (3, 10, 24, 2), (1, 7, 1024, 1),
                                          (2, 9, 40, 2), (1, 56, 128, 2), (1, 9, 24, 1),
                                          (2, 15, 40, 1), (1, 13, 8, 2), (2, 112, 32, 1),
                                          (2, 112, 64, 2), (2, 7, 1000, 1), (3, 11, 264, 2)])
def test_depthwise_i8(dev, n, h, c, stride):
    """The TMA form (C % 16 == 0) and the cp.async form (C % 16 == 8: C = 8,
    24, 40, 264, 1000), odd sides at stride 2, batch 1 to 3, slices that do
    not divide C."""
    rng = np.random.default_rng(c + h)
    x, w, b, m, *_ = _i8_block(rng, dev, n, h, c, 8)
    before = depthwise_i8.launches
    got = depthwise_i8(x, w, b, m, 127.0, stride, True)
    assert depthwise_i8.launches == before + 1
    ref = depthwise_i8_plain(x, w, b, m, 127.0, stride, True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("c,stride", [(24, 1), (48, 2), (256, 1)])
@pytest.mark.parametrize("six_q,relu6", [(100.0, True), (127.0, False)])
def test_depthwise_i8_requant_modes(dev, c, stride, six_q, relu6):
    """ReLU6 at six_q 100 (clips where 127 would not) and plain ReLU, with one
    16-channel group's biases beyond 2^21 (the __int2float_rn conversion) and
    the rest within (the magic conversion), exactly."""
    rng = np.random.default_rng(c + stride)
    x, w, b, m, *_ = _i8_block(rng, dev, 2, 12, c, 8)
    b[:16] += torch.tensor(rng.choice([-1, 1], 16) * (3 << 21), dtype=torch.int32, device=dev)
    m[:16] *= 1e-3
    m[16:] *= 6
    got = depthwise_i8(x, w, b, m, six_q, stride, relu6)
    ref = depthwise_i8_plain(x, w, b, m, six_q, stride, relu6)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int(ref.max()) == (100 if relu6 else 127) and (ref == 0).any()


@pytest.mark.parametrize("batch", [256, 2])
def test_depthwise_i8_v1_layers(dev, batch):
    """Every distinct depthwise layer of V1 1.0-224, exactly."""
    rng = np.random.default_rng(batch)
    h, c = 112, 32
    cfg = ModelConfig(1.0, 224)
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        x, w, b, m, *_ = _i8_block(rng, dev, batch, h, c, 8)
        got = depthwise_i8(x, w, b, m, 127.0, stride, True)
        assert torch.equal(got, depthwise_i8_plain(x, w, b, m, 127.0, stride, True)), (h, c)
        h, c = -(-h // stride), cout
        del x, got
        torch.cuda.empty_cache()


def test_depthwise_smem_mirror(dev):
    """ops/depthwise.dw_smem_bytes equals the kernel's own count at the plans
    of V1 1.0-224 and the edge shapes, every element size."""
    lib = _build.library()
    for n, h, c, stride in [(256, 112, 32, 1), (256, 112, 64, 2), (2, 7, 1024, 1),
                            (3, 9, 40, 2), (1, 300, 32, 1), (256, 14, 512, 2)]:
        for elem in (1, 2, 4):
            p = dw_plan(n, h, h, c, elem, stride)
            assert lib.depthwise_smem_bytes(elem, stride, p.th, p.tw, p.nv, p.ws) == \
                dw_smem_bytes(elem, stride, p.th, p.tw, p.nv, p.ws)


def test_quantize_input_all_uint8(dev):
    """preprocess + quantize_input_dev on the card over all 256 uint8 values
    equals the host twin (a division, not a multiply by the reciprocal)."""
    imgs = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    x = prep.preprocess(torch.from_numpy(imgs).to(dev), 16)
    got = qops.quantize_input_dev(x, ACT_IN_SCALE).cpu().numpy()
    np.testing.assert_array_equal(got, quantize_input(x.cpu().numpy()))


@pytest.mark.parametrize("alpha,res", [(0.25, 128), (0.75, 160)])
def test_int8_routes_and_verify(dev, alpha, res):
    """int8 kernel route == plain route bit for bit at batch 1 and 4, and
    the per-layer route with the depthwise kernel passes the exact gate."""
    cfg = ModelConfig(alpha, res)
    pipe = Int8Pipeline(cfg, device="cuda")
    rng = np.random.default_rng(0)
    for batch in (1, 4):
        imgs = torch.from_numpy(rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8))
        x_q = qops.quantize_input_dev(prep.preprocess(imgs.to(dev), res), ACT_IN_SCALE)
        got = forward_i8(pipe.dev, x_q, cfg, dw_backend="auto")
        ref = forward_i8(pipe.dev, x_q, cfg, dw_backend="plain")
        assert torch.equal(got, ref)
    folded = fold_bn(init_params(cfg, seed=1), eps=cfg.bn_eps)
    x = rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    before = depthwise_i8.launches
    assert verify_int8(cfg, folded, x, device="cuda", use_dw_kernel=True)
    assert depthwise_i8.launches == before + 13


# -- V2 int8: exact ------------------------------------------------------------


def _i8_ir(rng, dev, n, h, cin, e, cout, prj_gain=1.0):
    """int8 inverted-residual operands: x over the whole int8 range (a
    bottleneck activation), multipliers that spread each requant's values
    over its range (prj_gain > 1 drives the projection into saturation)."""
    def t(a):
        return torch.from_numpy(a).to(dev)

    def layer(shape, c, m_scale):
        return (t(rng.integers(-127, 128, shape).astype(np.int8)),
                t(rng.integers(-5000, 5000, (c,)).astype(np.int32)),
                t((rng.uniform(0.2, 1.5, (c,)) * m_scale).astype(np.float32)))

    x = t(rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8))
    ew, eb, em = layer((cin, e), e, 0.0113 / cin ** 0.5)
    dw, db, dm = layer((3, 3, 1, e), e, 0.0055)
    pw, pb, pm = layer((e, cout), cout, prj_gain * 0.0137 / e ** 0.5)
    return (x, ew, eb, em, 127.0, dw, db, dm, 127.0, pw, pb, pm)


def _forms(args):
    """The kernel's weight forms of `_i8_ir`'s layers, as the V2 route's
    upload makes them."""
    return kernel_weights({"w": args[1]}, {"w": args[5]}, {"w": args[9]})


def _equal_i8(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert torch.equal(got, ref), f"{int((got != ref).sum())} elements differ"


@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 112, 16, 96, 24, 2, False),   # V2 1.0-224 b01 (the packed s2 expand block's)
    (2, 56, 24, 144, 24, 1, True),    # b02: Cin and E not multiples of 32
    (3, 14, 96, 576, 160, 2, False),  # b13 (the JAX package's V3-kernel bridge)
    (2, 7, 160, 960, 320, 1, False),  # b16: TM x Cout at the fragment limit
    (2, 9, 8, 48, 8, 1, True),        # alpha 0.35's narrowest, odd side
    (3, 10, 40, 240, 48, 2, False),   # ragged tiles at stride 2
])
def test_inverted_residual_i8(dev, n, h, cin, e, cout, stride, residual):
    rng = np.random.default_rng(cin + e + stride)
    args = _i8_ir(rng, dev, n, h, cin, e, cout) + (stride, residual)
    wt = _forms(args)
    before = (inverted_residual_i8.launches, v3_block_i8.launches)
    got = inverted_residual_i8(*args, wt=wt)
    assert (inverted_residual_i8.launches, v3_block_i8.launches) == (before[0] + 1, before[1])
    ref = inverted_residual_i8_plain(*args)
    _equal_i8(got, ref)
    assert (ref < 0).any() and len(torch.unique(ref)) > 64  # a spread, not a constant


def test_inverted_residual_i8_saturation(dev):
    """Inputs at the int8 rails and a projection driven into saturation:
    the kernel's requant clamp and saturating residual add equal the plain
    version's."""
    rng = np.random.default_rng(7)
    args = list(_i8_ir(rng, dev, 2, 28, 32, 192, 32, prj_gain=8.0)) + [1, True]
    args[0] = torch.where(torch.rand(args[0].shape, device=dev) < 0.5, 120, -120).to(
        torch.int8)
    ref = inverted_residual_i8_plain(*args)
    _equal_i8(inverted_residual_i8(*args, wt=_forms(args)), ref)
    assert (ref == 127).any() and (ref == -128).any()


def test_ir_i8_smem_plan_matches_kernel(dev):
    """The Python mirror of the int8 Hopper tile's shared-memory plan equals
    the kernel's own for every expanded V2 block's plan (`v3_i8_wgmma_plan`)
    at alpha 0.35, 1.0 and 1.4, batch 1 and 256."""
    lib = _build.library()
    for alpha in (0.35, 1.0, 1.4):
        h = 112
        for t, cin, cout, stride in V2Config(alpha, 224).block_defs:
            for n in ((1, 256) if t > 1 else ()):
                p = v3_i8_wgmma_plan(n, h, h, cin, t * cin, cout, 3, stride, 0, False)
                args = (p.th, p.tw, cin, t * cin, cout, 3, stride, p.cw, p.ws, p.bs, False,
                        FULL)
                assert lib.v3_i8_wgmma_smem_bytes(*args) == v3_i8_wgmma_smem_bytes(*args)
            h //= stride


@pytest.mark.parametrize("n,h,cin,e,cout,stride,residual", [
    (2, 112, 16, 96, 24, 2, False),   # b01
    (2, 28, 32, 192, 32, 1, True),    # b04
    (1, 7, 160, 960, 320, 1, False),  # b16 at batch 1
])
def test_inverted_residual_i8_relu6_bound(dev, n, h, cin, e, cout, stride, residual):
    """A recalibrated six_q below 127 (100.37) on the expansion and the
    depthwise: the tile's ReLU6 bound clips there, equal to the plain
    version bit for bit, given the weight forms as the V2 route gives them
    (`wt`); without them the wrapper raises on the card."""
    rng = np.random.default_rng(cin + e + 3)
    args = list(_i8_ir(rng, dev, n, h, cin, e, cout)) + [stride, residual]
    args[4] = args[8] = 100.37
    ref = inverted_residual_i8_plain(*args)
    _equal_i8(inverted_residual_i8(*args, wt=_forms(args)), ref)
    with pytest.raises(ValueError, match="wt"):
        inverted_residual_i8(*args)
    z = qops.pointwise_i8(*args[:5])
    assert int(z.max()) == 100
    args[4] = args[8] = 127.0
    assert not torch.equal(inverted_residual_i8_plain(*args), ref)


@pytest.mark.parametrize("n,h,cin,cout,stride", [(2, 112, 32, 16, 1), (3, 10, 8, 24, 2),
                                                 (1, 9, 40, 136, 1)])
def test_separable_block_i8_linear(dev, n, h, cin, cout, stride):
    """The linear mode (V2 block 0 at 1.0-224 first): no ReLU, negative
    outputs survive; the ReLU6 mode of the same operands differs."""
    rng = np.random.default_rng(cin + cout)
    args = _i8_block(rng, dev, n, h, cin, cout) + (stride, 127.0, 0.0, True)
    ref = separable_block_i8_plain(*args, pw_linear=True)
    _equal_i8(separable_block_i8(*args, pw_linear=True), ref)
    assert (ref < 0).any()
    assert not torch.equal(ref, separable_block_i8(*args))


def test_v2_int8_routes_verify_and_server(dev):
    """V2 0.35-96: the int8 kernel route's logits equal the plain route's
    bit for bit at batch 1 and 4; the per-layer gate is exact; a V2 int8
    server (build_server) answers with 0 errors through both kernels."""
    import asyncio

    cfg = V2Config(0.35, 96)
    pipe = Int8PipelineV2(cfg, device="cuda")
    rng = np.random.default_rng(0)
    for batch in (1, 4):
        imgs = torch.from_numpy(rng.integers(0, 256, (batch, 96, 96, 3), dtype=np.uint8))
        x_q = qops.quantize_input_dev(prep.preprocess(imgs.to(dev), 96), ACT_IN_SCALE)
        with torch.inference_mode():
            got = forward_v2_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            ref = forward_v2_i8(pipe.dev, x_q, cfg, dw_backend="plain")
        assert torch.equal(got, ref)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    folded = fold_bn_v2(init_params_v2(cfg, seed=1), eps=cfg.bn_eps)
    assert verify_int8_v2(cfg, folded, x, n_calib=8, device="cuda")

    async def serve():
        server, _ = build_server({cfg.variant_name(): cfg}, 8, device="cuda", int8=True)
        await server.start()
        try:
            return await selftest(server, streams=8, requests_per_stream=2)
        finally:
            await server.close()

    before = (inverted_residual_i8.launches, separable_block_i8.launches, v3_block_i8.launches)
    stats = asyncio.run(serve())
    assert stats["errors"] == 0
    assert inverted_residual_i8.launches > before[0] and separable_block_i8.launches > before[1]
    assert v3_block_i8.launches == before[2]  # V2's blocks count on their own wrapper


# -- MobileNet-V3 ------------------------------------------------------------


def _v3_args(rng, dev, dtype, n, h, cin, e, cout, k, se, identity=False):
    """v3_block operands; SE biases non-zero (the seeded weights have none)."""
    kw = {"x": _t(rng, (n, h, h, cin), dtype, dev, 0.7),
          "exp_w": None if identity else _t(rng, (cin, e), dtype, dev, cin ** -0.5),
          "exp_b": None if identity else _t(rng, (e,), dtype, dev, 0.2),
          "dw_w": _t(rng, (k, k, 1, e), dtype, dev, 0.25), "dw_b": _t(rng, (e,), dtype, dev, 0.2),
          "prj_w": _t(rng, (e, cout), dtype, dev, e ** -0.5),
          "prj_b": _t(rng, (cout,), dtype, dev, 0.2)}
    if se:
        kw.update(se_w1=_t(rng, (e, se), dtype, dev, e ** -0.5),
                  se_b1=_t(rng, (se,), dtype, dev, 0.3),
                  se_w2=_t(rng, (se, e), dtype, dev, se ** -0.5),
                  se_b2=_t(rng, (e,), dtype, dev, 0.3))
    return kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 16, 16, 16, 16, 3, 1, 0, "relu", True, True),          # V3-L b00: identity, residual
    (3, 10, 16, 64, 24, 3, 2, 0, "relu", False, False),        # b01 widths, ragged tiles
    (2, 12, 24, 72, 40, 5, 2, 24, "relu", False, False),       # b03: k5 s2 SE, E tail chunk
    (2, 9, 40, 120, 40, 5, 1, 32, "relu", True, False),        # b04: SE, residual, odd side
    (1, 14, 80, 200, 80, 3, 1, 0, "hswish", True, False),      # b07
    (2, 14, 80, 480, 112, 3, 1, 120, "hswish", False, False),  # b10: several tiles + SE
    (2, 14, 112, 672, 160, 5, 2, 168, "hswish", False, False),  # b12
    (3, 7, 160, 960, 160, 5, 1, 240, "hswish", True, False),    # b13: the widest
    (2, 8, 24, 72, 24, 3, 1, 24, "relu6", True, False),         # relu6 with SE
])
def test_v3_block(dev, dtype, n, h, cin, e, cout, k, stride, se, act, residual, identity):
    rng = np.random.default_rng(cin + e + k)
    kw = _v3_args(rng, dev, dtype, n, h, cin, e, cout, k, se, identity)
    kw.update(k=k, stride=stride, act=act, residual=residual)
    before = v3_block.launches
    got = v3_block(**kw)
    assert v3_block.launches == before + 1
    _close(got, v3_block_plain(**kw), dtype)


def test_v3_smem_plan_matches_kernel(dev):
    """The Python mirror of the float32 V3 tile's shared-memory plan equals
    the kernel's own for every V3-Large, -minimalistic and -Small block's
    tile at batch 1, 2 and 256."""
    lib = _build.library()
    for variant, mini in (("large", False), ("large", True), ("small", False)):
        h = 112
        for bd in V3Config(variant, 1.0, 224, minimalistic=mini).block_defs:
            for n in (1, 2, 256):
                ident = not bd.has_expand
                p = v3_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                            bd.se_mid, ident)
                args = (p.th, p.tw, h, h, bd.cin, bd.cexp, bd.cout, bd.se_mid, bd.kernel,
                        bd.stride, p.ws, p.bs, int(ident))
                assert lib.v3_f32_smem_bytes(*args) == v3_smem_bytes(*args)
            h //= bd.stride


def _f32_block_shapes():
    """(name, h, cin, e, cout, k, stride, se, act, residual, identity) of
    every distinct V2 (blocks 1-16), V3-Large and V3-Small 1.0-224 block."""
    out, seen = [], set()
    h = 112
    for i, (t, cin, cout, stride) in enumerate(V2Config(1.0, 224).block_defs):
        key = ("v2", h, t, cin, cout, stride)
        if t > 1 and key not in seen:
            seen.add(key)
            out.append((f"v2b{i:02d}", h, cin, t * cin, cout, 3, stride, 0, "relu6",
                        stride == 1 and cin == cout, False))
        h = -(-h // stride)
    for tag, variant in (("v3l", "large"), ("v3s", "small")):
        h = 112
        for i, bd in enumerate(V3Config(variant, 1.0, 224).block_defs):
            key = (tag, h, bd)
            if key not in seen:
                seen.add(key)
                out.append((f"{tag}b{i:02d}", h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                            bd.se_mid, bd.act, bd.has_res, not bd.has_expand))
            h = -(-h // bd.stride)
    return out


@pytest.mark.parametrize("batch", [1, 2, 256])
def test_v3_block_f32_every_shape(dev, batch):
    """The float32 tile (csrc/v3_f32.cuh) against its plain version at every
    distinct V2, V3-Large and V3-Small 1.0-224 block shape (non-zero SE
    biases), within the float32 gate."""
    for name, h, cin, e, cout, k, stride, se, act, residual, ident in _f32_block_shapes():
        rng = np.random.default_rng(cin + e + k + batch)
        kw = _v3_args(rng, dev, torch.float32, batch, h, cin, e, cout, k, se, ident)
        kw.update(k=k, stride=stride, act=act, residual=residual)
        _close(v3_block(**kw), v3_block_plain(**kw), torch.float32)
        del kw
        torch.cuda.empty_cache()


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 13, 24, 72, 24, 3, 1, 0, "relu", True, False),       # Cin 24, odd side at stride 1
    (2, 14, 40, 120, 48, 5, 2, 32, "hswish", False, False),  # Cin 40, k 5 at stride 2 with SE
    (1, 9, 16, 40, 16, 5, 1, 8, "relu6", True, False),       # Cin 16, E not a multiple of 32
    (2, 11, 24, 24, 24, 3, 1, 0, "relu", True, True),        # the identity, the residual
    (3, 15, 40, 200, 40, 3, 1, 16, "hswish", True, False),   # odd side, SE, residual, E tail
    (1, 300, 16, 96, 24, 3, 2, 0, "relu6", False, False),    # a wide image
])
def test_v3_block_f32_edges(dev, n, h, cin, e, cout, k, stride, se, act, residual, identity):
    rng = np.random.default_rng(cin + e + k + h)
    kw = _v3_args(rng, dev, torch.float32, n, h, cin, e, cout, k, se, identity)
    kw.update(k=k, stride=stride, act=act, residual=residual)
    _close(v3_block(**kw), v3_block_plain(**kw), torch.float32)


def test_v3_wgmma_smem_mirror(dev):
    """The bf16 tile's shared-memory arithmetic (csrc/v3_wgmma.cuh make_geo)
    equals its Python mirror, v3_wgmma_smem_bytes, on the plan of every
    V3-Large, -minimalistic and -Small 1.0-224 block at batch 256 and 1."""
    lib = _build.library()
    for variant, mini in (("large", False), ("large", True), ("small", False)):
        h = 112
        for bd in V3Config(variant, 1.0, 224, minimalistic=mini).block_defs:
            for n in (256, 1):
                p = v3_wgmma_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                  bd.se_mid, not bd.has_expand)
                args = (p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, p.cw, p.ws,
                        p.bs, int(not bd.has_expand))
                assert lib.v3_wgmma_smem_bytes(*args) == v3_wgmma_smem_bytes(*args)
            h //= bd.stride


@pytest.mark.parametrize("variant", ["large", "small"])
def test_v3_block_batch1(dev, variant):
    """The bf16 kernel at every distinct V3-Large and V3-Small 1.0-224 block
    shape at batch 1, where the plans split Cout into parts and take small
    tiles, against its plain version."""
    h, seen = 112, set()
    for bd in V3Config(variant, 1.0, 224).block_defs:
        if (h, bd) not in seen:
            seen.add((h, bd))
            rng = np.random.default_rng(h + bd.cexp)
            kw = _v3_args(rng, dev, torch.bfloat16, 1, h, bd.cin, bd.cexp, bd.cout, bd.kernel,
                          bd.se_mid, not bd.has_expand)
            kw.update(k=bd.kernel, stride=bd.stride, act=bd.act, residual=bd.has_res)
            _close(v3_block(**kw), v3_block_plain(**kw), torch.bfloat16)
        h //= bd.stride


@pytest.mark.parametrize("batch", [256, 1])
def test_v3_block_minimalistic(dev, batch):
    """The bf16 kernel at every distinct V3-Large-minimalistic 1.0-224 block
    shape (k 3, relu, no SE) against its plain version."""
    h, seen = 112, set()
    for bd in V3Config("large", 1.0, 224, minimalistic=True).block_defs:
        if (h, bd) not in seen:
            seen.add((h, bd))
            rng = np.random.default_rng(h + bd.cexp + batch)
            kw = _v3_args(rng, dev, torch.bfloat16, batch, h, bd.cin, bd.cexp, bd.cout,
                          bd.kernel, bd.se_mid, not bd.has_expand)
            kw.update(k=bd.kernel, stride=bd.stride, act=bd.act, residual=bd.has_res)
            _close(v3_block(**kw), v3_block_plain(**kw), torch.bfloat16)
            del kw
            torch.cuda.empty_cache()
        h //= bd.stride


@pytest.mark.parametrize("mini,batch", [(False, 1), (False, 4), (True, 2)])
def test_v3_pipeline_routes_agree(dev, mini, batch):
    """V3-Large 1.0-96: the float32 kernel route against the float32 plain
    route at golden.V3_TOL; the bf16 kernel route against the bf16 plain
    route at the JAX package's V2/V3 routing gate (chip_smoke.py
    check_routes(anchored=True)); the kernel launched once per block."""
    x = np.random.default_rng(batch).uniform(-1, 1, (batch, 96, 96, 3)).astype(np.float32)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cfg = V3Config("large", 1.0, 96, minimalistic=mini, compute_dtype=dtype)
        pipe = InferencePipeline(cfg, device="cuda")
        xd = torch.from_numpy(x).to(dev, pipe.dtype)
        before = v3_block.launches
        with torch.inference_mode():
            logits[dtype] = [mobilenet_v3.forward_v3(pipe.params, xd, cfg, dw_backend=r).float()
                             for r in ("auto", "plain")]
        assert v3_block.launches == before + len(cfg.block_defs)
    (got32, ref32), (got, ref) = logits["float32"], logits["bfloat16"]
    torch.testing.assert_close(got32, ref32, atol=3e-3, rtol=1e-3)
    rms = lambda t: float(t.pow(2).mean().sqrt())  # noqa: E731
    atol = max(6e-2, 4.5e-2 * float(ref.abs().max()),
               1.5 * rms(got - ref) * float(np.sqrt(2 * np.log(got.numel()))))
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    assert rms(got - ref32) <= 1.5 * rms(ref - ref32) + 6e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 16, 16, 16, 16, 3, 2, 8, "relu", False, True),        # V3-S b00: identity, s2, SE
    (2, 14, 16, 72, 24, 3, 2, 0, "relu", False, False),       # b01
    (2, 14, 24, 88, 24, 3, 1, 0, "relu", True, False),        # b02 (the JAX se_block_packed)
    (2, 14, 24, 96, 40, 5, 2, 24, "hswish", False, False),    # b03
    (2, 7, 40, 240, 40, 5, 1, 64, "hswish", True, False),     # b04-b05
    (3, 7, 40, 120, 48, 5, 1, 32, "hswish", False, False),    # b06
    (2, 7, 48, 144, 48, 5, 1, 40, "hswish", True, False),     # b07
    (2, 8, 48, 288, 96, 5, 2, 72, "hswish", False, False),    # b08
    (2, 4, 96, 576, 96, 5, 1, 144, "hswish", True, False),    # b09-b10
])
def test_v3_block_small_shapes(dev, dtype, n, h, cin, e, cout, k, stride, se, act, residual,
                               identity):
    """The V3 kernel at V3-Small's eleven block classes (reduced spatial)."""
    rng = np.random.default_rng(cin + e + k + stride)
    kw = _v3_args(rng, dev, dtype, n, h, cin, e, cout, k, se, identity)
    kw.update(k=k, stride=stride, act=act, residual=residual)
    _close(v3_block(**kw), v3_block_plain(**kw), dtype)


@pytest.mark.parametrize("batch", [1, 4])
def test_v3_small_pipeline_routes_agree(dev, batch):
    """V3-Small 1.0-96: the float32 kernel route against the float32 plain
    route at golden.V3_TOL, the bf16 routes at the anchored routing gate,
    one kernel launch per block; "mixed" runs four plain blocks."""
    x = np.random.default_rng(batch + 10).uniform(-1, 1, (batch, 96, 96, 3)).astype(
        np.float32)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cfg = V3Config("small", 1.0, 96, compute_dtype=dtype)
        pipe = InferencePipeline(cfg, device="cuda")
        xd = torch.from_numpy(x).to(dev, pipe.dtype)
        before = v3_block.launches
        with torch.inference_mode():
            logits[dtype] = [mobilenet_v3.forward_v3(pipe.params, xd, cfg, dw_backend=r).float()
                             for r in ("auto", "plain")]
            assert v3_block.launches == before + 11
            mobilenet_v3.forward_v3(pipe.params, xd, cfg, dw_backend="mixed")
            assert v3_block.launches == before + 11 + 7
    (got32, ref32), (got, ref) = logits["float32"], logits["bfloat16"]
    torch.testing.assert_close(got32, ref32, atol=3e-3, rtol=1e-3)
    rms = lambda t: float(t.pow(2).mean().sqrt())  # noqa: E731
    atol = max(6e-2, 4.5e-2 * float(ref.abs().max()),
               1.5 * rms(got - ref) * float(np.sqrt(2 * np.log(got.numel()))))
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    assert rms(got - ref32) <= 1.5 * rms(ref - ref32) + 6e-2


# (n, h, cin, blocks: (cin, e, cout, k, stride, se, act, residual))
V3_CHAINS = [
    (2, 16, 16, [(16, 64, 24, 3, 2, 0, "relu", False),        # V3-L b01-b04 classes
                 (24, 72, 24, 3, 1, 0, "relu", True),
                 (24, 72, 40, 5, 2, 24, "relu", False),
                 (40, 120, 40, 5, 1, 32, "relu", True)]),
    (1, 14, 80, [(80, 480, 112, 3, 1, 120, "hswish", False),  # b10-b13 classes
                 (112, 672, 112, 3, 1, 168, "hswish", True),
                 (112, 672, 160, 5, 2, 168, "hswish", False),
                 (160, 960, 160, 5, 1, 240, "hswish", True)]),
    (3, 9, 40, [(40, 240, 40, 5, 1, 64, "hswish", True),      # odd side: V3-S b04, b06
                (40, 120, 48, 5, 1, 32, "hswish", False)]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,shapes", V3_CHAINS)
def test_v3_chain(dev, dtype, n, h, cin, shapes):
    """One chain launch, bit-equal to v3_block called per block in sequence
    (the TPU kernel's contract), and within the kernel tolerance of its
    plain version."""
    rng = np.random.default_rng(n * h + cin)
    x = _t(rng, (n, h, h, cin), dtype, dev, 0.7)
    blocks = []
    for ci, e, co, k, stride, se, act, residual in shapes:
        kw = _v3_args(rng, dev, dtype, 1, 1, ci, e, co, k, se)
        del kw["x"]
        blocks.append(dict(kw, k=k, stride=stride, act=act, residual=residual))
    ref = x
    for b in blocks:
        ref = v3_block(ref, **b)
    before = v3_chain.launches
    got = v3_chain(x, blocks)
    assert v3_chain.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    _close(got, v3_chain_plain(x, blocks), dtype)
    assert 0 < v3_chain.grid <= n * h * h
    # a second call, on a new input of the same shape, gives the same (its
    # checks and tables kept); a replaced weight and a weight changed in
    # place are both seen
    assert torch.equal(v3_chain(x.clone(), blocks), ref)
    blocks[-1] = dict(blocks[-1], prj_b=blocks[-1]["prj_b"] + 1)
    blocks[0]["dw_b"].add_(0.5)
    ref = x
    for b in blocks:
        ref = v3_block(ref, **b)
    got = v3_chain(x, blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("variant", ["large", "small"])
def test_v3_chained_route(dev, monkeypatch, variant):
    """1.0-96, batch 2 and 1: with the variant's chain knob on, one chain
    launch a forward (blocks 1 to the last) beside block 0's v3_block, and
    logits equal to the per-block route's bit for bit, in float32 and bf16."""
    knob = "CHAIN_V3_SMALL" if variant == "small" else "CHAIN_V3"
    for dtype in ("float32", "bfloat16"):
        cfg = V3Config(variant, 1.0, 96, compute_dtype=dtype)
        pipe = InferencePipeline(cfg, device="cuda")
        for batch in (2, 1):
            x = torch.from_numpy(np.random.default_rng(batch).uniform(
                -1, 1, (batch, 96, 96, 3)).astype(np.float32)).to(dev, pipe.dtype)
            with torch.inference_mode():
                monkeypatch.setattr(mobilenet_v3, knob, False)
                base = mobilenet_v3.forward_v3(pipe.params, x, cfg, dw_backend="auto")
                monkeypatch.setattr(mobilenet_v3, knob, True)
                counts = (v3_chain.launches, v3_block.launches)
                got = mobilenet_v3.forward_v3(pipe.params, x, cfg, dw_backend="auto")
                torch.cuda.synchronize()
            assert (v3_chain.launches - counts[0], v3_block.launches - counts[1]) == (1, 1)
            assert torch.equal(got, base)


# -- MobileNet-V3 int8 ---------------------------------------------------------


def _v3_i8_layers(rng, dev, cin, e, cout, k, se, identity, prj_gain=1.0):
    """(exp, dw, prj, se1, se2) of one int8 V3 block, quantized from random
    float weights with quant/v3's _quant_named at fixed scales (input 0.05,
    expansion and depthwise 0.06, SE mid 0.03; the projection back at the
    input's scale, / prj_gain): non-zero biases everywhere, SE included; the
    layers hold the kernel's weight forms, made once as at upload."""
    def lay(shape, axis, s_in, s_out, scale, b_scale, **kw):
        w = rng.normal(0, scale, shape).astype(np.float32)
        b = rng.normal(0, b_scale, (shape[axis],)).astype(np.float32)
        return device_layer_v3(_quant_named(w, b, axis, s_in, s_out, **kw), dev)

    s_x, s_e, s_d, s_g = 0.05, 0.06, 0.06, 0.03
    exp = None if identity else lay((cin, e), 1, s_x, s_e, 1.5 * cin ** -0.5, 0.3)
    dw = lay((k, k, 1, e), 3, s_x if identity else s_e, s_d, 0.3, 0.2, k_taps=k * k)
    se1 = lay((e, se), 1, s_d, s_g, e ** -0.5, 0.3) if se else None
    se2 = lay((se, e), 1, s_g, 1.0, se ** -0.5, 0.3) if se else None
    prj = lay((e, cout), 1, s_d, s_x / prj_gain, e ** -0.5, 0.2)
    v3_i8_kernel_weights({"dw": dw, "prj": prj, **({} if identity else {"exp": exp})})
    return exp, dw, prj, se1, se2


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,residual,identity", [
    (2, 16, 16, 16, 16, 3, 1, 0, "relu", True, True),           # V3-L b00: identity, residual
    (3, 10, 16, 64, 24, 3, 2, 0, "relu", False, False),         # b01: expansion at s2, ragged
    (2, 12, 24, 72, 40, 5, 2, 24, "relu", False, False),        # b03: k5 s2 SE, E tail chunk
    (2, 9, 40, 120, 40, 5, 1, 32, "relu", True, False),         # b04: SE, residual, odd side
    (2, 28, 40, 240, 80, 3, 2, 0, "hswish", False, False),      # b06
    (1, 14, 80, 200, 80, 3, 1, 0, "hswish", True, False),       # b07
    (2, 14, 80, 480, 112, 3, 1, 120, "hswish", False, False),   # b10: several tiles + SE
    (2, 14, 112, 672, 160, 5, 2, 168, "hswish", False, False),  # b12
    (3, 7, 160, 960, 160, 5, 1, 240, "hswish", True, False),    # b13: the widest
    (2, 16, 16, 16, 16, 3, 2, 8, "relu", False, True),          # V3-S b00: identity, s2, SE
    (2, 10, 48, 144, 48, 5, 1, 40, "hswish", True, False),      # V3-S b07
])
def test_v3_block_i8(dev, n, h, cin, e, cout, k, stride, se, act, residual, identity):
    rng = np.random.default_rng(cin + e + k + stride)
    exp, dw, prj, se1, se2 = _v3_i8_layers(rng, dev, cin, e, cout, k, se, identity)
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8)).to(dev)
    kw = dict(k=k, stride=stride, act=act, se1=se1, se2=se2, residual=residual)
    before = v3_block_i8.launches
    got = v3_block_i8(x, exp, dw, prj, **kw)
    assert v3_block_i8.launches == before + 1
    ref = v3_block_i8_plain(x, exp, dw, prj, **kw)
    _equal_i8(got, ref)
    assert (ref < 0).any() and (ref > 0).any()


def test_v3_block_i8_saturation(dev):
    """Inputs at the rails and a projection driven past the int8 range: the
    residual saturates at both rails, equal to the plain version."""
    rng = np.random.default_rng(3)
    exp, dw, prj, se1, se2 = _v3_i8_layers(rng, dev, 40, 120, 40, 5, 32, False, prj_gain=8.0)
    x = torch.from_numpy(np.where(rng.random((2, 14, 14, 40)) < 0.5, 120, -120).astype(
        np.int8)).to(dev)
    kw = dict(k=5, stride=1, act="hswish", se1=se1, se2=se2, residual=True)
    ref = v3_block_i8_plain(x, exp, dw, prj, **kw)
    _equal_i8(v3_block_i8(x, exp, dw, prj, **kw), ref)
    assert (ref == 127).any() and (ref == -128).any()


def test_v3_block_i8_kept_launch_follows_its_layers(dev):
    """The launch's checks and arguments are kept per key: a second input of
    the same shape reuses them, a layer given another bias tensor gets new
    ones; each result equals the plain version's. A layer without its
    uploaded weight form raises on the card."""
    rng = np.random.default_rng(23)
    exp, dw, prj, se1, se2 = _v3_i8_layers(rng, dev, 40, 120, 40, 5, 32, False)
    kw = dict(k=5, stride=1, act="hswish", se1=se1, se2=se2, residual=True)

    def x():
        return torch.from_numpy(rng.integers(-128, 128, (2, 14, 14, 40)).astype(
            np.int8)).to(dev)

    for layers in ((exp, dw, prj), (exp, dw, prj), (exp, dw, dict(prj, b=prj["b"] + 3000))):
        xi = x()
        _equal_i8(v3_block_i8(xi, *layers, **kw), v3_block_i8_plain(xi, *layers, **kw))
    with pytest.raises(ValueError, match="v3_i8_kernel_weights"):
        v3_block_i8(x(), exp, {k: v for k, v in dw.items() if k != "wt"}, prj, **kw)


def test_v3_i8_smem_plan_matches_kernel(dev):
    """The Python mirror of the int8 V3 kernel's shared-memory plan
    (`v3_i8_wgmma_smem_bytes`) equals the kernel's own for every pass of
    every V3-Large and -Small block's plan at batch 1 and 256."""
    lib = _build.library()
    for variant in ("large", "small"):
        h = 112
        for bd in V3Config(variant, 1.0, 224).block_defs:
            ident = not bd.has_expand
            for n in (1, 256):
                p = v3_i8_wgmma_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                     bd.se_mid, ident)
                for mode in ((POOL, GATED) if bd.se_mid else (FULL,)):
                    args = (p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, p.cw,
                            p.ws, p.bs, ident, mode)
                    assert lib.v3_i8_wgmma_smem_bytes(*args) == v3_i8_wgmma_smem_bytes(*args)
            h //= bd.stride


def test_v3_int8_routes_verify_and_server(dev):
    """V3-Large 1.0-96: the int8 kernel route's logits equal the plain
    route's bit for bit at batch 1 and 4 (one launch per block); the
    per-layer gate is exact; a V3 int8 server (build_server) answers with
    0 errors through the kernel; V3-Small's int8 pipeline runs its fused
    route (11 launches), equal to its plain route."""
    import asyncio

    cfg = V3Config("large", 1.0, 96)
    pipe = Int8PipelineV3(cfg, device="cuda")
    rng = np.random.default_rng(0)
    for batch in (1, 4):
        imgs = torch.from_numpy(rng.integers(0, 256, (batch, 96, 96, 3), dtype=np.uint8))
        x_q = qops.quantize_input_dev(prep.preprocess(imgs.to(dev), 96), ACT_IN_SCALE)
        before = v3_block_i8.launches
        with torch.inference_mode():
            got = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            assert v3_block_i8.launches == before + 15
            ref = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="plain")
        assert torch.equal(got, ref)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    folded = fold_bn_v3(init_params_v3(cfg, seed=1), eps=cfg.bn_eps)
    assert verify_int8_v3(cfg, folded, x, n_calib=8, device="cuda")

    async def serve():
        server, _ = build_server({cfg.variant_name(): cfg}, 8, device="cuda", int8=True)
        await server.start()
        try:
            return await selftest(server, streams=8, requests_per_stream=2)
        finally:
            await server.close()

    before = v3_block_i8.launches
    stats = asyncio.run(serve())
    assert stats["errors"] == 0 and v3_block_i8.launches > before
    small = V3Config("small", 1.0, 96)
    pipe = Int8PipelineV3(small, device="cuda")
    x_q = qops.quantize_input_dev(prep.preprocess(imgs.to(dev), 96), ACT_IN_SCALE)
    before = v3_block_i8.launches
    with torch.inference_mode():
        got = forward_v3_i8(pipe.dev, x_q, small, dw_backend="auto")
        assert v3_block_i8.launches == before + 11
        assert torch.equal(got, forward_v3_i8(pipe.dev, x_q, small, dw_backend="plain"))


def test_v3_block_i8_small_block0_full_size(dev):
    """V3-Small's int8 block 0 at its network shape (112² x 16 -> 16,
    identity, k 3, stride 2, SE 8, relu; the JAX package's
    packed_block_i8_named_s2_se), batch 2 then 1: equal to the plain
    version, the SE pool buffer zeroed between the calls."""
    rng = np.random.default_rng(19)
    exp, dw, prj, se1, se2 = _v3_i8_layers(rng, dev, 16, 16, 16, 3, 8, True)
    kw = dict(k=3, stride=2, act="relu", se1=se1, se2=se2, residual=False)
    for n in (2, 1, 1):
        x = torch.from_numpy(rng.integers(-128, 128, (n, 112, 112, 16)).astype(np.int8)).to(dev)
        ref = v3_block_i8_plain(x, exp, dw, prj, **kw)
        _equal_i8(v3_block_i8(x, exp, dw, prj, **kw), ref)
        assert ref.shape == (n, 56, 56, 16) and (ref < 0).any() and (ref > 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,c,stride,bias", [
    (2, 112, 32, 1, True),    # V1 block00 at 1.0-224
    (2, 112, 64, 2, True),    # block01
    (3, 7, 1024, 1, True),    # block12
    (1, 7, 32, 2, False),     # odd side at stride 2, no bias
    (2, 10, 24, 1, True),     # 0.75's narrow channels, a partial row tile
    (1, 9, 8, 2, True),       # C = 8, odd side at stride 2
    (2, 13, 40, 1, False),    # C = 40, no bias
    (1, 15, 24, 2, True),     # C = 24, odd side at stride 2
    (2, 300, 16, 1, True),    # a window wider than a TMA box: column tiles
    (256, 14, 512, 2, True),  # block11 at batch 256
])
def test_depthwise(dev, dtype, n, h, c, stride, bias):
    """The standalone depthwise kernel against its plain version: float32
    within the JAX kernel's test tolerance, bf16 within one bf16 step."""
    rng = np.random.default_rng(n + h + c + stride)
    x = _t(rng, (n, h, h, c), dtype, dev, 1.0)
    w = _t(rng, (3, 3, 1, c), dtype, dev, 0.5)
    b = _t(rng, (c,), dtype, dev, 0.2) if bias else None
    for relu6 in (True, False):
        before = depthwise.launches
        got = depthwise(x, w, stride, b, relu6)
        assert depthwise.launches == before + 1 and got.dtype == dtype
        ref = depthwise_plain(x, w, stride, b, relu6)
        torch.cuda.synchronize()
        atol, rtol = (2e-6, 1e-6) if dtype == torch.float32 else (0.0, 2 ** -8)
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def test_cli_verify_v1_on_card(dev, capsys):
    """`cli verify --model v1` (1.0-224, batch 2, the C++ oracle) on the
    card: every tap within the golden gate, no exit."""
    from mobilenet_tpu_torch.cli import main as cli_main

    cli_main(["verify", "--model", "v1"])
    assert "VERIFY OK: all 29 layers match" in capsys.readouterr().out


# -- the stem kernels and the fused-stem route --------------------------------


def _stem_b0_weights(rng, dev, dtype, cout, gain):
    """Stem and block-0 weights; `gain` scales them so that part of every
    ReLU6 saturates."""
    return (_t(rng, (3, 3, 3, 32), dtype, dev, 0.4 * gain), _t(rng, (32,), dtype, dev, 0.2),
            _t(rng, (3, 3, 1, 32), dtype, dev, 0.5 * gain), _t(rng, (32,), dtype, dev, 0.2),
            _t(rng, (32, cout), dtype, dev, gain * 32 ** -0.5), _t(rng, (cout,), dtype, dev, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cout,relu6", [
    (2, 32, 32, 64, True),    # one tile row, two tile columns
    (3, 40, 52, 16, False),   # ragged tiles at both edges, plain ReLU
    (1, 224, 224, 64, True),  # V1 1.0-224 block 0
    (4, 224, 224, 64, True),
    (6, 224, 224, 64, True),    # 420 12x16 tiles on 264 blocks: a partial second wave
    (256, 224, 224, 64, True),  # the fused-stem server's batch
    # float32's route (1.0-160) and plan: units of 5 tiles down a band at
    # batch 256, 320 of them on 264 blocks at batch 64 (a partial wave),
    # 8/4/2-row tiles at batch 2 and 1; Cout 8 and 256, ragged bands
    (256, 160, 160, 64, True), (64, 160, 160, 64, True), (2, 160, 160, 64, True),
    (1, 160, 160, 64, True), (2, 224, 224, 64, True), (1, 64, 64, 8, False),
    (1, 34, 62, 256, True),
])
def test_stem_block0(dev, dtype, n, h, w, cout, relu6):
    """The fused stem kernel against its plain version. The last input row
    and column are 255, so a pad taken as normalize(0) = -1 instead of 0
    would show; the weights drive part of each ReLU6 into its clip."""
    rng = np.random.default_rng(h + w + cout)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img[:, -1] = 255
    img[:, :, -1] = 255
    x = torch.from_numpy(img).to(dev)
    wts = _stem_b0_weights(rng, dev, dtype, cout, 3.0)
    before = stem_block0.launches
    got = stem_block0(x, *wts, relu6)
    assert stem_block0.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, h // 2, w // 2, cout)
    ref = stem_block0_plain(x, *wts, relu6)
    _close(got, ref, dtype)
    if relu6:
        assert 0.01 < float((ref.float() == 6).float().mean()) < 0.99
    else:
        assert float(ref.float().max()) > 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cout,relu6", [
    (2, 32, 32, 32, True), (3, 38, 50, 24, False), (1, 224, 224, 32, True),
    (2, 224, 224, 16, True), (1, 16, 16, 256, True), (2, 37, 45, 32, True),
    (1, 225, 224, 16, False),
    (16, 224, 224, 32, True),   # 448 4x112 tiles on 396 blocks: a partial second wave
    (256, 224, 224, 32, True),  # the float main path's batch
    # the float32 plan's batch 2 tiles, Cout 8 and 256 on odd sides
    (2, 224, 224, 32, True), (1, 33, 17, 8, False), (2, 225, 223, 256, True),
])
def test_stem_conv(dev, dtype, n, h, w, cout, relu6):
    """The stem kernel against its plain version, bit for bit in float32;
    the last row and column of the input are 1 (the largest normalized
    value) beside the pad; odd sides pad (1, 1), as TF-SAME does."""
    rng = np.random.default_rng(h + w + cout)
    x = _t(rng, (n, h, w, 3), dtype, dev, lo=-1)
    x[:, -1] = 1
    x[:, :, -1] = 1
    wt, b = _t(rng, (3, 3, 3, cout), dtype, dev, 1.5), _t(rng, (cout,), dtype, dev, 0.2)
    before = stem_conv.launches
    got = stem_conv(x, wt, b, relu6)
    assert stem_conv.launches == before + 1 and got.dtype == dtype
    assert got.shape == (n, -(-h // 2), -(-w // 2), cout)
    ref = stem_conv_plain(x, wt, b, relu6)
    _close(got, ref, dtype)
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    if relu6:
        assert 0 < float((ref.float() == 6).float().mean()) < 1


@pytest.mark.parametrize("n,h,w,cout,relu6", [
    (256, 160, 160, 32, True), (64, 160, 160, 32, True), (2, 160, 160, 32, False),
    (1, 160, 160, 32, True), (2, 224, 224, 32, True), (3, 40, 52, 32, False),
])
def test_stem_block0_f32_stem_and_depthwise_exact(dev, n, h, w, cout, relu6):
    """float32 stem_block0 with an identity pointwise (and a zero bias) is
    its depthwise output, and so bit-equal to the plain version's: the stem
    and the depthwise are exact, whatever the float32 plan."""
    rng = np.random.default_rng(h + w + n)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img[:, -1] = 255
    img[:, :, -1] = 255
    x = torch.from_numpy(img).to(dev)
    wts = _stem_b0_weights(rng, dev, torch.float32, cout, 3.0)[:4] + (
        torch.eye(32, device=dev), torch.zeros(32, device=dev))
    got = stem_block0(x, *wts, relu6)
    ref = stem_block0_plain(x, *wts, relu6)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert 0.01 < float((ref > 0).float().mean()) < 0.99


def test_stem_smem_bytes(dev):
    """The kernels' shared-memory arithmetic equals stem_smem_bytes (bf16)
    and f32_stem_smem_bytes (float32) at the plans of the card tests'
    shapes."""
    lib = _build.library()
    for n, h, w, cout, block0 in ((256, 224, 224, 64, True), (1, 224, 224, 64, True),
                                  (1, 224, 224, 512, True), (256, 224, 224, 32, False),
                                  (1, 225, 224, 16, False), (1, 16, 16, 256, False),
                                  (2, 37, 45, 32, False), (1, 640, 480, 256, False)):
        p = stem_plan(n, h, w, cout, block0)
        assert lib.stem_smem_bytes(int(block0), p.th, p.tw, cout) == \
            stem_smem_bytes(block0, p.th, p.tw, cout) == p.smem
    # the float32 kernels' (csrc/stem_f32.cuh) at their plans
    for n, h, w, cout, block0 in ((256, 160, 160, 64, True), (1, 160, 160, 64, True),
                                  (2, 224, 224, 64, True), (1, 224, 224, 1024, True),
                                  (1, 34, 62, 256, True), (256, 224, 224, 32, False),
                                  (1, 225, 224, 16, False), (1, 16, 16, 256, False),
                                  (2, 37, 45, 32, False), (1, 640, 480, 256, False)):
        p = f32_stem_plan(n, h, w, cout, block0)
        assert lib.stem_f32_smem_bytes(int(block0), p.th, p.tw, cout) == \
            f32_stem_smem_bytes(block0, p.th, p.tw, cout) == p.smem


def _reset(*kernels):
    for k in kernels:
        k.launches = 0


def test_fused_stem_pipeline_launches(dev):
    """bf16 1.0-224 with fuse_stem=True: one stem_block0 launch per forward,
    separable_block on blocks 1-12 (12 at batch 4; 7 at batch 1, where the
    chain takes blocks 6-10), and logits within the routing gate of the
    plain route."""
    cfg = ModelConfig(1.0, 224, compute_dtype="bfloat16")
    pipe = InferencePipeline(cfg, device="cuda", fuse_stem=True)
    rng = np.random.default_rng(1)
    for batch, n_sep, n_chain in ((4, 12, 0), (1, 7, 1)):
        imgs = torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8)).to(dev)
        _reset(stem_block0, stem_conv, separable_block, chain)
        with torch.inference_mode():
            got = mobilenet_v1.forward_u8(pipe.params, imgs, cfg, dtype=torch.bfloat16,
                                          dw_backend="auto", fuse_stem=True).float()
            torch.cuda.synchronize()
            counts = (stem_block0.launches, stem_conv.launches, separable_block.launches,
                      chain.launches)
            ref = mobilenet_v1.forward(pipe.params, prep.preprocess(imgs, 224, torch.bfloat16),
                                       cfg, dw_backend="plain").float()
        assert counts == (1, 0, n_sep, n_chain)
        atol = max(6e-2, 4.5e-2 * float(ref.abs().max()))
        torch.testing.assert_close(got, ref, atol=atol, rtol=0)
        _reset(stem_block0)
        pipe.run_batch(imgs.cpu().numpy())
        assert stem_block0.launches == 1


@pytest.mark.parametrize("res,fuses", [(160, True), (224, False)])
def test_fused_stem_float32(dev, res, fuses):
    """float32: at 1.0-160 the fused stem matches the default pipeline
    within 1e-4/1e-3; at 1.0-224 the gate refuses (as the JAX package's
    does) and the default route runs, its stem on stem_conv."""
    cfg = ModelConfig(1.0, res, compute_dtype="float32")
    base = InferencePipeline(cfg, device="cuda", seed=4)
    fused = InferencePipeline(cfg, device="cuda", seed=4, fuse_stem=True)
    imgs = np.random.default_rng(res).integers(0, 256, (2, res, res, 3), np.uint8)
    _reset(stem_block0, stem_conv)
    got = fused.run_batch(imgs)
    torch.cuda.synchronize()
    assert (stem_block0.launches, stem_conv.launches) == ((1, 0) if fuses else (0, 1))
    ref = base.run_batch(imgs)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)


# -- the float32 separable tile (csrc/separable_f32.cuh) ---------------------------


def _v1_f32_shapes():
    """(h, cin, cout, stride, pw_act) of V1 1.0-224's distinct block shapes
    and V2 1.0-224's linear block 0."""
    cfg = ModelConfig(1.0, 224)
    out, h, cin = [], 112, cfg.stem_channels
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        if (h, cin, cout, stride, True) not in out:
            out.append((h, cin, cout, stride, True))
        h, cin = -(-h // stride), cout
    return out + [(112, 32, 16, 1, False)]


def _f32_block(rng, dev, n, h, cin, cout, w=None):
    return (_t(rng, (n, h, w or h, cin), torch.float32, dev, lo=-1),
            _t(rng, (3, 3, 1, cin), torch.float32, dev, 0.5),
            _t(rng, (cin,), torch.float32, dev, 0.2),
            _t(rng, (cin, cout), torch.float32, dev, cin ** -0.5),
            _t(rng, (cout,), torch.float32, dev, 0.2))


@pytest.mark.parametrize("batch", [1, 2, 256])
def test_separable_block_f32_every_shape(dev, batch):
    """The float32 tile against its plain version at every V1 1.0-224 block
    shape and V2 b00 (linear), within the float32 gate; one launch a call."""
    for h, cin, cout, stride, act in _v1_f32_shapes():
        rng = np.random.default_rng(cin + cout + batch)
        args = _f32_block(rng, dev, batch, h, cin, cout) + (stride, True)
        before = separable_block.launches
        got = separable_block(*args, pw_act=act)
        assert separable_block.launches == before + 1
        _close(got, separable_block_plain(*args, pw_act=act), torch.float32)
        del args, got
        torch.cuda.empty_cache()


@pytest.mark.parametrize("n,h,w,cin,cout,stride", [
    (2, 13, 13, 8, 16, 1),     # Cin 8: one chunk of 8 live channels; odd Wo
    (2, 16, 16, 24, 40, 2),    # Cin 24, stride 2 on even sides
    (3, 15, 11, 40, 24, 1),    # Cin 40: a chunk and 8 more channels; odd sides
    (1, 14, 18, 40, 136, 2),   # Cout 136: a slice past 128
    (2, 7, 7, 1048, 64, 1),    # Cin 1048: 32 chunks and 24 more channels
    (1, 300, 300, 16, 24, 2),  # a wide image
])
@pytest.mark.parametrize("pw_act", [True, False])
def test_separable_block_f32_edges(dev, n, h, w, cin, cout, stride, pw_act):
    rng = np.random.default_rng(cin * cout + h)
    args = _f32_block(rng, dev, n, h, cin, cout, w) + (stride, True)
    got = separable_block(*args, pw_act=pw_act)
    _close(got, separable_block_plain(*args, pw_act=pw_act), torch.float32)
    if not pw_act:
        assert (got < 0).any()


def test_separable_f32_smem_mirror(dev):
    """The float32 plan's shared memory (f32_sep_smem_bytes) equals the
    kernel's own at every V1 1.0-224 block shape, V2 b00 and the edge shapes,
    at batch 1, 2 and 256."""
    lib = _build.library()
    for n in (1, 2, 256):
        for h, cin, cout, stride, _ in _v1_f32_shapes() + [(13, 8, 16, 1, 1), (16, 40, 136, 2, 1),
                                                           (7, 1048, 64, 1, 1)]:
            p = f32_sep_plan(n, h, h, cin, cout, stride)
            args = (p.mg, p.th, p.tw, p.kp, p.ns, p.ws, p.bs, stride)
            assert lib.separable_f32_smem_bytes(*args) == f32_sep_smem_bytes(*args)


@pytest.mark.parametrize("n", [1, 2])
def test_chain_f32_equals_blocks(dev, n):
    """The float32 chain (V1 blocks 6-10's shape) equals five per-block
    launches bit for bit, and its plain version within the float32 gate."""
    rng = np.random.default_rng(n + 512)
    args = (_t(rng, (n, 14, 14, 512), torch.float32, dev, lo=-1),
            _t(rng, (5, 3, 3, 512), torch.float32, dev, 0.4),
            _t(rng, (5, 512), torch.float32, dev, 0.2),
            _t(rng, (5, 512, 512), torch.float32, dev, 512 ** -0.5),
            _t(rng, (5, 512), torch.float32, dev, 0.2), True)
    got = chain(*args)
    y = args[0]
    for i in range(5):
        y = separable_block(y, args[1][i].reshape(3, 3, 1, 512).contiguous(), args[2][i],
                            args[3][i], args[4][i], 1, True)
    torch.cuda.synchronize()
    assert torch.equal(got, y)
    _close(got, chain_plain(*args), torch.float32)


# -- the floor probes ------------------------------------------------------------


def test_hbm_copy_flat_equals_input(dev):
    """hbm_copy_flat equals its input at the five audit shapes
    and at 16 bytes, 48 bytes and 4 MiB + 16 bytes; one launch each."""
    tensors = [torch.randn(shape, device=dev).to(torch.bfloat16)
               for _, shape in floors.AUDIT_SHAPES]
    tensors += [torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
                for nbytes in (16, 48, 4 * 2 ** 20 + 16)]
    for x in tensors:
        before = floors.hbm_copy_flat.launches
        got = floors.hbm_copy_flat(x)
        assert floors.hbm_copy_flat.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, x)
        del got
    del tensors
    torch.cuda.empty_cache()


def test_hbm_copy_equals_input(dev):
    """hbm_copy equals its input at the five audit shapes, at one image, at
    16 and 48 bytes an image, at an odd count of 16-byte vectors an image
    and at more images than a grid's y dimension holds; one launch each."""
    tensors = [torch.randn(shape, device=dev).to(torch.bfloat16)
               for _, shape in floors.AUDIT_SHAPES]
    tensors += [torch.randint(-128, 128, shape, dtype=torch.int8, device=dev)
                for shape in ((1, 7, 7, 1024), (5, 16), (7, 48), (3, 5, 7, 16), (65537, 16))]
    for x in tensors:
        before = floors.hbm_copy.launches
        got = floors.hbm_copy(x)
        assert floors.hbm_copy.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, x)
        del got
    del tensors
    torch.cuda.empty_cache()


def test_floor_copies(dev):
    """Both copy probes equal their input, one launch each."""
    for shape in ((3, 7, 7, 1024), (2, 112, 112, 64), (5, 3, 3, 8)):
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        for fn in (floors.hbm_copy, floors.hbm_copy_flat):
            before = fn.launches
            got = fn(x)
            assert fn.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, x)


@pytest.mark.parametrize("variant", floors.VARIANTS)
def test_floor_stencil(dev, variant):
    """The stencil probe against its plain version (`floors.check_stencil`):
    bf16 (every step rounded on both sides) bit for bit; the float32
    variants within one bf16 step of the output (2^-7 relative, no absolute
    term), since the kernel contracts each product and sum into one FMA
    where the plain version rounds twice. At 2 and 8 rounds the output must
    still depend on x (64 rounds: the weights set it); one launch a call.
    Then the plan's edges: odd C (bf16 pairs across pixels, an odd element
    count), C = 1 and 3, C = 1024 at an odd pixel count, fewer elements
    than a wave's threads, and 8 x 56^2 x 128 (several passes a thread),
    at 0, 1 and 19 rounds (19 a multiple of no unroll)."""
    for reps in (2, 8, 64):
        before = floors.stencil.launches
        floors.check_stencil(variant, 2, 14, 14, 64, reps, dev)  # raises on a disagreement
        assert floors.stencil.launches == before + 1
    for shape in ((1, 7, 9, 17), (3, 5, 7, 1), (2, 9, 11, 3), (1, 7, 7, 1024),
                  (8, 56, 56, 128)):
        for reps in (0, 1, 19):
            before = floors.stencil.launches
            floors.check_stencil(variant, *shape, reps, dev)
            assert floors.stencil.launches == before + 1


def test_stencil_refuses_a_plan_that_misses(dev):
    """The kernel's entry refuses a plan that would leave elements
    uncomputed or mix channels in a thread; the occupancy query gives at
    least one block an SM for every variant and chain count."""
    lib = _build.library()
    x = torch.ones((1, 4, 4, 16), dtype=torch.bfloat16, device=dev)
    w = torch.ones((3, 3, 16), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel(), 16, 2, 0)
    assert lib.stencil(*args, 1, 1, 256, 1, stream) == 0
    for plan in ((1, 1, 128, 1),   # 128 units of 256
                 (1, 1, 264, 2),   # stride not a multiple of C
                 (5, 1, 256, 1),   # no kernel with 5 chains
                 (1, 1, 256, 0)):  # no block
        assert lib.stencil(*args, *plan, stream) != 0, plan
    torch.cuda.synchronize()
    for v in range(len(floors.VARIANTS)):
        for n in floors.STENCIL_CHAINS:
            assert lib.stencil_blocks_per_sm(v, n) >= 1
