"""The port's MobileNet-V3 bottleneck kernel (its plain version, which the
wrapper runs on CPU tensors) against the JAX package's `v3_block_pallas` in
interpret mode, at the shape classes of the JAX package's own kernel tests
(tests/test_pallas_ir_v3.py): k 3 and 5 at both strides, the squeeze-excite
gate with non-zero SE biases, relu / hswish / relu6, the identity expansion,
the residual and expanded widths that end in a partial 32-channel chunk;
and against `se_block_packed` (interpret mode), the lane-packed stride-1
bottleneck the JAX package runs V3-Small's blocks 2 and 4-7 on, which the
port's kernel takes too. Also the tile plan (`v3_plan`), which is the
kernel's fits-function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_tpu.ops.pallas_block_packed import pack
from mobilenet_tpu.ops.pallas_ir_v3 import v3_block_pallas
from mobilenet_tpu.ops.pallas_se_packed import se_block_packed, se_packed_geometry
from mobilenet_tpu.utils import golden
from mobilenet_tpu_torch import V3Config
from mobilenet_tpu_torch.ops.v3_block import (
    MAX_FRAGS, MAX_OUTPUTS_V3, SMEM_MAX, v3_block, v3_block_plain, v3_plan, v3_smem_bytes,
)

# float32: the JAX kernel tests' own tolerance (tests/test_pallas_ir_v3.py:83).
F32_TOL = dict(atol=3e-5, rtol=1e-5)
# bfloat16: the port's kernel tolerance (tests/test_torch_ir_block.py): a
# last-bit difference in an f32 sum moves a bf16 rounding by one step.
BF16_TOL = dict(atol=6e-2, rtol=1.6e-2)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _make(seed, n, h, cin, e, cout, k, se_mid, identity=False):
    """The JAX kernel tests' operands (`_make`), SE biases non-zero."""
    rng = np.random.default_rng(seed)

    def r(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrs = {"x": r((n, h, h, cin), 0.5), "exp_w": r((cin, e), cin ** -0.5),
            "exp_b": r((e,), 0.1), "dw_w": r((k, k, 1, e), 0.2), "dw_b": r((e,), 0.1),
            "prj_w": r((e, cout), e ** -0.5), "prj_b": r((cout,), 0.1)}
    if identity:
        arrs["exp_w"] = arrs["exp_b"] = None
    if se_mid:
        arrs.update(se_w1=r((e, se_mid), e ** -0.5), se_b1=r((se_mid,), 0.1),
                    se_w2=r((se_mid, e), se_mid ** -0.5), se_b2=r((e,), 0.1))
    return arrs


def _run(arrs, dtype, **kw):
    jdt, tdt = _DT[dtype]
    jx = {a: None if v is None else jnp.asarray(v, jdt) for a, v in arrs.items()}
    want = v3_block_pallas(jx.pop("x"), jx.pop("exp_w"), jx.pop("exp_b"), jx.pop("dw_w"),
                           jx.pop("dw_b"), jx.pop("prj_w"), jx.pop("prj_b"), interpret=True,
                           **jx, **kw)
    tx = {a: None if v is None else torch.from_numpy(v).to(tdt) for a, v in arrs.items()}
    got = v3_block(**tx, **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se_mid,act,residual", [
    (2, 14, 64, 384, 64, 3, 1, 0, "relu", True),
    (2, 28, 24, 72, 40, 5, 2, 24, "relu", False),        # V3-L b03 class; E 72: a tail chunk
    (2, 14, 40, 120, 40, 5, 1, 32, "relu", True),        # V3-L b04: SE + residual
    (2, 14, 112, 672, 160, 5, 2, 168, "hswish", False),  # V3-L b12
    (2, 8, 160, 960, 160, 5, 1, 240, "hswish", True),    # V3-L b13 class
    (2, 14, 80, 184, 80, 3, 1, 0, "hswish", True),       # V3-L b08
    (2, 9, 48, 144, 48, 5, 1, 40, "hswish", True),       # odd spatial at stride 1
    (2, 16, 16, 64, 24, 3, 2, 0, "relu", False),         # V3-L b01 class (k 3 s2)
    (1, 10, 24, 72, 24, 3, 1, 24, "relu6", True),        # relu6, SE at k 3
])
def test_vs_pallas(dtype, n, h, cin, e, cout, k, stride, se_mid, act, residual):
    arrs = _make(n * h + cin + e, n, h, cin, e, cout, k, se_mid)
    got, want = _run(arrs, dtype, k=k, stride=stride, act=act, residual=residual)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_expand_no_activation(dtype):
    """V3-Large block 0: no expansion conv. The identity must not activate
    (the stem's hswish output is negative in places)."""
    arrs = _make(11, 2, 16, 16, 16, 16, 3, 0, identity=True)
    arrs["x"] = (arrs["x"] * 2).astype(np.float32)
    assert (arrs["x"] < 0).any()
    got, want = _run(arrs, dtype, k=3, stride=1, act="relu", residual=True)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_se_biases_and_gate_reach_the_output():
    """Seeded weights carry zero SE biases; the block's b1 and b2 and the
    gate itself must each move the output."""
    arrs = _make(5, 2, 8, 24, 72, 40, 5, 24)
    t = {a: torch.from_numpy(v) for a, v in arrs.items()}
    kw = dict(k=5, stride=1, act="relu")
    with_b = v3_block_plain(**t, **kw)
    t0 = dict(t, se_b1=torch.zeros_like(t["se_b1"]), se_b2=torch.zeros_like(t["se_b2"]))
    assert not torch.allclose(with_b, v3_block_plain(**t0, **kw), atol=1e-3)
    no_se = {a: v for a, v in t.items() if not a.startswith("se_")}
    assert not torch.allclose(with_b, v3_block_plain(**no_se, **kw), atol=1e-3)


@pytest.mark.parametrize("variant,mini", [("large", False), ("large", True)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_v3_block_has_a_tile(variant, mini, itemsize):
    """Every V3-Large (and -minimalistic) block at 1.0-224 has a tile at
    batch 1 and 256 within the shared-memory limit, the output cap and the
    projection accumulators; the batch-1 tiles are no larger than the
    batch-256 ones."""
    cfg = V3Config(variant, 1.0, 224, minimalistic=mini)
    h = 112
    for bd in cfg.block_defs:
        plans = [v3_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid,
                         itemsize) for n in (1, 256)]
        for th, tw in plans:
            assert v3_smem_bytes(th, tw, bd.cin, bd.cexp, bd.cout, bd.se_mid, bd.kernel,
                                 bd.stride, itemsize) <= SMEM_MAX
            assert th * tw <= MAX_OUTPUTS_V3
            assert -(-th * tw // 16) * -(-bd.cout // 16) <= MAX_FRAGS
        assert plans[0][0] * plans[0][1] <= plans[1][0] * plans[1][1]
        h //= bd.stride


def test_smem_grows_with_k_and_se():
    base = v3_smem_bytes(7, 7, 160, 960, 160, 0, 3, 1, 2)
    assert v3_smem_bytes(7, 7, 160, 960, 160, 0, 5, 1, 2) > base
    assert v3_smem_bytes(7, 7, 160, 960, 160, 240, 3, 1, 2) == base + 3840 + 1024
    assert v3_plan(1, 6, 5, 16, 64, 16, 3, 2, 0, 2) is None  # odd input at stride 2
    assert v3_plan(1, 8, 8, 16, 64, 16, 7, 1, 0, 2) is None  # no k 7


def test_wrapper_rejects_what_no_kernel_takes():
    arrs = _make(1, 1, 8, 16, 64, 16, 3, 16)
    t = {a: torch.from_numpy(v) for a, v in arrs.items()}
    with pytest.raises(ValueError):
        v3_block(**t, k=3, stride=2, act="relu", residual=True)  # residual at stride 2
    with pytest.raises(ValueError):
        v3_block(**dict(t, se_b2=None), k=3, stride=1, act="relu")  # SE half given
    with pytest.raises(ValueError):
        v3_block(**t, k=5, stride=1, act="relu")  # 3x3 weights at k 5
    with pytest.raises(ValueError):
        v3_block(**t, k=3, stride=1, act="hsigmoid")
    with pytest.raises(ValueError):
        v3_block(**dict(t, x=t["x"][:, :7].contiguous()), k=3, stride=2, act="relu")  # odd, s2


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.mark.parametrize("n,h,cin,e,cout,k,se_mid,act,residual", [
    (2, 8, 24, 88, 24, 3, 0, "relu", True),        # V3-S b02 (28² x 24 in the network)
    (2, 6, 40, 240, 40, 5, 64, "hswish", True),    # b04 and b05 (14² x 40)
    (2, 6, 40, 120, 48, 5, 32, "hswish", False),   # b06
    (1, 6, 48, 144, 48, 5, 40, "hswish", True),    # b07
])
def test_vs_se_block_packed(n, h, cin, e, cout, k, se_mid, act, residual):
    """The port's V3 kernel against the JAX package's lane-packed SE block
    at V3-Small's B15 shapes (stride 1, small spatial), on the same inputs
    with non-zero SE biases: float32 within 1e-4; bf16 at the anchored
    routing gate (golden.routing_bf16_atol, and the port no farther in RMS
    from the float32 block than 1.5x the JAX kernel + 6e-2): the two round
    at different places (the JAX kernel keeps the expansion in float32 and
    adds the residual before its one rounding)."""
    arrs = _make(n * h + cin + e, n, h, cin, e, cout, k, se_mid)
    cp, _, cout_p, _ = se_packed_geometry(cin, e, cout, h, k, 1)
    ref32 = v3_block_plain(**{a: torch.from_numpy(v) for a, v in arrs.items()}, k=k, stride=1,
                           act=act, residual=residual).numpy()
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = _DT[dtype]
        jx = {a: jnp.asarray(v, jdt) for a, v in arrs.items()}
        xin = jnp.pad(jx["x"], ((0, 0), (0, 0), (0, 0), (0, cp - cin)))
        ew = jnp.pad(jx["exp_w"], ((0, cp - cin), (0, 0)))
        se = ((jx["se_w1"], jx["se_b1"], jx["se_w2"], jx["se_b2"]) if se_mid
              else (None,) * 4)
        out = se_block_packed(pack(xin, cp), ew, jx["exp_b"], jx["dw_w"], jx["dw_b"], *se,
                              jx["prj_w"], jx["prj_b"], cp, k, act, residual, se_mid,
                              interpret=True)
        want = np.asarray(out.reshape(n, h, h, cout_p)[..., :cout], np.float32)
        got = v3_block(**{a: torch.from_numpy(v).to(tdt) for a, v in arrs.items()}, k=k,
                       stride=1, act=act, residual=residual).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
            continue
        atol = golden.routing_bf16_atol(float(np.abs(want).max()), _rms(got - want), got.size)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        assert _rms(got - ref32) <= golden.ROUTING_ANCHOR_FACTOR * _rms(want - ref32) + \
            golden.ROUTING_BF16_ATOL
