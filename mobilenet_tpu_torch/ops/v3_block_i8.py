"""Fused int8 MobileNet-V3 bottleneck: the CUDA kernel `csrc/v3_block_i8.cu`
and its plain PyTorch version.

Replaces the TPU kernels `mobilenet_tpu/quant/pallas_ir_v3_i8.py`
`v3_block_pallas_i8` (V3 blocks with an expansion: hswish, k 5, the
quantized squeeze-excite), `quant/pallas_block_packed_i8.py`
`packed_block_i8_named` (block 0: the identity expansion at stride 1) and
`packed_block_i8_named_s2` (block 1, whose expansion the JAX package runs
as XLA ops before it). Exact: equal, bit for bit, to the plain version and
to `quant/v3.py`'s oracle. What bounds it on the card and what the design
does about it is in the CUDA source's header. A layer is a dict of device
tensors (`quant/v3.device_layer_v3`): "w" int8, "b" int32, "a" and "m"
float32 per output channel, and the float32 value "m6". `v3_i8_plan` picks
the output tile and is the fits-function: a shape with no plan raises at
the call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..quant import ops as qops
from . import _build
from .depthwise_i8 import check_i8_args
from .head import ACTS
from .inverted_residual import plan_tile
from .inverted_residual_i8 import KE, LDK, LDZ, MAX_OUTPUTS_I8, _rup
from .separable_block import check_channels

NAMED_ACTS = ("relu", "hswish")


def v3_i8_smem_bytes(th: int, tw: int, cin: int, e: int, cout: int, se: int, k: int,
                     stride: int, identity: bool) -> int:
    """Dynamic shared memory of one tile (v3_block_i8.cu make_shape): the
    int8 input window ((TH-1)s+k by (TW-1)s+k pixels), then the chunk
    buffers (expanded window tile, expand slice unless the identity,
    depthwise tile, projection slice, depthwise taps) or the int8 result
    tile, then with SE
    the gate (E) and the hidden row (Se), 4 bytes each."""
    pp = _rup(((th - 1) * stride + k) * ((tw - 1) * stride + k), 16)
    cinp, coutp, tmp = _rup(cin, 32), _rup(cout, 16), _rup(th * tw, 16)
    xs = _rup(pp * (cinp + 16), 128)
    work = (_rup(pp * LDZ, 128) + (0 if identity else _rup(KE * (cinp + 16), 128))
            + _rup(tmp * LDK, 128) + _rup(coutp * LDK, 128) + _rup(k * k * KE, 128))
    gate = _rup(e * 4, 128) + _rup(se * 4, 128) if se else 0
    return xs + max(work, _rup(tmp * (coutp + 16), 128)) + gate


@functools.lru_cache(maxsize=None)
def v3_i8_plan(n: int, h: int, w: int, cin: int, e: int, cout: int, k: int, stride: int,
               se: int, identity: bool) -> Optional[Tuple[int, int]]:
    """The output tile (TH, TW) of a block on (n, h, w, cin) -> cout, or
    None when no tile fits: `ir_plan`'s search and time model
    (ops/inverted_residual.plan_tile) with this kernel's k x k window,
    shared memory and the int8 plan's output cap."""
    if k not in (3, 5):
        return None
    return plan_tile(n, h, w, cin, cout, stride,
                     lambda th, tw: v3_i8_smem_bytes(th, tw, cin, e, cout, se, k, stride,
                                                     identity),
                     max_outputs=MAX_OUTPUTS_I8, k=k)


def v3_block_i8_plain(x, exp, dw, prj, *, k: int, stride: int, act: str, se1=None,
                      se2=None, residual: bool = False) -> torch.Tensor:
    """The plain int8 ops in quant/v3.py's order: the expansion's named
    requant (exp None: the input itself), the k x k depthwise's int32 sum +
    bias and named requant, [the quantized SE], the linear requant of the
    projection, [the saturating residual add]. Integer products through
    float64 (quant/ops._int_matmul), exact."""
    z = x if exp is None else qops.pointwise_i8_named(x, exp, act)
    z = qops.requantize_named(qops.depthwise_acc_i8(z, dw["w"], stride) + dw["b"], dw, act)
    if se1 is not None:
        z = qops.se_i8(z, se1, se2)
    y = qops.pointwise_i8_named(z, prj, "linear")
    return qops.residual_add_i8(y, x) if residual else y


def v3_block_i8(x, exp, dw, prj, *, k: int, stride: int, act: str, se1=None, se2=None,
                residual: bool = False) -> torch.Tensor:
    """One int8 MobileNet-V3 bottleneck, `v3_block_pallas_i8`'s signature.

    x (N,H,W,Cin) int8; exp the expansion layer (w (Cin,E)) or None for
    the identity with no activation (E == Cin); dw the depthwise layer (w
    (k,k,1,E)); prj the projection (w (E,Cout)); se1 (w (E,Se)) and se2 (w
    (Se,E)) the SE layers, both or neither; act relu or hswish ->
    (N,Ho,Wo,Cout) int8. A residual needs stride 1 and Cin == Cout. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel or raises."""
    name = "v3_block_i8"
    identity, has_se = exp is None, se1 is not None
    if (se2 is None) == has_se:
        raise ValueError(f"{name}: give both SE layers or neither")
    layers = ([] if identity else [exp]) + [dw, prj] + ([se1, se2] if has_se else [])
    check_i8_args(name, x, [l["w"] for l in layers], [l["b"] for l in layers],
                  [l[f] for l in layers for f in ("a", "m")])
    n, h, w, cin = x.shape
    e = cin if identity else int(exp["w"].shape[-1])
    cout = int(prj["w"].shape[-1])
    sem = int(se1["w"].shape[-1]) if has_se else 0
    shapes = [(dw["w"], (k, k, 1, e)), (dw["b"], (e,)), (prj["w"], (e, cout)),
              (prj["b"], (cout,))]
    if not identity:
        shapes += [(exp["w"], (cin, e)), (exp["b"], (e,))]
    if has_se:
        shapes += [(se1["w"], (e, sem)), (se1["b"], (sem,)), (se2["w"], (sem, e)),
                   (se2["b"], (e,))]
    shapes += [(l[f], tuple(l["b"].shape)) for l in layers for f in ("a", "m")]
    if any(tuple(t.shape) != want for t, want in shapes):
        raise ValueError(f"{name}: layer shapes do not fit Cin={cin}, E={e}, k={k}")
    if k not in (3, 5) or stride not in (1, 2) or act not in NAMED_ACTS:
        raise ValueError(f"{name}: k={k} stride={stride} act={act!r}: the kernel takes "
                         f"k 3 or 5, stride 1 or 2 and an act in {NAMED_ACTS}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{name}: a residual needs stride 1 and Cin == Cout")
    check_channels(name, cin, e, cout)
    if has_se and sem <= 0:
        raise ValueError(f"{name}: SE width {sem}")
    plan = v3_i8_plan(n, h, w, cin, e, cout, k, stride, sem, identity)
    if plan is None:
        raise ValueError(f"{name}: no tile of the kernel takes ({n},{h},{w},{cin})->{cout} "
                         f"E{e} k{k} s{stride} SE{sem} (v3_i8_plan)")
    if x.device.type == "cpu":
        return v3_block_i8_plain(x, exp, dw, prj, k=k, stride=stride, act=act, se1=se1,
                                 se2=se2, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((n, ho, wo, cout), dtype=torch.int8, device=x.device)
    pooled = torch.empty((n * e,), dtype=torch.int32, device=x.device) if has_se else None

    def ptr(layer, key):  # 0 for a layer the block does not have
        return 0 if layer is None else layer[key].data_ptr()

    mult = "a" if act == "hswish" else "m"  # the named requant's per-channel factor
    code = lib.v3_block_i8(
        x.data_ptr(), ptr(exp, "w"), ptr(exp, "b"), ptr(exp, mult), ptr(dw, "w"), ptr(dw, "b"),
        ptr(dw, mult), ptr(prj, "w"), ptr(prj, "b"), ptr(prj, "m"), ptr(se1, "w"),
        ptr(se1, "b"), ptr(se1, "m"), ptr(se2, "w"), ptr(se2, "b"), ptr(se2, "a"),
        0 if pooled is None else pooled.data_ptr(), out.data_ptr(), n, h, w, cin, e, cout, sem,
        k, stride, ACTS["linear" if identity else act], ACTS[act], int(residual),
        int(identity), plan[0], plan[1], 0.0 if identity else float(exp["m6"]),
        float(dw["m6"]), qops._f32(1.0 / (ho * wo)), qops._f32(1.0 / 6.0),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    v3_block_i8.launches += 1
    return out


v3_block_i8.launches = 0
