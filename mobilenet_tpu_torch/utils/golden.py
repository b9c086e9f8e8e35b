"""Per-layer golden comparison: the port's copy of the JAX package's
`utils/golden.py`, the one home of the port's float tolerances.

The float verify gates (`runtime/eval.py`) compare every tap of the plain
route (`collect=True`) with an oracle (`oracle/numpy_ref.py` or the C++
`cpu_ref`) and report the first layer that diverges. Float32 convolutions
and matmuls reassociate their sums against the oracle's fixed tap order, so
the gate is elementwise |diff| <= atol + rtol*|ref| with tight constants;
max-ULP is reported beside it. The int8 paths, whose requantization is
deterministic, use an exact gate instead (`quant/verify.py`). Every
constant below is the JAX package's, with the reason it gives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# (atol, rtol) per layer kind, float32 verify. Both sides run every
# preceding layer, so reassociation noise compounds with depth: the JAX
# package measured max_abs ~2.5e-5 by block 12 at 1.0-224 (~50 ULP at
# ReLU6's scale of 6). A wrong pad, stride or BN fold is O(1e-1..1).
DW_TOL = (1e-4, 1e-4)  # 9-tap depthwise, fixed-order oracle
MM_TOL = (1e-4, 3e-4)  # K-deep conv/pointwise/fc reductions (K up to 1024)

# MobileNet-V2: the linear bottlenecks and residual chains carry the noise
# unclipped (V1's ReLU6 bounds every layer; V2's projections do not). The
# JAX package measured a worst max_abs of 3.9e-4 by block 16 (1.0-96, both
# oracles); 1e-3 keeps 2.5x headroom and stays >= 100x below a defect.
V2_TOL = (1e-3, 1e-3)

# MobileNet-V3: V2's story plus unbounded relu and hard-swish activations
# of O(30) on the seeded weights, and the SE gate's pooled product in every
# channel. >= 2x headroom over the JAX package's worst measured divergence
# (Large and Small, 1.0-96..224), >= 30x below a defect.
V3_TOL = (3e-3, 1e-3)

# The routing gate (`runtime/eval.verify_routing`), bf16: two valid
# accumulation orders of one program differ by bf16 rounding compounded
# over depth, in proportion to the logits' scale, so the limit is the
# larger of an absolute floor (V1-calibrated) and a share of the logits'
# absmax (~3x the V3-Large class the JAX package measured: 1.5-2.1% of
# absmax between its fused and XLA routes).
ROUTING_BF16_ATOL = 6e-2
ROUTING_BF16_REL = 4.5e-2
# Extreme-value headroom: the max of defectless noise over n samples is
# about rms * sqrt(2 ln n); 1.5x covers draw-to-draw spread. A localized
# defect breaks the max/rms ratio; a broad one moves the RMS anchor below.
ROUTING_EV_FACTOR = 1.5
# Oracle anchor (bf16): the route under test stays within this factor of
# the reference route's own RMS distance from the float32 oracle. RMS, not
# max: the max is an extreme-value statistic that flips between two draws.
ROUTING_ANCHOR_FACTOR = 1.5

# `cli eval`'s bf16 tie margin per family: the relative oracle-logit margin
# under which a bf16 top-1 flip against the float32 oracle counts as a near
# tie, not a mismatch. A tolerance, not a time: the JAX package set these
# values from the flips it saw on its own accelerator (V1 1.0-224: none in
# 256 images, so far below 1e-3; V3-Large 1.0-224: a flip at 1.3%, inside
# the bf16 logits' spread). The port's runs on the card record the card's
# own flip margins beside them (PERF.md). int8 is exact: `cli eval` gates
# it at 0.
BF16_TIE_MARGIN = {"v1": 1e-3, "v2": 3e-2, "v3": 3e-2}


def routing_bf16_atol(scale: float, rms_fr: float, n_samples: int) -> float:
    """Max-abs tolerance of the bf16 routing gate: the absolute and
    relative floors, lifted by the extreme-value bound of the measured
    inter-route rms over `n_samples` values."""
    ev = rms_fr * float(np.sqrt(2.0 * np.log(max(float(n_samples), 2.0))))
    return max(ROUTING_BF16_ATOL, ROUTING_BF16_REL * scale, ROUTING_EV_FACTOR * ev)


def max_ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Max distance in representable float32 steps between two arrays."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)
    ai = a32.view(np.int32).astype(np.int64)
    bi = b32.view(np.int32).astype(np.int64)
    # Map the sign-magnitude float ordering onto a monotone integer line.
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return int(np.max(np.abs(ai - bi))) if a32.size else 0


@dataclasses.dataclass
class LayerReport:
    name: str
    max_abs: float
    max_rel: float
    max_ulp: int
    excess: float  # max(|diff| - (atol + rtol|ref|)); <= 0 means pass
    atol: float
    rtol: float

    @property
    def ok(self) -> bool:
        return self.excess <= 0.0

    def __str__(self) -> str:
        flag = "OK " if self.ok else "FAIL"
        return (
            f"[{flag}] {self.name:14s} max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e} ulp={self.max_ulp} "
            f"(gate atol={self.atol:g} rtol={self.rtol:g})"
        )


def _tol_for(name: str) -> Tuple[float, float]:
    return DW_TOL if name.endswith("_dw") else MM_TOL


def compare_activations(
    got: Dict[str, np.ndarray],
    golden: Dict[str, np.ndarray],
    tols: Optional[Dict[str, Tuple[float, float]]] = None,
) -> List[LayerReport]:
    """One LayerReport per golden tap, in the golden's order; `tols` maps a
    tap to (atol, rtol), else DW_TOL for `*_dw` taps and MM_TOL for the
    rest. Raises on a missing tap or a shape mismatch."""
    reports: List[LayerReport] = []
    for name, ref in golden.items():
        if name not in got:
            raise KeyError(f"pipeline did not produce layer {name!r}")
        test = np.asarray(got[name], np.float32)
        ref = np.asarray(ref, np.float32)
        if test.shape != ref.shape:
            raise AssertionError(f"{name}: shape {test.shape} vs golden {ref.shape}")
        diff = np.abs(test - ref)
        absref = np.abs(ref)
        atol, rtol = (tols or {}).get(name, _tol_for(name))
        reports.append(
            LayerReport(
                name=name,
                max_abs=float(diff.max()) if diff.size else 0.0,
                max_rel=float((diff / np.maximum(absref, 1e-6)).max()) if diff.size else 0.0,
                max_ulp=max_ulp_diff(test, ref),
                excess=float((diff - (atol + rtol * absref)).max()) if diff.size else 0.0,
                atol=atol,
                rtol=rtol,
            )
        )
    return reports


def first_divergence(reports: List[LayerReport]) -> Optional[LayerReport]:
    for r in reports:
        if not r.ok:
            return r
    return None


def assert_all_match(reports: List[LayerReport]) -> None:
    bad = first_divergence(reports)
    if bad is not None:
        lines = "\n".join(str(r) for r in reports)
        raise AssertionError(f"first divergence at {bad.name}:\n{lines}")
