"""Evaluation inputs and the float verify gates.

`synth_images` is the JAX package's `runtime/eval.py` function, copied
verbatim (the int8 V2 and V3 calibration set). The float per-layer gate
`verify_layers` is the JAX package's `cli verify` (`cmd_verify`,
`_verify_v2`, `_verify_v3`, one function choosing the family's tolerance):
every tap of the float32 plain route against an oracle (the NumPy twin
`oracle/numpy_ref.py` or the C++ `cpu_ref`) on the same folded weights and
input, at the tolerances of `utils/golden.py`. `verify_routing` is its `_verify_routing`: the logits of
a shipping route against the plain route's at one dtype. The rest of that
module, the end-to-end accuracy gate, is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config
from ..oracle import numpy_ref
from ..utils import golden

ORACLES = ("cpp", "numpy")
# The verify routings (the JAX package's names in brackets): "plain"
# ["xla"], "fused", "mixed", "auto", and on MobileNet-V1 "dw" ["pallas"].
ROUTINGS = ("plain", "fused", "mixed", "auto", "dw")


def _oracle(name: str):
    """The oracle module: `cpu_ref` ("cpp", built at first use) or
    `numpy_ref` ("numpy"); both have forward_all, _v2 and _v3."""
    if name == "cpp":
        from .. import cpu_ref  # noqa: PLC0415

        return cpu_ref
    if name == "numpy":
        return numpy_ref
    raise ValueError(f"oracle {name!r} not in {ORACLES}")


def _oracle_forward(oracle: str, config):
    mod = _oracle(oracle)
    if isinstance(config, V3Config):
        return mod.forward_all_v3
    if isinstance(config, V2Config):
        return mod.forward_all_v2
    return mod.forward_all


@torch.inference_mode()
def verify_layers(config, folded: Dict[str, Any], x_f32: np.ndarray, *,
                  oracle: str = "numpy", device="cuda") -> bool:
    """The float per-layer gate: every tap of the float32 plain route on
    `device` (the pipeline's activations) against the oracle on the same
    folded weights and input. MobileNet-V1 (conv1, blockNN_dw/_pw, pool,
    logits): golden.DW_TOL on depthwise taps, golden.MM_TOL on the rest.
    MobileNet-V2: golden.V2_TOL on every tap (the linear bottlenecks carry
    f32 noise unclipped). MobileNet-V3 (conv1, block{i:02d}_exp/_dw/_se/
    _prj/_out, conv_last, pool, head, logits): golden.V3_TOL (unbounded relu
    and hard-swish activations of O(30), the SE gates' pooled products).
    Prints one LayerReport line per tap, then "VERIFY OK: all N layers
    match (...)" or "VERIFY FAILED at <tap>"; a tap that the route and the
    oracle do not both produce at one shape fails there."""
    from .pipeline import InferencePipeline  # noqa: PLC0415

    cfg = dataclasses.replace(config, compute_dtype="float32")
    tol = (golden.V3_TOL if isinstance(cfg, V3Config)
           else golden.V2_TOL if isinstance(cfg, V2Config) else None)
    pipe = InferencePipeline(cfg, folded, device=device, dw_backend="plain")
    _, acts = pipe.activations(x_f32)
    _, ref = _oracle_forward(oracle, cfg)(folded, np.asarray(x_f32, np.float32), cfg)
    unpaired = [n for n in ref if n not in acts or acts[n].shape != ref[n].shape]
    unpaired += [n for n in acts if n not in ref]
    for n in unpaired:
        print(f"[FAIL] {n:14s} route {getattr(acts.get(n), 'shape', 'missing')} vs "
              f"oracle {getattr(ref.get(n), 'shape', 'missing')}")
    reports = [] if unpaired else golden.compare_activations(
        acts, ref, tols=None if tol is None else {n: tol for n in ref})
    for r in reports:
        print(r)
    bad = unpaired[0] if unpaired else getattr(golden.first_divergence(reports), "name", None)
    if bad is None:
        print(f"VERIFY OK: all {len(reports)} layers match ({oracle} oracle, "
              f"{cfg.variant_name()})")
        return True
    print(f"VERIFY FAILED at {bad}")
    return False


def _route_backend(config, routing: str):
    """A verify routing name -> the model's dw_backend. MobileNet-V1's
    "mixed" is the JAX package's: plain ops on the two 112-squared blocks,
    fused from block 2 on (the port's V1 routing takes it as a per-block
    tuple); "dw" is a MobileNet-V1 routing."""
    if routing not in ROUTINGS:
        raise ValueError(f"routing {routing!r} not in {ROUTINGS}")
    if isinstance(config, (V2Config, V3Config)):
        if routing == "dw":
            raise ValueError("routing 'dw' is a MobileNet-V1 routing; the V2 and V3 "
                             "families race plain against fused, mixed or auto")
        return routing
    if routing == "mixed":
        return ("plain",) * 2 + ("fused",) * (len(config.block_strides) - 2)
    return routing


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(a * a)))


@torch.inference_mode()
def verify_routing(config, folded: Dict[str, Any], x_f32: np.ndarray, routing: str, *,
                   dtype: str = "float32", oracle: str = "numpy", device="cuda") -> bool:
    """The routing gate (logits): a shipping route ("fused", "mixed",
    "auto", "dw") against the plain route of the same weights and input at
    `dtype`, end to end. float32: within (2e-4, 2e-3). bfloat16: the
    scale-aware golden.routing_bf16_atol (rtol 5e-2), and the route's RMS
    distance from the float32 oracle within ROUTING_ANCHOR_FACTOR x the
    plain route's + ROUTING_BF16_ATOL. Top-1 must agree row for row except
    between classes the plain route holds within the gate's atol (a near
    tie). The oracle's top-1 is printed beside, unchecked."""
    from .pipeline import InferencePipeline  # noqa: PLC0415

    backend = _route_backend(config, routing)
    cfg = dataclasses.replace(config, compute_dtype=dtype)
    pipe = InferencePipeline(cfg, folded, device=device, dw_backend="plain")
    x = torch.from_numpy(np.asarray(x_f32, np.float32)).to(pipe.device).to(pipe.dtype)

    def logits(route):
        out = pipe._forward(pipe.params, x, cfg, dw_backend=route)
        return out.float().cpu().numpy()

    got, ref = logits(backend), logits("plain")
    ora = np.asarray(_oracle_forward(oracle, cfg)(
        folded, np.asarray(x_f32, np.float32), cfg)[0], np.float32)
    anchor_ok = True
    if dtype == "bfloat16":
        atol = golden.routing_bf16_atol(float(np.abs(ref).max()), _rms(got - ref), got.size)
        rtol = 5e-2
        d_got, d_ref = _rms(got - ora), _rms(ref - ora)
        anchor = golden.ROUTING_ANCHOR_FACTOR * d_ref + golden.ROUTING_BF16_ATOL
        anchor_ok = d_got <= anchor
        print(f"[{'OK ' if anchor_ok else 'FAIL'}] oracle anchor (rms): "
              f"|{routing}-fp32|={d_got:.4f} vs {golden.ROUTING_ANCHOR_FACTOR}x"
              f"|plain-fp32|+atol={anchor:.4f} (max_abs {float(np.abs(got - ora).max()):.3f} "
              f"vs {float(np.abs(ref - ora).max()):.3f} [informational])")
    elif dtype == "float32":
        atol, rtol = 2e-4, 2e-3
    else:
        raise ValueError(f"dtype {dtype!r} is not float32 or bfloat16")
    report = golden.compare_activations({"logits": got}, {"logits": ref},
                                        tols={"logits": (atol, rtol)})[0]
    print(report)
    agree = got.argmax(-1) == ref.argmax(-1)
    srt = np.sort(ref, axis=-1)
    near_tie = (~agree) & (srt[:, -1] - srt[:, -2] < atol)
    top1_ok = bool((agree | near_tie).all())
    tie_note = (f" ({int(near_tie.sum())} near-tie flips within atol={atol}, not gated)"
                if near_tie.any() else "")
    print(f"top-1 routing({routing}) == routing(plain): {int(agree.sum())}/{len(got)}"
          f"{tie_note}")
    print(f"top-1 routing({routing}) == {oracle} oracle (fp32): "
          f"{int((got.argmax(-1) == ora.argmax(-1)).sum())}/{len(got)} [informational]")
    ok = report.ok and top1_ok and anchor_ok
    print(f"ROUTING VERIFY {'OK' if ok else 'FAILED'}: {routing} vs plain @ "
          f"{cfg.variant_name()} {dtype} batch={len(got)}")
    return ok


def synth_images(config: ModelConfig, n: int, seed: int,
                 structured: bool = True) -> List[np.ndarray]:
    """Seeded uint8 images at native resolution (no-network stand-in for
    sample ImageNet images).

    structured=True (default) cycles four deterministic families instead of
    pure noise — noise, linear gradients, block patches/checkerboards, and
    smooth low-frequency blobs. Natural-image-like structure stresses the
    resize/normalize path and produces less-uniform logits than iid noise,
    so top-1 margins vary more realistically.
    structured=False gives pure noise."""
    rng = np.random.default_rng(seed)
    res = config.resolution
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / max(res - 1, 1)
    images: List[np.ndarray] = []
    for i in range(n):
        kind = i % 4 if structured else 0
        if kind == 0:  # iid noise
            img = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        elif kind == 1:  # linear gradient, random direction/colors per channel
            a, b = rng.uniform(-1, 1, 2)
            t = (a * xx + b * yy - min(a, 0) - min(b, 0)) / (abs(a) + abs(b) + 1e-6)
            lo, hi = rng.integers(0, 256, (2, 3))
            img = (lo + t[..., None] * (hi.astype(np.float32) - lo)).astype(np.uint8)
        elif kind == 2:  # block patches (checkerboard-like, random cell size)
            cell = int(rng.integers(4, max(5, res // 4)))
            gy = (np.arange(res) // cell)
            colors = rng.integers(0, 256, (gy.max() + 1, gy.max() + 1, 3))
            img = colors[gy[:, None], gy[None, :]].astype(np.uint8)
        else:  # smooth low-frequency blobs (sums of 2-D sinusoids)
            img = np.zeros((res, res, 3), np.float32)
            for c in range(3):
                fx, fy = rng.uniform(0.5, 4.0, 2)
                px, py = rng.uniform(0, 2 * np.pi, 2)
                img[..., c] = (np.sin(2 * np.pi * fx * xx + px)
                               * np.sin(2 * np.pi * fy * yy + py))
            img = ((img + 1) * 127.5).astype(np.uint8)
        images.append(img)
    return images
