"""Evaluation inputs and the MobileNet-V3 float gate.

`synth_images` is the JAX package's `runtime/eval.py` function, copied
verbatim (the int8 V2 calibration set). `verify_v3` is the JAX package's
float per-layer gate of V3 (`cli._verify_v3`): every tap of the plain route
against the NumPy oracle. The rest of that module, the end-to-end accuracy
gate, is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import ModelConfig
from ..oracle import numpy_ref

# The JAX package's V3 per-layer tolerance (atol, rtol), utils/golden.py
# V3_TOL: unbounded relu and hard-swish activations of O(30) and the SE
# gate's pooled product carry float32 reassociation through 15 blocks;
# a wrong pad, stride or fold is O(1e-1..1).
V3_TOL = (3e-3, 1e-3)


@torch.inference_mode()
def verify_v3(config, folded: Dict[str, Any], x_f32: np.ndarray, *, device="cuda") -> bool:
    """The V3 float gate: the float32 plain route's taps on `device`
    (conv1, block{i:02d}_exp/_dw/_se/_prj/_out, conv_last, pool, head,
    logits) against `numpy_ref.forward_all_v3` on the same folded weights
    and input, elementwise |diff| <= atol + rtol |ref| at V3_TOL. Prints one
    line per tap; True when every tap passes."""
    from .pipeline import InferencePipeline  # noqa: PLC0415

    cfg = dataclasses.replace(config, compute_dtype="float32")
    pipe = InferencePipeline(cfg, folded, device=device, dw_backend="plain")
    _, acts = pipe.activations(x_f32)
    _, ref = numpy_ref.forward_all_v3(folded, x_f32, cfg)
    atol, rtol = V3_TOL
    ok = set(acts) == set(ref)
    for name, want in ref.items():
        got = acts.get(name)
        if got is None or got.shape != want.shape:
            print(f"[FAIL] {name:14s} missing or shape {None if got is None else got.shape}")
            ok = False
            continue
        diff = np.abs(got - want)
        excess = float((diff - (atol + rtol * np.abs(want))).max())
        ok &= excess <= 0
        print(f"[{'OK ' if excess <= 0 else 'FAIL'}] {name:14s} max_abs={float(diff.max()):.3e} "
              f"(gate atol={atol:g} rtol={rtol:g})")
    print(f"VERIFY {'OK' if ok else 'FAILED'} ({len(ref)} layers, numpy oracle, "
          f"{cfg.variant_name()})")
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
