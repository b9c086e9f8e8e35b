"""Evaluation inputs: the JAX package's `runtime/eval.py` `synth_images`,
copied verbatim (the int8 V2 calibration set). The rest of that module, the
end-to-end accuracy gate, is not ported yet."""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import ModelConfig


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
