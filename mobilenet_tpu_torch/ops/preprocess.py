"""On-device image preprocessing (plain PyTorch): uint8 NHWC -> normalized
NHWC at model resolution, as the JAX package's `ops/preprocess.py`.

Resize is bilinear without antialiasing, half-pixel centres
(`F.interpolate(align_corners=False)`), which matches
`jax.image.resize(..., "bilinear", antialias=False)`; at model size it is
the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import PREPROCESS_OFFSET, PREPROCESS_SCALE


def normalize(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> dtype in [-1, 1] (TF mode)."""
    x = images_u8.float() * PREPROCESS_SCALE + PREPROCESS_OFFSET
    return x.to(dtype)


def resize_bilinear(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """Resize float NHWC to (resolution, resolution)."""
    n, h, w, c = images.shape
    if h == resolution and w == resolution:
        return images
    y = F.interpolate(images.permute(0, 3, 1, 2), size=(resolution, resolution),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def preprocess(images_u8: torch.Tensor, resolution: int,
               dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC of any size -> normalized NHWC at model resolution."""
    x = resize_bilinear(images_u8.float(), resolution)
    x = x * PREPROCESS_SCALE + PREPROCESS_OFFSET
    return x.to(dtype).contiguous()
