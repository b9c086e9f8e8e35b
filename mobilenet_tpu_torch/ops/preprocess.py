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


def decode_image_host(path: str, backend: str = "auto"):
    """Host-side decode -> uint8 HWC RGB numpy array (the one host stage;
    resize and normalization run on the device).

    backend: "native" = the C++ libjpeg/libpng decoder (`native_io`), "pil"
    = PIL, "auto" = native where it builds on this machine, else PIL, and PIL
    also for a file the native decoder refuses (BMP, GIF, WebP, or corrupt
    data, which PIL then reports)."""
    import numpy as np  # noqa: PLC0415

    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if backend != "pil":
        from .. import native_io  # noqa: PLC0415

        if backend == "native":
            return native_io.decode_image(path)
        if native_io.available():
            try:
                return native_io.decode_image(path)
            except ValueError:
                pass  # a format or file the native decoder refuses: PIL below
    from PIL import Image  # noqa: PLC0415

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
