"""Model configuration for the PyTorch/CUDA MobileNet-V1 port.

The same frozen dataclass, layer table and normalize constants as the JAX
package's `mobilenet_tpu/config.py`, so that one config value means the same
network in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# The 13 depthwise-separable blocks: (stride, pointwise out_channels at alpha=1.0).
BLOCK_DEFS: Tuple[Tuple[int, int], ...] = (
    (1, 64),
    (2, 128),
    (1, 128),
    (2, 256),
    (1, 256),
    (2, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (2, 1024),
    (1, 1024),
)

STEM_CHANNELS = 32  # first 3x3 conv, stride 2

ALPHAS = (0.25, 0.5, 0.75, 1.0)
RESOLUTIONS = (128, 160, 192, 224)


def scaled_channels(base: int, alpha: float) -> int:
    """Width-multiplier channel scaling, matching keras int(filters * alpha)."""
    return int(base * alpha)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static description of one MobileNet-V1 variant."""

    alpha: float = 1.0
    resolution: int = 224
    num_classes: int = 1000
    relu6: bool = True
    bn_eps: float = 1e-3
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.alpha not in ALPHAS:
            raise ValueError(f"alpha must be one of {ALPHAS}, got {self.alpha}")
        if self.resolution % 32 != 0:
            raise ValueError(f"resolution must be divisible by 32, got {self.resolution}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def stem_channels(self) -> int:
        return scaled_channels(STEM_CHANNELS, self.alpha)

    @property
    def block_channels(self) -> Tuple[int, ...]:
        """Pointwise output channels per block after alpha scaling."""
        return tuple(scaled_channels(c, self.alpha) for _, c in BLOCK_DEFS)

    @property
    def block_strides(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in BLOCK_DEFS)

    @property
    def feature_channels(self) -> int:
        """Channels entering the classifier head (1024 at alpha=1)."""
        return self.block_channels[-1]

    @property
    def final_spatial(self) -> int:
        """Spatial size before global average pool (7 for 224)."""
        return self.resolution // 32

    def layer_shapes(self):
        """Yield (name, kind, in_ch, out_ch, stride, in_hw) for all conv layers."""
        hw = self.resolution // 2
        yield ("conv1", "conv", 3, self.stem_channels, 2, self.resolution)
        c_in = self.stem_channels
        for i, ((stride, _), c_out) in enumerate(zip(BLOCK_DEFS, self.block_channels)):
            yield (f"block{i:02d}_dw", "dw", c_in, c_in, stride, hw)
            if stride == 2:
                hw //= 2
            yield (f"block{i:02d}_pw", "pw", c_in, c_out, 1, hw)
            c_in = c_out

    def variant_name(self) -> str:
        return f"mobilenet_v1_{self.alpha:g}_{self.resolution}"


# TF-mode normalize: scale uint8 to [-1, 1].
PREPROCESS_SCALE = 1.0 / 127.5
PREPROCESS_OFFSET = -1.0
