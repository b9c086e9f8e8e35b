"""mobilenet_tpu_torch: the PyTorch/CUDA port of mobilenet_tpu.

MobileNet-V1 float serving on an NVIDIA H100: plain PyTorch ops around
three hand-written CUDA kernels for Hopper (`csrc/`), built with nvcc at
first use. The JAX package `mobilenet_tpu` is the reference it is tested
against; this package never imports JAX.
"""

from .config import ModelConfig  # noqa: F401
from .runtime.pipeline import InferencePipeline  # noqa: F401
