"""mobilenet_tpu_torch: the PyTorch/CUDA port of mobilenet_tpu.

MobileNet-V1 serving on an NVIDIA H100, float (`InferencePipeline`) and
exact int8 (`Int8Pipeline`), and MobileNet-V2 float serving
(`InferencePipeline(V2Config(...))`): plain PyTorch ops around hand-written
CUDA kernels for Hopper (`csrc/`), built with nvcc at first use. The JAX package
`mobilenet_tpu` is the reference it is tested against; this package never
imports JAX.
"""

from .config import ModelConfig  # noqa: F401
from .models.mobilenet_v2 import V2Config  # noqa: F401
from .runtime.pipeline import InferencePipeline  # noqa: F401
from .quant.model import Int8Pipeline  # noqa: F401
