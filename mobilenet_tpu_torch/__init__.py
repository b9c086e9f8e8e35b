"""mobilenet_tpu_torch: the PyTorch/CUDA port of mobilenet_tpu.

MobileNet-V1, -V2 and -V3 (Large, Small, minimalistic) serving on an NVIDIA
H100, float (`InferencePipeline`, with a ModelConfig, a V2Config or a
V3Config) and exact int8 for V1, V2 and V3 (`Int8Pipeline`,
`Int8PipelineV2`, `Int8PipelineV3`), and the per-layer verify gates
(`cli verify`): plain PyTorch ops around hand-written CUDA kernels for
Hopper (`csrc/`), built with nvcc at first use. The JAX package `mobilenet_tpu` is the reference it is tested
against; this package never imports JAX.
"""

from .config import ModelConfig  # noqa: F401
from .models.mobilenet_v2 import V2Config  # noqa: F401
from .models.mobilenet_v3 import V3Config  # noqa: F401
from .runtime.pipeline import InferencePipeline  # noqa: F401
from .quant.model import Int8Pipeline  # noqa: F401
from .quant.v2 import Int8PipelineV2  # noqa: F401
from .quant.v3 import Int8PipelineV3  # noqa: F401
