"""The exact int8 path of the port: host quantization (`quantize`), plain
int8 ops (`ops`), the NumPy oracle (`oracle`), the int8 forward and
`Int8Pipeline` (`model`), MobileNet-V2's calibration, oracle, forward and
`Int8PipelineV2` (`v2`), MobileNet-V3's (`v3`, `Int8PipelineV3`), and the
per-layer gates (`verify`)."""

from .quantize import (  # noqa: F401
    ACT_HIDDEN_SCALE, ACT_IN_SCALE, QuantizedParams, QuantLayer, quantize, quantize_input,
)
from .v2 import V2QuantizedParams, quantize_v2  # noqa: F401
from .v3 import V3QuantizedParams, quantize_v3  # noqa: F401
