"""The exact int8 path of the port: host quantization (`quantize`), plain
int8 ops (`ops`), the NumPy oracle (`oracle`), the int8 forward and
`Int8Pipeline` (`model`), and the per-layer gate (`verify`)."""

from .quantize import (  # noqa: F401
    ACT_HIDDEN_SCALE, ACT_IN_SCALE, QuantizedParams, QuantLayer, quantize, quantize_input,
)
