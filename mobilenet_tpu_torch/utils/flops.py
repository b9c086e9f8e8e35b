"""The card's peak rates and the analytic work of one image.

`HBM_BYTES_PER_S` and `PEAK_OPS_PER_S` are the one home of the H100's
peaks in the port: NVIDIA's H100 SXM data sheet, dense rates at the full
700 W power limit (3.35 TB/s of HBM; 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s float32 outside them, 1,979 TOP/s int8). `runtime/metrics.py`
divides achieved operations by them, and `chip_smoke.py`'s bounds read
them.

`flops_per_image` is the JAX package's analytic MAC model
(`utils/profiling.py`), copied for MobileNet-V1, -V2 and -V3: multiply-adds
of one image, to be doubled for operations.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def flops_per_image(config) -> float:
    """Multiply-adds of one image (V1: the stem, the 13 depthwise and
    pointwise layers and the classifier; V2 and V3: the schedules the
    model modules encode)."""
    from ..models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from ..models.mobilenet_v3 import V3Config  # noqa: PLC0415

    if isinstance(config, V2Config):
        return _flops_v2(config)
    if isinstance(config, V3Config):
        return _flops_v3(config)
    total = 0
    for _, kind, cin, cout, stride, hw in config.layer_shapes():
        out_hw = hw // stride
        if kind == "conv":
            total += out_hw * out_hw * 9 * cin * cout
        elif kind == "dw":
            total += out_hw * out_hw * 9 * cin
        else:
            total += out_hw * out_hw * cin * cout
    total += config.feature_channels * config.num_classes
    return float(total)


def _flops_v2(config) -> float:
    """MobileNet-V2: stem, t-expand / depthwise / projection blocks (the
    expansion at the block's input size, exactly t * cin wide), conv_last
    and the classifier."""
    hw = config.resolution // 2
    total = hw * hw * 9 * 3 * config.stem_channels
    for t, cin, cout, stride in config.block_defs:
        e = int(round(t * cin))
        if t != 1:
            total += hw * hw * cin * e
        out_hw = hw // stride
        total += out_hw * out_hw * 9 * e
        total += out_hw * out_hw * e * cout
        hw = out_hw
    total += hw * hw * config.block_defs[-1][2] * config.last_channels
    total += config.last_channels * config.num_classes
    return float(total)


def _flops_v3(config) -> float:
    """MobileNet-V3: stem, bottlenecks (expansion, k x k depthwise, SE's two
    products on the pooled vector, projection), conv_last, the post-pool
    head and the classifier."""
    hw = config.resolution // 2
    total = hw * hw * 9 * 3 * config.stem_channels
    for bd in config.block_defs:
        if bd.has_expand:
            total += hw * hw * bd.cin * bd.cexp
        out_hw = hw // bd.stride
        total += out_hw * out_hw * bd.kernel * bd.kernel * bd.cexp
        if bd.se_mid:
            total += 2 * bd.cexp * bd.se_mid
        total += out_hw * out_hw * bd.cexp * bd.cout
        hw = out_hw
    total += hw * hw * config.block_defs[-1].cout * config.last_conv_channels
    total += config.last_conv_channels * config.last_point_channels
    total += config.last_point_channels * config.num_classes
    return float(total)
