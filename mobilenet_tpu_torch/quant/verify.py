"""INT8 verification: the device route against the port's oracles, with an
exact equality gate on every layer (the port of the JAX package's
`quant/verify.py`, `quant/v2.verify_int8_v2` and `quant/v3.verify_int8_v3`).
V1 takes either oracle: the NumPy one (`quant/oracle.py`) or the native C++
one (`cpu_ref`'s int8 layers, `oracle="cpp"`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config
from . import model as qmodel
from . import oracle as qoracle
from . import v2 as qv2
from . import v3 as qv3
from .quantize import ACT_HIDDEN_SCALE, QuantizedParams, quantize, quantize_input


def _report(acts_d: Dict[str, torch.Tensor], acts_o: Dict[str, np.ndarray], label: str,
            float_atol: float = 0.0) -> bool:
    """One line per oracle tap; True when every int8 tap matches exactly and
    every float tap (the logits) within `float_atol` (0: exactly)."""
    ok = True
    for name, ref in acts_o.items():
        got = acts_d[name].cpu().numpy()
        if got.shape != ref.shape:
            match, n_bad = False, -1
        elif ref.dtype != np.int8 and float_atol:
            n_bad = int((np.abs(got - ref) >= float_atol).sum())
            match = n_bad == 0
        else:
            match = np.array_equal(got, ref)
            n_bad = 0 if match else int((got != ref).sum())
        gate = "exact" if ref.dtype == np.int8 or not float_atol else f"< {float_atol:g}"
        print(f"[{'OK ' if match else 'FAIL'}] {name:14s} {gate} "
              f"{'' if match else f'({n_bad} mismatches)'}")
        ok &= match
    print(f"INT8 VERIFY {'OK' if ok else 'FAILED'} ({len(acts_o)} layers, {label})")
    return ok


@torch.inference_mode()
def verify_int8(config: ModelConfig, folded_params: Dict[str, Any], x_f32: np.ndarray,
                *, device="cuda", use_dw_kernel: bool = False,
                oracle: str = "numpy") -> bool:
    """Run the per-layer int8 route on `device` and the oracle ("numpy" or
    "cpp") on the same quantized weights and input; print one line per tap
    and return True when every tap matches exactly."""
    if oracle not in ("numpy", "cpp"):
        raise ValueError(f"oracle {oracle!r} is not 'numpy' or 'cpp'")
    q = quantize(folded_params, config)
    x_i8 = quantize_input(x_f32)
    dev = qmodel.to_device_i8(q, device)
    _, acts_d = qmodel.forward_i8(dev, torch.from_numpy(x_i8).to(device), config,
                                  use_dw_kernel=use_dw_kernel, collect=True)
    forward_all = _cpp_forward_all if oracle == "cpp" else qoracle.forward_all
    _, acts_o = forward_all(q, x_i8, config)
    return _report(acts_d, acts_o, f"{oracle} oracle")


def _cpp_forward_all(q: QuantizedParams, x_i8: np.ndarray, config: ModelConfig):
    """The native C++ int8 oracle's V1 forward (cpu_ref's int8 layers; the
    pool and fc of the NumPy oracle), tap names as forward_i8(collect=True)."""
    from .. import cpu_ref  # noqa: PLC0415

    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = cpu_ref.conv3x3_i8(x_i8, c1.w_i8, c1.bias_i32, c1.m, c1.s_out, 2, relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(q.blocks, config.block_strides)):
        d = blk["dw"]
        y = cpu_ref.dw3x3_i8(y, d.w_i8, d.bias_i32, d.m, d.s_out, stride, relu6)
        acts[f"block{i:02d}_dw"] = y
        p = blk["pw"]
        y = cpu_ref.pw_i8(y, p.w_i8, p.bias_i32, p.m, p.s_out, relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = qoracle.avgpool_i8(y)
    acts["pool"] = pooled
    logits = qoracle.fc_i8_logits(pooled, q.fc_w_i8, ACT_HIDDEN_SCALE, q.fc_s_w, q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts


@torch.inference_mode()
def verify_int8_v2(config: V2Config, folded: Dict[str, Any], x_f32: np.ndarray, *,
                   n_calib: int = 32, device="cuda") -> bool:
    """The V2 gate: calibrate and quantize `folded` (n_calib images), run the
    per-layer int8 V2 route on `device` and forward_all_v2_i8 on the same
    constants and input; True when every tap (int8 and the float32 logits)
    matches exactly."""
    q = qv2.quantize_v2(folded, config, n_calib=n_calib)
    x_i8 = quantize_input(x_f32)
    dev = qv2.to_device_i8_v2(q, device)
    _, acts_d = qv2.forward_v2_i8(dev, torch.from_numpy(x_i8).to(device), config, collect=True)
    _, acts_o = qv2.forward_all_v2_i8(q, x_i8, config)
    return _report(acts_d, acts_o, "numpy oracle, v2")


@torch.inference_mode()
def verify_int8_v3(config: V3Config, folded: Dict[str, Any], x_f32: np.ndarray, *,
                   n_calib: int = 32, device="cuda") -> bool:
    """The V3 gate (the JAX package's verify_int8_v3): calibrate and
    quantize `folded` (n_calib images), run the per-layer int8 V3 route on
    `device` and forward_all_v3_i8 on the same constants and input; True
    when every int8 tap is equal and the float32 logits are within 1e-5."""
    q = qv3.quantize_v3(folded, config, n_calib=n_calib)
    x_i8 = quantize_input(x_f32)
    dev = qv3.to_device_i8_v3(q, device)
    _, acts_d = qv3.forward_v3_i8(dev, torch.from_numpy(x_i8).to(device), config, collect=True)
    _, acts_o = qv3.forward_all_v3_i8(q, x_i8, config)
    return _report(acts_d, acts_o, f"numpy oracle, {config.variant_name()}", float_atol=1e-5)
