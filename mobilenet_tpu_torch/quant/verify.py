"""INT8 verification: the device route against the port's NumPy oracle, with
an exact equality gate on every layer (the port of the JAX package's
`quant/verify.py`, `quant/v2.verify_int8_v2` and `quant/v3.verify_int8_v3`,
numpy oracle only)."""

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
from .quantize import quantize, quantize_input


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
                *, device="cuda", use_dw_kernel: bool = False) -> bool:
    """Run the per-layer int8 route on `device` and the NumPy oracle on the
    same quantized weights and input; print one line per tap and return
    True when every tap matches exactly."""
    q = quantize(folded_params, config)
    x_i8 = quantize_input(x_f32)
    dev = qmodel.to_device_i8(q, device)
    _, acts_d = qmodel.forward_i8(dev, torch.from_numpy(x_i8).to(device), config,
                                  use_dw_kernel=use_dw_kernel, collect=True)
    _, acts_o = qoracle.forward_all(q, x_i8, config)
    return _report(acts_d, acts_o, "numpy oracle")


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
