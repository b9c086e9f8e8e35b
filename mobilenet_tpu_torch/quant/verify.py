"""INT8 verification: the device route against the port's NumPy oracle, with
an exact equality gate on every layer (the port of the JAX package's
`quant/verify.py` and `quant/v2.verify_int8_v2`, numpy oracle only)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v2 import V2Config
from . import model as qmodel
from . import oracle as qoracle
from . import v2 as qv2
from .quantize import quantize, quantize_input


def _report(acts_d: Dict[str, torch.Tensor], acts_o: Dict[str, np.ndarray], label: str) -> bool:
    """One line per oracle tap; True when every tap matches exactly."""
    ok = True
    for name, ref in acts_o.items():
        got = acts_d[name].cpu().numpy()
        match = np.array_equal(got, ref)
        n_bad = 0 if match or got.shape != ref.shape else int((got != ref).sum())
        print(f"[{'OK ' if match else 'FAIL'}] {name:14s} exact "
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
