"""Structured run metrics: one JSON document per run (throughput, latency
percentiles, the model's work per image, the share of the card's peak it
reached, the variant), for regression tracking.

The port of the JAX package's `runtime/metrics.py`. Two departures:
  - `mfu` takes the place of `mxu_utilization`: achieved operations
    (2 x multiply-adds x images/s) over the H100's data-sheet peak for the
    pipeline's type (`utils/flops.PEAK_OPS_PER_S`: bf16, float32 or int8).
    It is filled only for a pipeline on a CUDA device, since a rate taken
    on the CPU is not the card's.
  - `xla_flops`, `xla_bytes_accessed` and `build_report`'s
    `with_cost_analysis` have no counterpart: they read XLA's cost model,
    and the port compiles no XLA program.
"""

from __future__ import annotations

import dataclasses
import json
import platform
import time
from typing import Any, Dict, Optional

import torch

from ..utils.flops import PEAK_OPS_PER_S, flops_per_image

_KINDS = {torch.bfloat16: "bf16", torch.float32: "f32"}


@dataclasses.dataclass
class RunReport:
    variant: str
    dtype: str
    batch_size: int
    images_per_sec: float
    p50_latency_ms: float
    p99_latency_ms: float
    device: str = ""
    dw_backend: str = ""
    compile_seconds: Optional[float] = None
    model_macs_per_image: Optional[float] = None
    mfu: Optional[float] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["host"] = platform.node()
        return json.dumps(d)


def peak_kind(pipeline) -> str:
    """The peak-rate key of a pipeline: "int8" for the int8 pipelines, else
    its compute dtype's."""
    from ..quant.model import Int8Pipeline  # noqa: PLC0415

    return "int8" if isinstance(pipeline, Int8Pipeline) else _KINDS[pipeline.dtype]


def mfu(images_per_sec: float, macs_per_image: float, kind: str) -> float:
    """Achieved operations over the card's peak for `kind`."""
    return images_per_sec * macs_per_image * 2 / PEAK_OPS_PER_S[kind]


def build_report(pipeline, stats: Dict[str, Any], *,
                 compile_seconds: Optional[float] = None) -> RunReport:
    """A RunReport of `pipeline` (float or int8) from `stats`, a
    `benchmark()` result: images_per_sec, p50/p99_latency_ms, batch_size,
    and any other keys, kept under `extra`."""
    cfg = pipeline.config
    macs = flops_per_image(cfg)
    imgs = float(stats["images_per_sec"])
    kind = peak_kind(pipeline)
    on_card = pipeline.device.type == "cuda"
    return RunReport(
        variant=cfg.variant_name(),
        dtype={"bf16": "bfloat16", "f32": "float32"}.get(kind, kind),
        batch_size=int(stats.get("batch_size", 0)),
        images_per_sec=round(imgs, 1),
        p50_latency_ms=round(stats.get("p50_latency_ms", 0.0), 3),
        p99_latency_ms=round(stats.get("p99_latency_ms", 0.0), 3),
        device=(torch.cuda.get_device_name(pipeline.device) if on_card
                else str(pipeline.device)),
        dw_backend=str(pipeline.dw_backend),
        compile_seconds=compile_seconds,
        model_macs_per_image=macs,
        mfu=round(mfu(imgs, macs, kind), 4) if on_card else None,
        extra={k: v for k, v in stats.items()
               if k not in {"images_per_sec", "p50_latency_ms", "p99_latency_ms",
                            "batch_size"}},
    )
