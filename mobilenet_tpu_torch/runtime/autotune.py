"""Measured routing: race a model's candidate routes end to end on the card.

The port of the JAX package's `runtime/autotune.py`. A network has several
legal routes (the plain ops, the kernels, and per-block mixes of both:
models.mobilenet_v1.DW_BACKENDS and "mixed"), and which is fastest depends
on the batch and the device. The shipped "auto" is fused at every batch;
`autotune_backend` re-derives the choice on the device at hand, for the
float and the int8 paths of MobileNet-V1, -V2 and -V3, each candidate on
its own pipeline (the weights it ships with, padding included), over the
whole network. Two modes, by what the number must mean:
  - throughput (batch >= 2): img/s of the pipeline's "probs_u8" entry on
    one device-resident uint8 batch, in a window fenced by reading a few
    bytes of the last output back (utils/timing.fenced_window); higher wins;
  - latency (batch 1): ms a forward from differenced chains of CHAIN_LEN
    and LONG_FACTOR x CHAIN_LEN data-dependent forwards
    (utils/timing.differenced_chain_ms); lower wins. The chains run
    eagerly, call after call, as `serve` runs a lone request, so a
    candidate's ms holds the host's launch work that batch 1 pays on the
    card, not only its device time. A NaN (a failed measurement) is never
    crowned.
The names are the port's: "plain" is the JAX package's "xla", "dw" its
"pallas".
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v1 import DW_BACKENDS
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config
from ..utils.timing import differenced_chain_ms, fenced_window
from .pipeline import resolve_device

# The latency chains' lengths: CHAIN_LEN and LONG_FACTOR x CHAIN_LEN forwards.
CHAIN_LEN = 50
LONG_FACTOR = 4


def _family(config) -> str:
    if isinstance(config, V2Config):
        return "v2"
    if isinstance(config, V3Config):
        return "v3"
    if isinstance(config, ModelConfig):
        return "v1"
    raise TypeError(f"config must be a ModelConfig, a V2Config or a V3Config, got {config!r}")


def default_candidates(family: str, int8: bool, mode: str, on_card: bool) -> Tuple[str, ...]:
    """The routes worth racing: on the card the JAX package's on-TPU sets
    with its names mapped (V1 float: every backend and "mixed"; V1 int8:
    plain, fused, mixed; V2 and V3 float at batch 1: plain, fused, mixed;
    else plain, fused); off the card "plain" alone, whose kernels' plain
    versions are the only other thing the CPU could time."""
    if not on_card:
        return ("plain",)
    if family == "v1":
        return ("plain", "fused", "mixed") if int8 else DW_BACKENDS + ("mixed",)
    if not int8 and mode == "latency":
        return ("plain", "fused", "mixed")
    return ("plain", "fused")


def _quantized(config, family: str, params, seed: int):
    """The V2 / V3 int8 constants, calibrated once for every candidate (they
    do not depend on the route)."""
    from ..checkpoints import default_folded  # noqa: PLC0415

    folded = params if params is not None else default_folded(config, seed=seed)
    if family == "v2":
        from ..quant.v2 import quantize_v2  # noqa: PLC0415

        return quantize_v2(folded, config)
    from ..quant.v3 import quantize_v3  # noqa: PLC0415

    return quantize_v3(folded, config)


def _pipeline(config, family: str, cand: str, *, device, seed: int, params, int8: bool,
              quantized):
    """The pipeline that serves `cand`: the float InferencePipeline or the
    family's int8 pipeline, built with that dw_backend."""
    if not int8:
        from .pipeline import InferencePipeline  # noqa: PLC0415

        return InferencePipeline(config, params, device=device, seed=seed, dw_backend=cand)
    if family == "v1":
        from ..quant.model import Int8Pipeline  # noqa: PLC0415

        return Int8Pipeline(config, params, device=device, seed=seed, dw_backend=cand)
    if family == "v2":
        from ..quant.v2 import Int8PipelineV2  # noqa: PLC0415

        return Int8PipelineV2(config, device=device, dw_backend=cand, quantized=quantized)
    from ..quant.v3 import Int8PipelineV3  # noqa: PLC0415

    return Int8PipelineV3(config, device=device, dw_backend=cand, quantized=quantized)


def _images(pipe, batch: int) -> torch.Tensor:
    res = pipe.config.resolution
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, res, res, 3), dtype=np.uint8)).to(pipe.device)


def _throughput(pipe, batch_size: int, steps: int) -> float:
    """img/s of the "probs_u8" entry on one device-resident uint8 batch: a
    warm call, then `fenced_window` (1.5 s at least on the card)."""
    entry, img = pipe._entry("probs_u8"), _images(pipe, batch_size)

    def run():
        return entry(img)

    def sync(out):
        return out[0, :4].cpu()  # the fence: a few bytes of the last output back

    sync(run())  # the first call builds the kernels and sets up the libraries
    dt, n = fenced_window(run, sync, steps)
    return n * batch_size / dt


def _float_latency_ms(pipe) -> float:
    """Batch-1 ms a forward of the float path: chains of x <- x * (1 + 1e-6 *
    sum(probs)) on a preprocessed input in [-1, 1] (the "probs_f" entry)."""
    entry, res = pipe._entry("probs_f"), pipe.config.resolution
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, res, res, 3)).astype(np.float32)).to(pipe.device, pipe.dtype)

    def make(length):
        def chain(x):
            for _ in range(length):
                probs = entry(x)
                x = x * (1.0 + 1e-6 * probs.sum().to(x.dtype))
            return x, probs.argmax()

        return chain

    return differenced_chain_ms(make, x0, CHAIN_LEN, long_factor=LONG_FACTOR)


def _int8_latency_ms(pipe) -> float:
    """Batch-1 ms a forward of an int8 path from uint8 in (preprocess and the
    input quantization included: the "probs_u8" entry): chains of u8 <-
    clip(u8 + argmax % 2, 0, 255), saturated in int32."""
    entry = pipe._entry("probs_u8")

    def make(length):
        def chain(u8):
            for _ in range(length):
                cls = entry(u8).argmax()
                u8 = (u8.to(torch.int32) + cls % 2).clamp_(0, 255).to(torch.uint8)
            return u8, cls

        return chain

    return differenced_chain_ms(make, _images(pipe, 1), CHAIN_LEN, long_factor=LONG_FACTOR)


def _measure(cand: str, pipe, mode: str, batch_size: int, steps: int, int8: bool) -> float:
    """One candidate's value on its own pipeline: img/s (throughput) or ms a
    forward (latency)."""
    if mode == "throughput":
        return _throughput(pipe, batch_size, steps)
    return _int8_latency_ms(pipe) if int8 else _float_latency_ms(pipe)


@torch.inference_mode()
def autotune_backend(config, batch_size: int = 256, steps: int = 10,
                     candidates: Optional[Sequence[str]] = None, seed: int = 0, params=None,
                     int8: bool = False, mode: Optional[str] = None,
                     device="cuda") -> Tuple[Optional[str], Dict[str, float]]:
    """Measure every candidate route end to end; return (best, {name: value}).

    config: a ModelConfig (V1), V2Config or V3Config. params: a folded host
    tree, else the seeded weight set (`seed`). mode: "throughput" (img/s,
    higher wins) or "latency" (ms, lower wins); default latency at batch_size
    1. candidates: default `default_candidates` for the device. best is None
    when no candidate gave a finite value."""
    dev = resolve_device(device)
    family = _family(config)
    if mode is None:
        mode = "latency" if batch_size == 1 else "throughput"
    if mode not in ("throughput", "latency"):
        raise ValueError(f"mode {mode!r} is not 'throughput' or 'latency'")
    if candidates is None:
        candidates = default_candidates(family, int8, mode, dev.type == "cuda")
    quantized = _quantized(config, family, params, seed) if int8 and family != "v1" else None
    results: Dict[str, float] = {}
    for cand in candidates:
        pipe = _pipeline(config, family, cand, device=dev, seed=seed, params=params,
                         int8=int8, quantized=quantized)
        results[cand] = float(_measure(cand, pipe, mode, batch_size, steps, int8))
        del pipe
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    valid = {k: v for k, v in results.items() if np.isfinite(v)}
    if not valid:
        return None, results
    pick = min if mode == "latency" else max
    return pick(valid, key=valid.get), results
