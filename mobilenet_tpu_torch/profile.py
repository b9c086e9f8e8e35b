"""Where the device time of one pipeline forward goes, by kernel name.

    python -m mobilenet_tpu_torch.profile [--model v1|v2|v3|v3small] [--int8] \\
        [--fuse-stem] [--chain] [--batch 256 1] [--steps 10] [--benchmark] \\
        [--latency N]

Builds the 1.0-224 pipeline of MobileNet-V1, -V2 (--model v2), -V3-Large
(--model v3) or -V3-Small (--model v3small), bf16 or exact int8 (--int8),
V1 bf16 with the fused normalize + stem + block-0 kernel (--fuse-stem),
V3 bf16 with the chain kernel's greedy runs (--chain: the variant's chain
knob on), on the card, warms it on one device-resident uint8 batch, then records
`--steps` forwards under torch.profiler (CPU + CUDA).
Prints one JSON line: the window's wall time (CUDA events), the device
busy time (the sum of the device activities' durations: one stream, so they
do not overlap), the idle share, and the device time per kernel name, most
first. With --benchmark, then one more line: the pipeline's `benchmark()`
at batch 256 (img/s and the batch-1 latency). With --latency N, then one
more line: N batch-1 calls timed as `benchmark()` times its 30 (host uint8
to host probabilities, host clock), their p50, p90 and p99, and the p50 of
each fifth of the calls in order (the spread within the run). It calls only
the pipelines' public entries, so this file copied into an archive of an
earlier commit measures that commit in the same call. Refuses to run
without a card.
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch


def profile(pipe, batch: int, steps: int, top: int = 12):
    res = pipe.config.resolution
    entry = pipe._entry("probs_u8")
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, res, res, 3), dtype=np.uint8)).to(pipe.device)
    with torch.inference_mode():
        for _ in range(3):
            entry(images)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            for _ in range(steps):
                entry(images)
            end.record()
            end.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    return {
        "device": torch.cuda.get_device_name(pipe.device), "batch": batch, "steps": steps,
        "wall_ms_per_forward": wall_ms / steps, "busy_ms_per_forward": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_ms_per_forward": {k[:80]: v / steps for k, v in by_name.most_common(top)},
    }


@torch.inference_mode()
def latency(pipe, iters: int, warmup: int = 20) -> dict:
    """Batch-1 latency as `benchmark()` takes it, over `iters` calls."""
    import time  # noqa: PLC0415

    res = pipe.config.resolution
    one = np.random.default_rng(0).integers(0, 256, (1, res, res, 3), dtype=np.uint8)
    for _ in range(warmup):
        pipe.run_batch(one)
    lats = []
    for _ in range(iters):
        t = time.perf_counter()
        pipe.run_batch(one)
        lats.append((time.perf_counter() - t) * 1e3)
    fifths = np.array_split(np.array(lats), 5)
    return {"iters": iters, "p50_ms": float(np.percentile(lats, 50)),
            "p90_ms": float(np.percentile(lats, 90)), "p99_ms": float(np.percentile(lats, 99)),
            "p50_by_fifth_ms": [float(np.percentile(f, 50)) for f in fifths]}


def main(argv=None):
    from . import (  # noqa: PLC0415
        InferencePipeline, Int8Pipeline, Int8PipelineV2, Int8PipelineV3,
    )
    from .runtime.serving import make_config  # noqa: PLC0415

    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch.profile")
    p.add_argument("--model", default="v1", choices=["v1", "v2", "v3", "v3small"])
    p.add_argument("--int8", action="store_true", help="the model's exact int8 path")
    p.add_argument("--fuse-stem", action="store_true",
                   help="V1 float: InferencePipeline(fuse_stem=True)")
    p.add_argument("--chain", action="store_true",
                   help="V3 float: the variant's chain knob on (greedy runs)")
    p.add_argument("--batch", type=int, nargs="+", default=[256, 1])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--benchmark", action="store_true",
                   help="then the pipeline's benchmark() at batch 256")
    p.add_argument("--latency", type=int, default=0, metavar="N",
                   help="then N batch-1 calls' latency (host uint8 to host probabilities)")
    args = p.parse_args(argv)
    if args.fuse_stem and (args.int8 or args.model != "v1"):
        p.error("--fuse-stem is the V1 float path's option")
    if args.chain and (args.int8 or args.model not in ("v3", "v3small")):
        p.error("--chain is the V3 float paths' option")
    if not torch.cuda.is_available():
        raise SystemExit("mobilenet_tpu_torch.profile measures the card; "
                         "torch.cuda.is_available() is False")
    cfg = make_config(args.model, 1.0, 224, "bfloat16")
    if args.int8:
        pipe = {"v1": Int8Pipeline, "v2": Int8PipelineV2, "v3": Int8PipelineV3,
                "v3small": Int8PipelineV3}[args.model](cfg, device="cuda")
    else:
        pipe = InferencePipeline(cfg, device="cuda", fuse_stem=args.fuse_stem)
    if args.chain:
        from .models import mobilenet_v3  # noqa: PLC0415

        setattr(mobilenet_v3, "CHAIN_V3_SMALL" if args.model == "v3small" else "CHAIN_V3", True)
    path = "int8" if args.int8 else "bfloat16" + (" fuse_stem" if args.fuse_stem else "")
    path += " chain" if args.chain else ""
    for batch in args.batch:
        print(json.dumps({"model": args.model, "path": path,
                          **profile(pipe, batch, args.steps)}), flush=True)
    if args.benchmark:
        print(json.dumps({"model": args.model, "path": path,
                          "benchmark": pipe.benchmark(batch_size=256, steps=40)}), flush=True)
    if args.latency:
        print(json.dumps({"model": args.model, "path": path,
                          "latency": latency(pipe, args.latency)}), flush=True)


if __name__ == "__main__":
    main()
