#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mobilenet_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repo's `mobilenet_tpu_torch/` beside this
file; imports nothing of JAX. Phases, one JSON line each:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the three kernels from `mobilenet_tpu_torch/csrc/`;
  2. each kernel against its plain PyTorch version at the main-path shapes
     of MobileNet-V1 1.0-224: float32 at a tight tolerance (TF32 off), then
     bfloat16 at the working tolerance; max-abs error and CUDA-event times;
  3. the bf16 1.0-224 pipeline, kernel route against the plain route, at
     batch 256 and batch 1 (logits tolerance, top-1), and a float32
     full-network check at batch 2;
  4. benchmark(): batch-256 img/s and batch-1 latency, both routes;
  5. the main path: launch counters set to 0, a 64-stream MicroBatchServer
     built (it warm-runs buckets 1, 8 and 64), a selftest of every stream,
     one lone request (bucket 1); counters read; 0 errors and every kernel
     launched are required.
Then one JSON line of per-kernel results and, last, the result line.
Any failure raises and the script exits non-zero without the result line.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 kernel vs plain: the depthwise result is rounded to bf16 before the
# product and the output to bf16 after it; a last-bit difference in the f32
# sums (FMA contraction, summation order) can move either rounding by one
# bf16 step (2^-8 relative), so two steps at the value plus a floor.
BF16_ATOL, BF16_RTOL = 6e-2, 1.6e-2
# fp32 kernel vs plain: reassociation of f32 sums only (K <= 1024); the
# per-layer gate of the JAX package's golden harness (MM_TOL).
F32_ATOL, F32_RTOL = 1e-4, 3e-4
# Whole-network bf16 kernel route vs plain route (logits): the JAX package's
# routing gate, max(6e-2, 4.5e-2 x logits absmax).
ROUTE_ATOL, ROUTE_REL = 6e-2, 4.5e-2

ALPHA, RES = 1.0, 224


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - ref).abs()
    excess = float((diff - (atol + rtol * ref.abs())).max())
    max_abs = float(diff.max())
    if excess > 0:
        raise AssertionError(f"{name}: max_abs {max_abs:.3e} exceeds atol {atol} "
                             f"+ rtol {rtol} x |ref| by {excess:.3e}")
    return max_abs


def block_shapes(cfg, batch):
    """(name, N, H, Cin, Cout, stride, count) of each distinct main-path
    block shape, `count` = how many blocks of one forward have it."""
    shapes, hw, cin = {}, cfg.resolution // 2, cfg.stem_channels
    for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
        key = (hw, cin, cout, stride)
        if key in shapes:
            shapes[key][1] += 1
        else:
            shapes[key] = [f"b{i:02d}", 1]
        hw //= stride
        cin = cout
    return [(nm, batch, h, ci, co, s, cnt)
            for (h, ci, co, s), (nm, cnt) in shapes.items()]


def rand_block(gen, n, h, cin, cout, dtype, k=None):
    dev = "cuda"

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype).contiguous()

    x = (torch.rand(n, h, h, cin, generator=gen, device=dev) * 2 - 1).to(dtype).contiguous()
    if k is None:
        return (x, r(3, 3, 1, cin, scale=0.5), r(cin, scale=0.2),
                r(cin, cout, scale=1.0 / cin ** 0.5), r(cout, scale=0.2))
    return (x, r(k, 3, 3, cin, scale=0.5), r(k, cin, scale=0.2),
            r(k, cin, cin, scale=1.0 / cin ** 0.5), r(k, cin, scale=0.2))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from mobilenet_tpu_torch import InferencePipeline, ModelConfig
    from mobilenet_tpu_torch.models import mobilenet_v1
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.chain import chain, chain_plain
    from mobilenet_tpu_torch.ops.head import fused_head, fused_head_plain
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.separable_block import (
        separable_block, separable_block_plain,
    )
    from mobilenet_tpu_torch.runtime.serving import MicroBatchServer, selftest

    # -- 1. card, versions, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         build_s=build_s, nvcc_seconds=_build.build_seconds, ptxas=ptxas)

    # -- 2. kernels vs plain at main-path shapes --------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(ALPHA, RES, compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {
        "separable_block": {"route": "cuda",
                            "source": "mobilenet_tpu_torch/csrc/separable_block.cu",
                            "replaces": "mobilenet_tpu/ops/pallas_block.py:217",
                            "also_replaces": [
                                "mobilenet_tpu/ops/pallas_block_packed.py:132",
                                "mobilenet_tpu/ops/pallas_block_packed.py:371"]},
        "fused_head": {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/fused_head.cu",
                       "replaces": "mobilenet_tpu/ops/pallas_head.py:168"},
        "chain": {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/chain.cu",
                  "replaces": "mobilenet_tpu/ops/pallas_chain_systolic.py:120"},
    }
    for s in summary.values():
        s.update(max_abs_err=0.0, max_abs_err_f32=0.0, ms=0.0, plain_ms=0.0)

    def check(kname, shape_name, count, kfn, pfn, args_f32, args_bf16):
        row = {}
        for tag, args, atol, rtol in (("f32", args_f32, F32_ATOL, F32_RTOL),
                                      ("bf16", args_bf16, BF16_ATOL, BF16_RTOL)):
            got = kfn(*args)
            ref = pfn(*args)
            torch.cuda.synchronize()
            err = compare(f"{kname} {shape_name} {tag}", got, ref, atol, rtol)
            kms, pms = cuda_ms(lambda: kfn(*args)), cuda_ms(lambda: pfn(*args))
            row[tag] = {"max_abs_err": err, "ms": kms, "plain_ms": pms,
                        "atol": atol, "rtol": rtol}
            s = summary[kname]
            if tag == "bf16":
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s["ms"] += count * kms
                s["plain_ms"] += count * pms
            else:
                s["max_abs_err_f32"] = max(s["max_abs_err_f32"], err)
        emit("kernel", kernel=kname, shape=shape_name, count_per_forward=count, **row)

    for nm, n, h, cin, cout, stride, cnt in block_shapes(cfg, 256):
        mk = lambda dt: rand_block(gen, n, h, cin, cout, dt) + (stride, True)  # noqa: E731
        check("separable_block", f"{nm} ({n},{h},{h},{cin})->{cout} s{stride}", cnt,
              separable_block, separable_block_plain, mk(torch.float32), mk(torch.bfloat16))
        torch.cuda.empty_cache()
    hw, c = cfg.final_spatial, cfg.feature_channels
    for n in (256, 1):
        def mk_head(dt):
            x = (torch.rand(n, hw, hw, c, generator=gen, device="cuda") * 6).to(dt)
            w = (torch.randn(c, cfg.num_classes, generator=gen, device="cuda")
                 / c ** 0.5).to(dt)
            b = (torch.randn(cfg.num_classes, generator=gen, device="cuda") * 0.1).to(dt)
            return x, w, b
        check("fused_head", f"({n},{hw},{hw},{c})->{cfg.num_classes}", int(n == 256),
              lambda x, w, b: fused_head(x, None, [(w, b, "linear")]),
              fused_head_plain, mk_head(torch.float32), mk_head(torch.bfloat16))
    hc, cc = RES // 16, cfg.block_channels[6]
    mkc = lambda dt: rand_block(gen, 1, hc, cc, cc, dt, k=5) + (True,)  # noqa: E731
    check("chain", f"(1,{hc},{hc},{cc}) x5", 1, chain, chain_plain,
          mkc(torch.float32), mkc(torch.bfloat16))

    # -- 3. pipeline: kernel route vs plain route ---------------------------------
    pipe = InferencePipeline(cfg, device="cuda")
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x = preprocess(imgs, RES, torch.bfloat16)
            got = mobilenet_v1.forward(pipe.params, x, cfg, dw_backend="auto").float()
            ref = mobilenet_v1.forward(pipe.params, x, cfg, dw_backend="plain").float()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            atol = max(ROUTE_ATOL, ROUTE_REL * scale)
            err = compare(f"pipeline bf16 batch {batch}", got, ref, atol, 0.0)
            top_k, top_p = got.argmax(-1), ref.argmax(-1)
            flips = (top_k != top_p).nonzero().flatten().tolist()
            for i in flips:  # a flip is allowed only between near-tied classes
                gap = float(ref[i, top_p[i]] - ref[i, top_k[i]])
                if gap > atol:
                    raise AssertionError(f"batch {batch} row {i}: top-1 {int(top_k[i])} "
                                         f"vs plain {int(top_p[i])}, gap {gap:.3e}")
            emit("pipeline", dtype="bfloat16", batch=batch, max_abs_err=err,
                 atol=atol, logits_absmax=scale, top1_agree=batch - len(flips),
                 rows=batch)
        cfg32 = ModelConfig(ALPHA, RES, compute_dtype="float32")
        pipe32 = InferencePipeline(cfg32, device="cuda")
        x32 = torch.from_numpy(
            rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)).cuda()
        got = mobilenet_v1.forward(pipe32.params, x32, cfg32, dw_backend="auto")
        ref = mobilenet_v1.forward(pipe32.params, x32, cfg32, dw_backend="plain")
        err = compare("pipeline f32 batch 2", got, ref, F32_ATOL, F32_RTOL)
        if not torch.equal(got.argmax(-1), ref.argmax(-1)):
            raise AssertionError("pipeline f32: top-1 differs from the plain route")
        emit("pipeline", dtype="float32", batch=2, max_abs_err=err,
             atol=F32_ATOL, rtol=F32_RTOL, top1_agree=2, rows=2)
        del pipe32
    torch.cuda.empty_cache()

    # -- 4. benchmark ----------------------------------------------------------
    bench = pipe.benchmark(batch_size=256, steps=40)
    emit("benchmark", route="auto", nvidia_smi=smi, **bench)
    plain = InferencePipeline(cfg, device="cuda", dw_backend="plain")
    emit("benchmark", route="plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=10))
    del plain
    torch.cuda.empty_cache()

    # -- 5. the main path: 64-stream server -------------------------------------
    kernels = {"separable_block": separable_block, "fused_head": fused_head,
               "chain": chain}
    for k in kernels.values():
        k.launches = 0

    async def serve():
        server = MicroBatchServer(pipe, max_batch=64)
        await server.start()
        try:
            stats = await selftest(server, streams=64, requests_per_stream=4)
            frame = np.random.default_rng(1).integers(0, 256, (RES, RES, 3), np.uint8)
            before = server.stats.bucket_counts.get(1, 0)
            top = await server.submit(frame)
            stats["lone_request_bucket1"] = server.stats.bucket_counts.get(1, 0) - before
            stats["lone_request_top1"] = top[0][0]
            stats["errors_final"] = server.stats.errors
            return stats
        finally:
            await server.close()

    stats = asyncio.run(serve())
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    emit("serving", nvidia_smi=smi, launches=launches, **stats)
    if stats["errors_final"] != 0:
        raise AssertionError(f"serving: {stats['errors_final']} errors")
    if stats["lone_request_bucket1"] != 1:
        raise AssertionError("serving: the lone request did not run in bucket 1")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"serving: kernel {k} was not launched on the main path")

    print(json.dumps({"kernels": [
        {"name": k, **summary[k], "launches": launches[k]} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
