"""Multi-stream serving: concurrent image streams -> micro-batcher -> device.

The port of the JAX package's `runtime/serving.py` on one device, one or
several variants of MobileNet-V1, -V2, -V3-Large or -V3-Small (or either V3
-minimalistic), float or exact int8:
  - each stream is an asyncio producer; requests land in one queue;
  - the micro-batcher drains up to `max_batch` requests (or waits at most
    `max_delay_ms`), pads to the smallest precomputed bucket that fits, and
    runs the batch on one executor thread (one device stream);
  - a bad request fails its own future, never the server; device errors
    that may pass (out of memory) are retried with backoff.
Also: a newline-delimited-JSON TCP front end (`serve_tcp`), an in-process
load test (`selftest`) that reports img/s and p50/p99, and
`MultiVariantServer`, several variants served from one process (a request
names its variant), with its mixed-load test `selftest_multi`.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config


def _is_retryable_device_error(e: BaseException) -> bool:
    """Only device/runtime failures are worth retrying; deterministic errors
    (shape/value errors raised by the pipeline) fail fast. PyTorch raises
    torch.cuda.OutOfMemoryError for a failed allocation and a RuntimeError
    naming the CUDA error for a failed launch or device fault."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    retries: int = 0
    batch_fill: float = 0.0
    # batch-bucket size -> number of dispatches routed to it
    bucket_counts: Dict[int, int] = dataclasses.field(default_factory=dict)

    def reset_window(self):
        """Zero the per-window counters (requests, batches, fill, buckets)
        so a load probe reports per-phase stats; the error and retry counts
        are kept."""
        self.requests = 0
        self.batches = 0
        self.batch_fill = 0.0
        self.bucket_counts.clear()


def default_buckets(max_batch: int) -> List[int]:
    """The serving batch tiers of a `max_batch`-stream server:
    {1, max_batch//8, max_batch}. Shared by MicroBatchServer and `cli
    warmup`, so what warmup runs is what serving dispatches."""
    return sorted({1, max(1, max_batch // 8), max_batch})


class MicroBatchServer:
    """Micro-batching inference server over an InferencePipeline, an
    Int8Pipeline or an Int8PipelineV2."""

    def __init__(self, pipeline, max_batch: int = 64, max_delay_ms: float = 3.0,
                 request_timeout_s: float = 30.0, device_retries: int = 1,
                 retry_backoff_s: float = 0.5,
                 batch_buckets: Optional[List[int]] = None):
        """`device_retries`: how many times a failed device dispatch is
        retried (only `_is_retryable_device_error` types), with backoff
        retry_backoff_s * 2**attempt. `batch_buckets`: fixed batch sizes;
        each dispatch pads to the smallest that fits. Default
        default_buckets(max_batch); the largest must equal max_batch. Every
        bucket runs once at construction, so first requests find the kernels
        built and the allocator warm."""
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.request_timeout_s = request_timeout_s
        self.device_retries = device_retries
        self.retry_backoff_s = retry_backoff_s
        self.queue: asyncio.Queue = asyncio.Queue()
        self.stats = ServerStats()
        self._executor = ThreadPoolExecutor(max_workers=1)  # one device stream
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        res = pipeline.config.resolution
        if batch_buckets is None:
            batch_buckets = default_buckets(max_batch)
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[-1] != max_batch or buckets[0] < 1:
            raise ValueError(
                f"batch_buckets {buckets} must be >=1 and end at "
                f"max_batch={max_batch} (a full drain must fit a bucket)")
        self.batch_buckets = buckets
        self._pad_templates = {
            b: np.zeros((b, res, res, 3), np.uint8) for b in buckets
        }
        for b in buckets:
            self.pipeline.run_batch(self._pad_templates[b])

    def stats_dict(self) -> Dict[str, Any]:
        """Live counters for the TCP `{"cmd": "stats"}` probe."""
        s = self.stats
        return {
            "requests": s.requests,
            "batches": s.batches,
            "errors": s.errors,
            "retries": s.retries,
            "mean_batch_fill": s.batch_fill / max(s.batches, 1),
            "bucket_counts": {str(k): v for k, v in sorted(s.bucket_counts.items())},
            "buckets": list(self.batch_buckets),
        }

    async def start(self):
        self._task = asyncio.create_task(self._batcher_loop())

    async def close(self):
        self._closed = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._executor.shutdown(wait=True)

    async def submit(self, image_u8: np.ndarray, top_k: int = 5):
        """One request from one stream. Returns top-k [(class, prob)]."""
        if image_u8.ndim != 3 or image_u8.shape[-1] != 3:
            raise ValueError(f"expected HWC RGB image, got {image_u8.shape}")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self.queue.put((image_u8, top_k, fut))
        return await asyncio.wait_for(fut, timeout=self.request_timeout_s)

    async def _batcher_loop(self):
        loop = asyncio.get_running_loop()
        while not self._closed:
            first = await self.queue.get()
            batch = [first]
            deadline = loop.time() + self.max_delay_ms / 1e3
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            await self._run_batch(loop, batch)

    async def _run_batch(self, loop, batch: List[Any]):
        res = self.pipeline.config.resolution
        bucket = next(b for b in self.batch_buckets if b >= len(batch))
        images = self._pad_templates[bucket].copy()
        valid: List[int] = []
        for i, (img, _, fut) in enumerate(batch):
            if img.shape[:2] != (res, res):  # per-stream error isolation
                self.stats.errors += 1
                if not fut.done():
                    fut.set_exception(ValueError(
                        f"image must be pre-sized to {res}x{res} (host decode path)"))
                continue
            images[i] = img
            valid.append(i)

        def run():
            return self.pipeline.run_batch(images)

        try:
            for attempt in range(self.device_retries + 1):
                try:
                    probs = await loop.run_in_executor(self._executor, run)
                    break
                except Exception as e:
                    if (attempt == self.device_retries
                            or not _is_retryable_device_error(e)):
                        raise
                    self.stats.retries += 1
                    await asyncio.sleep(self.retry_backoff_s * 2 ** attempt)
        except Exception as e:  # the batch fails; the server keeps serving
            for i in valid:
                fut = batch[i][2]
                if not fut.done():
                    fut.set_exception(e)
            self.stats.errors += len(valid)
            return
        self.stats.batches += 1
        self.stats.requests += len(valid)
        self.stats.batch_fill += len(batch) / self.max_batch
        self.stats.bucket_counts[bucket] = self.stats.bucket_counts.get(bucket, 0) + 1
        for i in valid:
            _, top_k, fut = batch[i]
            p = probs[i]
            idx = np.argsort(-p)[:top_k]
            if not fut.done():
                fut.set_result([(int(j), float(p[j])) for j in idx])


# ---------------------------------------------------------------------------
# TCP front end: newline-delimited JSON requests
#   {"id": any, "shape": [H,W,3], "image_b64": <raw uint8 bytes>}
# response: {"id": any, "top": [[class, prob], ...]} or {"id":..., "error":...}
# ---------------------------------------------------------------------------


async def make_tcp_server(server, host: str, port: int):
    """Bind the NDJSON front end of a MicroBatchServer or a
    MultiVariantServer; port=0 binds an ephemeral port. A request may name
    its variant in an optional "variant" field. Returns the asyncio.Server
    (caller drives serve_forever / close)."""

    async def handle(reader, writer):
        while True:
            line = await reader.readline()
            if not line:
                break
            req = None
            try:
                req = json.loads(line)
                if req.get("cmd") == "stats":
                    writer.write((json.dumps(
                        {"id": req.get("id"), "stats": server.stats_dict()}
                    ) + "\n").encode())
                    await writer.drain()
                    continue
                img = np.frombuffer(
                    base64.b64decode(req["image_b64"]), np.uint8
                ).reshape(req["shape"])
                kw = {}
                if req.get("variant") is not None:
                    # only MultiVariantServer takes it; a single-variant
                    # server's TypeError is echoed as this request's error
                    kw["variant"] = req["variant"]
                top = await server.submit(img, **kw)
                resp = {"id": req.get("id"), "top": top}
            except Exception as e:  # echo the failure to this client only
                rid = req.get("id") if isinstance(req, dict) else None
                resp = {"id": rid, "error": str(e)}
            writer.write((json.dumps(resp) + "\n").encode())
            await writer.drain()
        writer.close()

    # One 224x224 uint8 frame in base64 + JSON is ~200 KB: above asyncio's
    # default 64 KiB line limit.
    return await asyncio.start_server(handle, host, port, limit=32 * 1024 * 1024)


async def serve_tcp(server, host: str, port: int):
    srv = await make_tcp_server(server, host, port)
    async with srv:
        await srv.serve_forever()


# ---------------------------------------------------------------------------
# In-process multi-stream load test
# ---------------------------------------------------------------------------


async def selftest(server: MicroBatchServer, streams: int = 64,
                   requests_per_stream: int = 8) -> Dict[str, Any]:
    res = server.pipeline.config.resolution
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, res, res, 3), dtype=np.uint8)
    latencies: List[float] = []

    async def one_stream(sid: int):
        for k in range(requests_per_stream):
            t0 = time.perf_counter()
            await server.submit(frames[(sid + k) % len(frames)])
            latencies.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    await asyncio.gather(*(one_stream(s) for s in range(streams)))
    wall = time.perf_counter() - t0
    n = streams * requests_per_stream
    return {
        "streams": streams,
        "requests": n,
        "images_per_sec": n / wall,
        "p50_latency_ms": float(np.percentile(latencies, 50) * 1e3),
        "p99_latency_ms": float(np.percentile(latencies, 99) * 1e3),
        "mean_batch_fill": server.stats.batch_fill / max(server.stats.batches, 1),
        "bucket_counts": {str(k): v for k, v
                          in sorted(server.stats.bucket_counts.items())},
        "errors": server.stats.errors,
    }


class MultiVariantServer:
    """Several variants served from one process on one device: each keeps
    its own MicroBatchServer (buckets, batcher, stats), and a request picks
    one with `variant=`, else the default (the first)."""

    def __init__(self, servers: Dict[str, MicroBatchServer], default: Optional[str] = None):
        if not servers:
            raise ValueError("MultiVariantServer needs at least one variant")
        self.servers = dict(servers)
        self.default = default or next(iter(self.servers))
        if self.default not in self.servers:
            raise ValueError(f"default variant {self.default!r} not among "
                             f"{sorted(self.servers)}")

    async def start(self):
        for s in self.servers.values():
            await s.start()

    async def close(self):
        for s in self.servers.values():
            await s.close()

    async def submit(self, image_u8: np.ndarray, top_k: int = 5,
                     variant: Optional[str] = None):
        """One request, routed by `variant`; an unknown name fails this
        request only (ValueError)."""
        name = variant or self.default
        try:
            server = self.servers[name]
        except KeyError:
            raise ValueError(f"unknown variant {name!r}; serving "
                             f"{sorted(self.servers)}") from None
        return await server.submit(image_u8, top_k=top_k)

    def stats_dict(self) -> Dict[str, Any]:
        return {"default": self.default,
                "variants": {n: s.stats_dict() for n, s in self.servers.items()}}


async def selftest_multi(server: MultiVariantServer, streams: int = 64,
                         requests_per_stream: int = 8) -> Dict[str, Any]:
    """Mixed load across every served variant: stream s pins to variant
    s % n_variants and every stream is in flight at once, so the device
    interleaves batches of different configs. Reports aggregate img/s and
    per-variant p50/p99."""
    names = sorted(server.servers)
    rng = np.random.default_rng(0)
    frames = {
        n: rng.integers(0, 256, (8, s.pipeline.config.resolution,
                                 s.pipeline.config.resolution, 3), dtype=np.uint8)
        for n, s in server.servers.items()
    }
    lat: Dict[str, List[float]] = {n: [] for n in names}
    errors_before = sum(s.stats.errors for s in server.servers.values())

    async def one_stream(sid: int):
        name = names[sid % len(names)]
        for k in range(requests_per_stream):
            t0 = time.perf_counter()
            await server.submit(frames[name][(sid + k) % 8], variant=name)
            lat[name].append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    await asyncio.gather(*(one_stream(s) for s in range(streams)))
    wall = time.perf_counter() - t0
    n = streams * requests_per_stream
    return {
        "mode": "mixed-variants",
        "streams": streams,
        "requests": n,
        "images_per_sec": n / wall,
        "per_variant_p50_ms": {name: float(np.percentile(v, 50) * 1e3)
                               for name, v in lat.items() if v},
        "per_variant_p99_ms": {name: float(np.percentile(v, 99) * 1e3)
                               for name, v in lat.items() if v},
        "errors": sum(s.stats.errors for s in server.servers.values()) - errors_before,
    }


MODELS = ("v1", "v2", "v3", "v3small")


def make_config(model: str, alpha: float, res: int, dtype: str = "bfloat16",
                minimalistic: bool = False):
    """ModelConfig (model "v1"), V2Config ("v2") or V3Config ("v3":
    MobileNet-V3-Large, "v3small": MobileNet-V3-Small; -minimalistic with
    `minimalistic`) of one variant."""
    if minimalistic and model not in ("v3", "v3small"):
        raise ValueError(f"minimalistic is a MobileNet-V3 variant, not {model!r}")
    if model in ("v3", "v3small"):
        return V3Config(variant="large" if model == "v3" else "small", alpha=float(alpha),
                        resolution=int(res), minimalistic=minimalistic, compute_dtype=dtype)
    if model == "v2":
        return V2Config(alpha=float(alpha), resolution=int(res), compute_dtype=dtype)
    if model == "v1":
        return ModelConfig(alpha=float(alpha), resolution=int(res), compute_dtype=dtype)
    raise ValueError(f"model {model!r} not in {MODELS}")


def config_from_variant(spec: str, dtype: str = "bfloat16", minimalistic: bool = False):
    """The JAX package's variant string: "alpha:res" (V1) or
    "model:alpha:res", e.g. "v2:1.0:224", "v3:1.0:224" or "v3small:1.0:224".
    `minimalistic` applies to the V3 families only, as in the JAX package."""
    parts = spec.split(":")
    if len(parts) == 2:
        parts = ["v1", *parts]
    if len(parts) != 3:
        raise ValueError(f"variant {spec!r} is not 'alpha:res' or 'model:alpha:res'")
    return make_config(parts[0], float(parts[1]), int(parts[2]), dtype,
                       minimalistic and parts[0] in ("v3", "v3small"))


def build_pipeline(cfg, *, device="cuda", seed: int = 0, params=None, int8: bool = False):
    """The float InferencePipeline of a ModelConfig, a V2Config or a
    V3Config, or with int8=True the quantized Int8Pipeline (V1),
    Int8PipelineV2 (V2) or Int8PipelineV3 (V3-Large and V3-Small; both
    calibrated here). `params`: a folded host tree, else the seeded set."""
    if int8 and isinstance(cfg, V3Config):
        from ..quant.v3 import Int8PipelineV3  # noqa: PLC0415

        return Int8PipelineV3(cfg, params, device=device, seed=seed)
    if int8 and isinstance(cfg, V2Config):
        from ..quant.v2 import Int8PipelineV2  # noqa: PLC0415

        return Int8PipelineV2(cfg, params, device=device, seed=seed)
    if int8:
        from ..quant.model import Int8Pipeline  # noqa: PLC0415

        return Int8Pipeline(cfg, params, device=device, seed=seed)
    from .pipeline import InferencePipeline  # noqa: PLC0415

    return InferencePipeline(cfg, params, device=device, seed=seed)


def build_server(cfgs: Dict[str, Any], streams: int, *, device="cuda", seed: int = 0,
                 params=None, int8: bool = False, multi: bool = False):
    """The serving object of `cfgs` ({variant_name: config}), each variant a
    `streams`-wide MicroBatchServer over `build_pipeline`'s pipeline on one
    device. multi=True (any --variants deployment, a single entry too)
    wraps them in MultiVariantServer, whose clients name variants in
    requests. Returns (server, {name: MicroBatchServer})."""
    servers = {
        name: MicroBatchServer(build_pipeline(c, device=device, seed=seed, params=params,
                                              int8=int8), max_batch=streams)
        for name, c in cfgs.items()
    }
    if multi:
        return MultiVariantServer(servers), servers
    if len(servers) != 1:
        raise ValueError("multiple configs require multi=True")
    return next(iter(servers.values())), servers


def serve_main(alpha: float, res: int, dtype: str, streams: int, port: int, *,
               device="cuda", seed: int = 0, selftest_only: bool = True, params=None,
               int8: bool = False, model: str = "v1", minimalistic: bool = False,
               variants=None):
    """Build the server, run a selftest per variant (one JSON line of stats
    each) and, with several variants, `selftest_multi` under mixed load;
    then, if not selftest_only, serve NDJSON over TCP on `port` until
    killed. `model` is "v1", "v2", "v3" (V3-Large) or "v3small" (V3-Small),
    -minimalistic with `minimalistic`; `dtype` is the float path's compute
    dtype; int8=True serves the model's exact int8 path. `variants`: a list
    of "alpha:res" or "model:alpha:res" strings served from one process
    (MultiVariantServer; the first is the default; `alpha`, `res` and
    `model` are then unused); `params` (--ckpt) is refused with it."""
    if variants:
        if params is not None:
            raise ValueError("--ckpt applies to a single variant; multi-variant serving "
                             "uses each variant's default weight set")
        cfgs = {c.variant_name(): c for c in
                (config_from_variant(v, dtype, minimalistic) for v in variants)}
    else:
        cfg = make_config(model, alpha, res, dtype, minimalistic)
        cfgs = {cfg.variant_name(): cfg}

    async def run():
        server, servers = build_server(cfgs, streams, device=device, seed=seed,
                                       params=params, int8=int8, multi=bool(variants))
        await server.start()
        try:
            for name, sub in servers.items():
                stats = await selftest(sub, streams=max(1, streams // len(servers)))
                if variants:
                    stats["variant"] = name
                print(json.dumps(stats), flush=True)
            if variants and len(servers) > 1:
                # every variant under concurrent load from one process (the
                # per-variant selftests above ran one after another)
                for sub in servers.values():
                    sub.stats.reset_window()
                print(json.dumps(await selftest_multi(server, streams=streams)), flush=True)
            if not selftest_only:
                print(f"serving on tcp://0.0.0.0:{port} (variants: {sorted(cfgs)}"
                      f"{', int8' if int8 else ''})", flush=True)
                await serve_tcp(server, "0.0.0.0", port)
        finally:
            await server.close()

    asyncio.run(run())
