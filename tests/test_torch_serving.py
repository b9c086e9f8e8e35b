"""The port's serving runtime on the CPU at 0.25-128: the micro-batching
server answers concurrent and lone requests with the JAX pipeline's top-1,
isolates a bad request, and serves NDJSON over TCP on localhost."""

import asyncio
import base64
import json

import numpy as np
import pytest
import torch

from mobilenet_tpu import ModelConfig as JaxConfig
from mobilenet_tpu.runtime.pipeline import InferencePipeline as JaxPipeline
from mobilenet_tpu_torch import InferencePipeline, ModelConfig
from mobilenet_tpu_torch.runtime.serving import (
    MicroBatchServer, _is_retryable_device_error, default_buckets,
    make_tcp_server, selftest,
)

RES = 128


@pytest.fixture(scope="module")
def pipe():
    return InferencePipeline(ModelConfig(0.25, RES), device="cpu", seed=0)


def test_requests_match_jax_pipeline(pipe):
    frames = np.random.default_rng(0).integers(0, 256, (8, RES, RES, 3), np.uint8)
    jax_top1 = JaxPipeline(JaxConfig(0.25, RES), seed=0).run_batch(frames).argmax(-1)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8)
        await server.start()
        try:
            stats = await selftest(server, streams=8, requests_per_stream=2)
            burst = await asyncio.gather(*(server.submit(f) for f in frames))
            lone = await server.submit(frames[3])
            return stats, burst, lone, server.stats_dict()
        finally:
            await server.close()

    stats, burst, lone, live = asyncio.run(run())
    assert stats["errors"] == 0 and stats["requests"] == 16
    assert [top[0][0] for top in burst] == jax_top1.tolist()
    assert lone[0][0] == jax_top1[3]
    assert live["errors"] == 0 and live["buckets"] == [1, 8]
    assert live["bucket_counts"]["1"] >= 1


def test_bad_request_isolated(pipe):
    async def run():
        server = MicroBatchServer(pipe, max_batch=8)
        await server.start()
        try:
            good = np.zeros((RES, RES, 3), np.uint8)
            bad = np.zeros((RES // 2, RES // 2, 3), np.uint8)
            res = await asyncio.gather(server.submit(good), server.submit(bad),
                                       return_exceptions=True)
            return res, server.stats.errors
        finally:
            await server.close()

    (ok, err), errors = asyncio.run(run())
    assert isinstance(ok, list) and isinstance(err, ValueError) and errors == 1


def test_tcp_roundtrip(pipe):
    frame = np.random.default_rng(1).integers(0, 256, (RES, RES, 3), np.uint8)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8)
        await server.start()
        srv = await make_tcp_server(server, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            req = {"id": 7, "shape": list(frame.shape),
                   "image_b64": base64.b64encode(frame.tobytes()).decode()}
            writer.write((json.dumps(req) + "\n").encode())
            writer.write(b'{"id": 8, "cmd": "stats"}\n')
            await writer.drain()
            r1 = json.loads(await reader.readline())
            r2 = json.loads(await reader.readline())
            writer.close()
            return r1, r2
        finally:
            srv.close()
            await srv.wait_closed()
            await server.close()

    r1, r2 = asyncio.run(run())
    assert r1["id"] == 7 and len(r1["top"]) == 5
    assert r1["top"][0][0] == pipe.classify(frame)[0][0]
    assert r2["id"] == 8 and r2["stats"]["errors"] == 0


def test_buckets_and_retry_policy(pipe):
    assert default_buckets(64) == [1, 8, 64]
    assert default_buckets(4) == [1, 4]
    assert _is_retryable_device_error(torch.cuda.OutOfMemoryError("oom"))
    assert _is_retryable_device_error(RuntimeError("chain: CUDA error 700 (x)"))
    assert not _is_retryable_device_error(ValueError("bad shape"))
    with pytest.raises(ValueError):
        MicroBatchServer(pipe, max_batch=8, batch_buckets=[1, 4])


def test_pipeline_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        InferencePipeline(ModelConfig(0.25, RES), device="cuda")
    with pytest.raises(RuntimeError):
        InferencePipeline(ModelConfig(0.25, RES), device="cpu").benchmark(batch_size=1)
