"""The rest of the port's serving on the CPU, after the JAX package's
tests/test_serving.py: MultiVariantServer routes by variant name and
defaults to the first, an unknown variant fails only its own request, the
NDJSON front end routes the "variant" field (and echoes a single-variant
server's refusal as that request's error), `selftest_multi` under mixed
load, a single-entry --variants deployment still wraps in
MultiVariantServer, `serve_main` refuses --ckpt with several variants and
`serve --variants` prints a selftest per variant then the mixed one, `cli
warmup` runs the server's own buckets and prints the JAX package's lines,
and no parser has --dp."""

import asyncio
import base64
import json
import re

import numpy as np
import pytest

from mobilenet_tpu.cli import main as jax_cli_main
from mobilenet_tpu_torch import InferencePipeline, ModelConfig
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.runtime.serving import (
    MicroBatchServer, MultiVariantServer, build_server, default_buckets, make_tcp_server,
    selftest_multi, serve_main,
)

CFG_A, CFG_B = ModelConfig(0.25, 64), ModelConfig(0.25, 96)
A, B = CFG_A.variant_name(), CFG_B.variant_name()
WARM_LINE = re.compile(r"^warm batch +\d+: +\d+\.\ds \((cached|compiled)\)$")


@pytest.fixture(scope="module")
def pipes():
    return {A: InferencePipeline(CFG_A, device="cpu", seed=0),
            B: InferencePipeline(CFG_B, device="cpu", seed=0)}


def _multi(pipes, max_batch=4):
    return MultiVariantServer({n: MicroBatchServer(p, max_batch=max_batch, max_delay_ms=1.0)
                               for n, p in pipes.items()})


def test_routes_and_defaults(pipes):
    img_a, img_b = (np.random.default_rng(i).integers(0, 256, (r, r, 3), np.uint8)
                    for i, r in ((0, 64), (1, 96)))

    async def run():
        mv = _multi(pipes)
        await mv.start()
        try:
            t_default = await mv.submit(img_a)
            t_b = await mv.submit(img_b, variant=B)
            bad = await asyncio.gather(mv.submit(img_a, variant="nope"),
                                       mv.submit(img_a, variant=A), return_exceptions=True)
            return t_default, t_b, bad, mv.stats_dict()
        finally:
            await mv.close()

    t_default, t_b, (unknown, good), stats = asyncio.run(run())
    assert t_default[0][0] == int(pipes[A].run_batch(img_a[None])[0].argmax())
    assert t_b[0][0] == int(pipes[B].run_batch(img_b[None])[0].argmax())
    # an unknown variant fails its own request, not its neighbour's
    assert isinstance(unknown, ValueError) and "unknown variant" in str(unknown)
    assert good == t_default
    assert stats["default"] == A and set(stats["variants"]) == {A, B}
    assert stats["variants"][A]["requests"] == 2 and stats["variants"][B]["requests"] == 1
    assert stats["variants"][A]["errors"] == 0


def test_tcp_routes_variant_field(pipes):
    img_a = np.zeros((64, 64, 3), np.uint8)
    img_b = np.zeros((96, 96, 3), np.uint8)

    async def roundtrip(server, reqs):
        await server.start()
        srv = await make_tcp_server(server, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            for rid, img, variant in reqs:
                req = {"id": rid, "shape": list(img.shape),
                       "image_b64": base64.b64encode(img.tobytes()).decode()}
                if variant:
                    req["variant"] = variant
                writer.write((json.dumps(req) + "\n").encode())
            await writer.drain()
            resps = [json.loads(await reader.readline()) for _ in reqs]
            writer.close()
            return {r["id"]: r for r in resps}
        finally:
            srv.close()
            await srv.wait_closed()
            await server.close()

    by_id = asyncio.run(roundtrip(_multi(pipes, max_batch=2),
                                  [(1, img_a, None), (2, img_b, B), (3, img_a, "bogus")]))
    assert "top" in by_id[1] and "top" in by_id[2]
    assert "unknown variant" in by_id[3]["error"]
    single = MicroBatchServer(pipes[A], max_batch=2, max_delay_ms=1.0)
    by_id = asyncio.run(roundtrip(single, [(1, img_a, A), (2, img_a, None)]))
    assert "variant" in by_id[1]["error"] and "top" in by_id[2]


def test_selftest_multi_mixed_load(pipes):
    async def run():
        mv = _multi(pipes)
        await mv.start()
        try:
            stats = await selftest_multi(mv, streams=4, requests_per_stream=2)
            return stats, {n: s.stats.requests for n, s in mv.servers.items()}
        finally:
            await mv.close()

    stats, per_variant = asyncio.run(run())
    assert stats["mode"] == "mixed-variants" and stats["errors"] == 0
    assert stats["requests"] == 8 and stats["images_per_sec"] > 0
    assert set(stats["per_variant_p50_ms"]) == set(stats["per_variant_p99_ms"]) == {A, B}
    assert per_variant == {A: 4, B: 4}  # 2 streams x 2 requests each


def test_build_server_single_entry_wraps_multi():
    async def run():
        server, servers = build_server({A: CFG_A}, 2, device="cpu", multi=True)
        assert isinstance(server, MultiVariantServer) and list(servers) == [A]
        await server.start()
        try:
            return await server.submit(np.zeros((64, 64, 3), np.uint8), variant=A)
        finally:
            await server.close()

    assert len(asyncio.run(run())) == 5
    with pytest.raises(ValueError, match="multi=True"):
        build_server({A: CFG_A, B: CFG_B}, 2, device="cpu")


def test_serve_main_variants(capsys):
    with pytest.raises(ValueError, match="--ckpt applies to a single variant"):
        serve_main(0.25, 64, "bfloat16", 2, 0, device="cpu", params={},
                   variants=["0.25:64", "0.25:96"])
    with pytest.raises(SystemExit, match="multiple of --dp"):  # --dp splits --streams evenly
        cli_main(["serve", "--dp", "3", "--device", "cpu"])
    capsys.readouterr()
    cli_main(["serve", "--variants", "0.25:64,v2:0.35:64", "--streams", "2",
              "--dtype", "float32", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("variant") for ln in lines[:2]] == ["mobilenet_v1_0.25_64",
                                                       "mobilenet_v2_0.35_64"]
    assert lines[2]["mode"] == "mixed-variants" and lines[2]["requests"] == 16
    assert all(ln["errors"] == 0 for ln in lines)


def test_warmup_buckets_and_lines(capsys):
    """cli warmup's default batches are the buckets a server of --streams
    runs; its lines have the JAX package's format, WARMUP OK word for
    word."""
    pipe = InferencePipeline(CFG_A, device="cpu", seed=0)
    assert default_buckets(64) == MicroBatchServer(pipe, max_batch=64).batch_buckets == [1, 8, 64]
    size = ["--alpha", "0.25", "--res", "64"]
    cli_main(["warmup", *size, "--streams", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"WARMUP OK: {A} bfloat16 batches={default_buckets(16)}"
    assert len(lines) == 4 and all(WARM_LINE.match(ln) for ln in lines[:-1])

    jax_cli_main(["--backend", "cpu", "warmup", *size, "--batches", "1,2"])
    jax_lines = capsys.readouterr().out.splitlines()
    cli_main(["warmup", *size, "--batches", "1,2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == jax_lines[-1] == f"WARMUP OK: {A} bfloat16 batches=[1, 2]"
    for got, want in zip(lines[:-1], jax_lines[:-1], strict=True):
        assert WARM_LINE.match(got) and WARM_LINE.match(want)
        assert got.split(":")[0] == want.split(":")[0]
