"""Command-line interface of the PyTorch/CUDA port.

    python -m mobilenet_tpu_torch.cli serve --streams 64 [--model v1|v2|v3|v3small] \\
        [--minimalistic] --alpha 1.0 --res 224 [--dtype bfloat16 | --int8] \\
        [--variants 1.0:224,0.25:128,v2:1.0:224] [--dp N] [--device cuda] [--tcp --port 8000]
    python -m mobilenet_tpu_torch.cli warmup [--model ...] --alpha 1.0 --res 224 \\
        [--dtype bfloat16 | --int8] [--streams 64] [--batches 1,8,64] [--batch B] [--dp N] \\
        [--device cuda]
    python -m mobilenet_tpu_torch.cli train [--model ...] --alpha 1.0 --res 224 [--batch 32] \\
        [--steps 10] [--lr 1e-2] [--qat] [--out F.npz] [--ckpt F] [--device cuda]
    python -m mobilenet_tpu_torch.cli verify [--model v1|v2|v3|v3small] [--minimalistic] \\
        --alpha 1.0 --res 224 [--batch 2] [--int8] [--oracle cpp|numpy] \\
        [--routing plain|fused|mixed|auto|dw] [--dtype float32|bfloat16] [--device cuda]
    python -m mobilenet_tpu_torch.cli classify IMAGE [--model ...] --alpha 1.0 --res 224 \\
        [--dtype bfloat16 | --int8] [--top-k 5] [--ckpt F] [--device cuda]
    python -m mobilenet_tpu_torch.cli eval [--model ...] --alpha 1.0 --res 224 \\
        [--dir DIR | --n 32 --synth structured|noise] [--dtype float32 | --int8] \\
        [--oracle numpy|cpp] [--batch 16] [--min-agreement 1.0] [--tie-margin M] \\
        [--ckpt F] [--device cuda]
    python -m mobilenet_tpu_torch.cli export [--model ...] --alpha 1.0 --res 224 \\
        [--from-keras H5 | --from-tf-slim PREFIX | --ckpt RAW] [--out DIR]
    python -m mobilenet_tpu_torch.cli bench [--model ...] --alpha 1.0 --res 224 \\
        [--dtype bfloat16 | --int8] [--batch 256] [--steps 40] [--profile DIR] [--ckpt F]
    python -m mobilenet_tpu_torch.cli sweep [--model ...] [--alphas 0.25,1.0] \\
        [--resolutions 128,224] [--dtype bfloat16 | --int8] [--batch 256] [--steps 20]
    python -m mobilenet_tpu_torch.cli autotune [--model ...] --alpha 1.0 --res 224 \\
        [--dtype bfloat16 | --int8] [--batch 256] [--steps 10] [--ckpt F] [--device cuda]

`serve` builds the micro-batching server (MobileNet-V1, -V2, -V3-Large or
-V3-Small, the float path in --dtype, or the model's exact int8 path with
--int8), runs a selftest of `--streams` concurrent streams
(one JSON line of stats), and with --tcp then serves NDJSON requests on
--port until killed. With --variants it serves several variants from one
process ("alpha:res" or "model:alpha:res", the first the default; a request
names its variant in a "variant" field): a selftest per variant, then one
under mixed load across all of them. With --dp N each batch splits over N
data-parallel ranks (`runtime/serving.make_dp_mesh`: the first N cards, or
N host ranks with --device cpu; fewer cards than N fail with make_mesh's
error), each running the whole route on its shard; --streams must be a
multiple of N.

`warmup` builds the pipeline of one variant and runs each serving bucket
once (`default_buckets(--streams)`, each a multiple of --dp, or --batches,
plus --batch) on the pipeline `serve` would build (--dp as there), so that a
server started later finds the kernels built from source under `build/`
(ops/_build.py) and the libraries set up: a line per bucket ("compiled"
when the kernel library was built during it, else "cached"), then WARMUP OK.

`train` runs SGD with momentum on a seeded synthetic batch (labels below
min(classes, 16)) on the plain route in float32, one JSON line a step
(step, loss, top1); with --qat the int8 quantizer is in the graph
(quant/qat.py; V2 and V3 calibrate first, then freeze). --out saves the
trained folded tree (.npz), which classify, eval and serve read with --ckpt.

`verify` is the JAX package's per-layer correctness gate: the seeded (or
--ckpt) folded weights and a seeded input in [-1, 1] (seed + 1) through the
float32 plain route, every tap against the C++ or NumPy oracle at the
tolerances of `utils/golden.py` (`runtime/eval.verify_layers`); with
--int8 the exact int8 gate of the model (`quant/verify.py`); with a
--routing other than plain the logits gate of that route against the plain
route at --dtype (`runtime/eval.verify_routing`). Exits 0 when every layer
matches and 1 at the first divergence.

`classify` decodes one image on the host (`ops/preprocess.decode_image_host`:
the native decoder, else PIL) and prints its top-k classes from the float
pipeline in --dtype or, with --int8, the model's int8 pipeline.

`eval` is the end-to-end accuracy gate (`runtime/eval.evaluate_agreement`):
a directory of images or --n seeded ones (seed + 1) through the pipeline on
the device and the golden oracle on the host; prints the report as one JSON
line and exits 1 when the tie-aware top-1 agreement is below
--min-agreement. The tie margin: 0 with --int8 (exact), else --tie-margin,
else golden.BF16_TIE_MARGIN of the family in bfloat16 and 1e-3 in float32.

`export` writes `<variant>_raw.npz`, `_folded.npz` and `_int8.npz` under
--out from one weight source: a keras .h5 (--from-keras), a TF-slim
checkpoint (--from-tf-slim, MobileNet-V1), a raw .npz (--ckpt) or the
seeded set. The int8 tree holds the family's quantized constants.

`bench` prints the pipeline's `benchmark()` as one JSON line (img/s of a
device-resident batch, the same with host copies, batch-1 p50/p99) with
the variant, dtype, dw_backend and backend; with --int8 the model's int8
pipeline's; with --profile DIR the timed call runs inside a torch.profiler
trace written to DIR (`utils/profiling.trace`). `sweep` prints one such
line (variant, images_per_sec, p50_latency_ms; int8: variant, dtype,
images_per_sec, batch_size, steps) per point of the alpha x resolution grid
(V1 config.ALPHAS x RESOLUTIONS, V2 V2_ALPHAS, V3 0.75 and 1.0 unless
--alphas / --resolutions name them). Both time the card and refuse any
other device. `autotune` races the routes of one variant end to end
(`runtime/autotune.autotune_backend`: img/s at --batch >= 2, differenced
batch-1 chains at --batch 1) and prints the winner and every candidate's
value; with --device cpu it races "plain" alone on the host clock.
"""

from __future__ import annotations

import argparse

import numpy as np


def cmd_serve(args):
    from .runtime.serving import serve_main  # noqa: PLC0415

    params = None
    if args.ckpt:
        from .checkpoints import load_npz  # noqa: PLC0415

        params = load_npz(args.ckpt)
    serve_main(alpha=args.alpha, res=args.res, dtype=args.dtype,
               streams=args.streams, port=args.port, device=args.device,
               seed=args.seed, selftest_only=not args.tcp, params=params,
               int8=args.int8, model=args.model, minimalistic=args.minimalistic,
               variants=args.variants.split(",") if args.variants else None, dp=args.dp)


def cmd_warmup(args):
    """Run every serving bucket of one variant once, each fenced by reading
    its bytes back, so that cold start is bounded by this command."""
    import time  # noqa: PLC0415

    from .ops import _build  # noqa: PLC0415
    from .runtime.serving import build_pipeline, default_buckets, make_dp_mesh  # noqa: PLC0415

    cfg = _config(args)
    params = None
    if args.ckpt:
        from .checkpoints import load_npz  # noqa: PLC0415

        params = load_npz(args.ckpt)
    mesh = make_dp_mesh(args.dp, args.device)
    pipe = build_pipeline(cfg, device=args.device, seed=args.seed, params=params,
                          int8=args.int8, mesh=mesh)
    batches = ({int(b) for b in args.batches.split(",")} if args.batches
               else set(default_buckets(args.streams, mesh)))
    if args.batch is not None:  # an explicitly requested extra entry
        batches.add(int(args.batch))
    batches = sorted(batches)
    res = cfg.resolution
    for b in batches:
        built = _build.build_seconds
        t0 = time.perf_counter()
        out = pipe.run_batch(np.zeros((b, res, res, 3), np.uint8))
        _ = np.asarray(out)[0, :1]  # the bucket is done when its bytes are back
        dt = time.perf_counter() - t0
        compiled = built is None and bool(_build.build_seconds)
        print(f"warm batch {b:4d}: {dt:6.1f}s ({'compiled' if compiled else 'cached'})",
              flush=True)
    print(f"WARMUP OK: {cfg.variant_name()} {'int8' if args.int8 else args.dtype} "
          f"batches={batches}", flush=True)


def cmd_train(args):
    """SGD-momentum steps on a seeded synthetic batch (an overfit smoke of
    the training path), one JSON line a step; --out saves the folded tree."""
    import json  # noqa: PLC0415

    import torch  # noqa: PLC0415

    from .checkpoints import save_npz, to_device  # noqa: PLC0415
    from .models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415
    from .models.train import make_trainer, tree_map  # noqa: PLC0415
    from .runtime.pipeline import resolve_device  # noqa: PLC0415

    cfg = _config(args, "float32")  # training runs in float32 whatever --dtype says
    device = resolve_device(args.device)
    folded = _folded(cfg, args)
    params = to_device(folded, device, torch.float32)
    if args.qat:
        from .quant import qat  # noqa: PLC0415

        if isinstance(cfg, V2Config):
            step, _ = qat.make_qat_trainer_v2(cfg, folded, params, lr=args.lr)
        elif isinstance(cfg, V3Config):
            step, _ = qat.make_qat_trainer_v3(cfg, folded, params, lr=args.lr)
        else:
            step = qat.make_qat_trainer(cfg, params, lr=args.lr)
    else:
        step = make_trainer(cfg, params, lr=args.lr)

    rng = np.random.default_rng(0)
    n_cls = min(cfg.num_classes, 16)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, n_cls, (args.batch,))).to(device)
    for i in range(args.steps):
        loss, top1 = step(images, labels)
        print(json.dumps({"step": i, "loss": round(float(loss), 4),
                          "top1": round(float(top1), 4)}), flush=True)
    if args.out:
        save_npz(args.out, tree_map(lambda t: t.detach().cpu().numpy(), params))
        print(f"saved trained folded checkpoint to {args.out}")


def _folded(cfg, args):
    """The --ckpt folded tree, else the seeded weight set folded."""
    from .checkpoints import default_folded, load_npz  # noqa: PLC0415

    return load_npz(args.ckpt) if args.ckpt else default_folded(cfg, seed=args.seed)


def _config(args, dtype=None):
    from .runtime.serving import make_config  # noqa: PLC0415

    return make_config(args.model, args.alpha, args.res, dtype or args.dtype,
                       args.minimalistic)


def cmd_classify(args):
    """Host decode, then the top-k classes of the float or int8 pipeline;
    resize and normalization run on the device."""
    from .ops.preprocess import decode_image_host  # noqa: PLC0415
    from .runtime.serving import build_pipeline  # noqa: PLC0415

    cfg = _config(args)
    img = decode_image_host(args.image)
    pipe = build_pipeline(cfg, device=args.device, params=_folded(cfg, args), int8=args.int8)
    for rank, (cls, prob) in enumerate(pipe.classify(img, top_k=args.top_k), 1):
        print(f"top-{rank}: class {cls}  p={prob:.4f}")


def cmd_eval(args):
    """The end-to-end top-1 agreement against the golden oracle; exits 1
    below --min-agreement."""
    import json  # noqa: PLC0415

    from .runtime.eval import evaluate_agreement, load_dir_images, synth_images  # noqa: PLC0415
    from .utils import golden  # noqa: PLC0415

    cfg = _config(args)
    images = (load_dir_images(args.dir) if args.dir else
              synth_images(cfg, args.n, args.seed + 1, structured=args.synth == "structured"))
    # int8 is exact: a top-1 flip is a defect, never a rounding near tie.
    # bf16's margin is the family's flip class (golden.BF16_TIE_MARGIN).
    if args.int8:
        tie_margin = 0.0
    elif args.tie_margin is not None:
        tie_margin = args.tie_margin
    elif args.dtype == "bfloat16":
        tie_margin = golden.BF16_TIE_MARGIN["v3" if args.model == "v3small" else args.model]
    else:
        tie_margin = 1e-3
    report = evaluate_agreement(
        cfg, images, params=_folded(cfg, args), int8=args.int8, oracle=args.oracle,
        batch_size=args.batch, top_k=args.top_k, tie_margin=tie_margin, device=args.device)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in report.items()}), flush=True)
    # the gate reads the unrounded tie-aware agreement
    if report["top1_agreement_tie_aware"] < args.min_agreement:
        raise SystemExit(1)


def _qlayer(layer):
    """A quantized layer's exported constants: V1 and V2 (QuantLayer) the
    int8 weight, int32 bias and requant multiplier; V3 (QLayerN) the
    accumulator-to-real map `a` and the output's 1/scale in place of `m`."""
    out = {"w_i8": layer.w_i8, "bias_i32": layer.bias_i32}
    if hasattr(layer, "m"):
        out["m"] = layer.m
    else:
        out.update(a=layer.a, inv_s=np.float32(layer.inv_s))
    return out


def cmd_export(args):
    """Raw, folded and int8 .npz files of one weight source, every family."""
    import os  # noqa: PLC0415

    from .checkpoints import family_fns, load_npz, save_npz  # noqa: PLC0415
    from .models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415

    sources = [s for s in ("from_keras", "from_tf_slim", "ckpt") if getattr(args, s)]
    if len(sources) > 1:
        raise SystemExit(f"--{' / --'.join(s.replace('_', '-') for s in sources)} are "
                         "mutually exclusive (each names a weight source); pass exactly one")
    if args.from_tf_slim and args.model != "v1":
        raise SystemExit("--from-tf-slim imports the V1 TF-slim layout only; "
                         "V2/V3 import keras .h5 (--from-keras) or --ckpt")
    cfg = _config(args, "float32")
    init, fold = family_fns(cfg)
    if args.from_keras:
        from . import checkpoints  # noqa: PLC0415

        importer = (checkpoints.import_keras_h5_v3 if isinstance(cfg, V3Config)
                    else checkpoints.import_keras_h5_v2 if isinstance(cfg, V2Config)
                    else checkpoints.import_keras_h5)
        raw = importer(args.from_keras, cfg)
    elif args.from_tf_slim:
        from .checkpoints import import_tf_slim  # noqa: PLC0415

        raw = import_tf_slim(args.from_tf_slim, cfg)
    elif args.ckpt:
        raw = load_npz(args.ckpt)
    else:
        raw = init(cfg, seed=args.seed)
    folded = fold(raw, eps=cfg.bn_eps)
    if isinstance(cfg, V3Config):
        from .quant.v3 import quantize_v3  # noqa: PLC0415

        q = quantize_v3(folded, cfg)
        extra = {"conv_last": _qlayer(q.conv_last), "head": _qlayer(q.head),
                 "s_head": np.float32(q.s_head)}
    elif isinstance(cfg, V2Config):
        from .quant.v2 import quantize_v2  # noqa: PLC0415

        q = quantize_v2(folded, cfg)
        extra = {"conv_last": _qlayer(q.conv_last), "s_blk": np.asarray(q.s_blk, np.float32)}
    else:
        from .quant import quantize  # noqa: PLC0415

        q, extra = quantize(folded, cfg), {}
    qtree = {"conv1": _qlayer(q.conv1),
             "blocks": [{k: _qlayer(v) for k, v in b.items()} for b in q.blocks],
             **extra,
             "fc": {"w_i8": q.fc_w_i8, "s_w": q.fc_s_w, "b": q.fc_b_f32}}
    name = cfg.variant_name()
    os.makedirs(args.out, exist_ok=True)
    for kind, tree in (("raw", raw), ("folded", folded), ("int8", qtree)):
        save_npz(os.path.join(args.out, f"{name}_{kind}.npz"), tree)
    print(f"exported raw/folded/int8 checkpoints to {args.out}")


def cmd_verify(args):
    """The per-layer gate (or the int8 or routing gate); SystemExit(1) at a
    divergence."""
    from .runtime import eval as teval  # noqa: PLC0415

    cfg = _config(args, "float32")
    folded = _folded(cfg, args)
    x = np.random.default_rng(args.seed + 1).uniform(
        -1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(np.float32)
    if args.model == "v1" and args.int8:
        from .quant.verify import verify_int8  # noqa: PLC0415

        ok = verify_int8(cfg, folded, x, device=args.device, oracle=args.oracle)
    elif args.routing != "plain":
        if args.int8:
            raise SystemExit("mobilenet_tpu_torch verify: --routing races float routes; "
                             "the int8 gate is exact per layer already")
        ok = teval.verify_routing(cfg, folded, x, args.routing, dtype=args.dtype,
                                  oracle=args.oracle, device=args.device)
    elif args.int8:
        from .quant import verify as qverify  # noqa: PLC0415

        gate = qverify.verify_int8_v2 if args.model == "v2" else qverify.verify_int8_v3
        ok = gate(cfg, folded, x, device=args.device)
    else:
        ok = teval.verify_layers(cfg, folded, x, oracle=args.oracle, device=args.device)
    if not ok:
        raise SystemExit(1)


def _require_card(args):
    """bench and sweep time the card (`PipelineBase.benchmark()`); refuse
    any other device rather than time the host in its place."""
    import torch  # noqa: PLC0415

    if torch.device(args.device).type != "cuda":
        raise SystemExit(f"mobilenet_tpu_torch {args.cmd}: benchmark() measures the card; "
                         f"--device {args.device} is refused (use autotune --device cpu "
                         "for a host-clock race)")
    if not torch.cuda.is_available():
        raise SystemExit(f"mobilenet_tpu_torch {args.cmd}: benchmark() measures the card, "
                         "and torch.cuda.is_available() is False")


def _bench_stats(args, cfg, int8: bool, batch: int, steps: int, ckpt=None):
    """The variant's pipeline (int8: the model's int8 pipeline) on the `ckpt`
    weights (else the seeded set), benchmarked at `batch` for `steps`;
    --profile DIR traces the timed call."""
    import contextlib  # noqa: PLC0415

    from .checkpoints import load_npz  # noqa: PLC0415
    from .runtime.serving import build_pipeline  # noqa: PLC0415

    params = load_npz(ckpt) if ckpt else None
    pipe = build_pipeline(cfg, device=args.device, seed=args.seed, params=params, int8=int8)
    profile_dir = getattr(args, "profile", None)
    ctx = contextlib.nullcontext()
    if profile_dir:
        from .utils.profiling import trace  # noqa: PLC0415

        ctx = trace(profile_dir)
    with ctx:
        stats = pipe.benchmark(batch_size=batch, steps=steps)
    return pipe, stats


def cmd_bench(args):
    """benchmark() of one variant's pipeline as one JSON line."""
    import json  # noqa: PLC0415

    _require_card(args)
    cfg = _config(args)
    pipe, stats = _bench_stats(args, cfg, args.int8, args.batch, args.steps, args.ckpt)
    stats.update(variant=cfg.variant_name(), dtype="int8" if args.int8 else args.dtype,
                 dw_backend=pipe.dw_backend, backend="cuda")
    if args.profile:
        stats["profile_dir"] = args.profile
    print(json.dumps(stats), flush=True)


def _sweep_grid(args):
    """[(alpha, res)] in the JAX package's order: every alpha, then every
    resolution within it."""
    from .config import ALPHAS, RESOLUTIONS  # noqa: PLC0415
    from .models.mobilenet_v2 import V2_ALPHAS  # noqa: PLC0415

    default_alphas = {"v1": ALPHAS, "v2": V2_ALPHAS}.get(args.model, (0.75, 1.0))
    alphas = ([float(a) for a in args.alphas.split(",")] if args.alphas
              else list(default_alphas))
    resolutions = ([int(r) for r in args.resolutions.split(",")] if args.resolutions
                   else list(RESOLUTIONS))
    return [(a, r) for a in alphas for r in resolutions]


def cmd_sweep(args):
    """One benchmark() row per point of the grid; returns the rows."""
    import json  # noqa: PLC0415

    from .runtime.serving import make_config  # noqa: PLC0415

    _require_card(args)
    rows = []
    for alpha, res in _sweep_grid(args):
        cfg = make_config(args.model, alpha, res, args.dtype, args.minimalistic)
        # --ckpt reaches the int8 rows only, as in the JAX package
        _, stats = _bench_stats(args, cfg, args.int8, args.batch, args.steps,
                                args.ckpt if args.int8 else None)
        if args.int8:  # the JAX package's int8 rows (_int8_throughput, _bench_int8_family)
            row = {"variant": cfg.variant_name(), "dtype": "int8",
                   "images_per_sec": round(stats["images_per_sec"], 1),
                   "batch_size": args.batch, "steps": stats["steps"]}
            if args.model != "v1":
                row["backend"] = "cuda"
        else:
            row = {"variant": cfg.variant_name(),
                   "images_per_sec": round(stats["images_per_sec"], 1),
                   "p50_latency_ms": round(stats["p50_latency_ms"], 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def cmd_autotune(args):
    """Race the routing candidates end to end (runtime.autotune): img/s at
    --batch >= 2, differenced batch-1 chains at --batch 1."""
    import json  # noqa: PLC0415

    from .runtime.autotune import autotune_backend  # noqa: PLC0415

    cfg = _config(args)
    params = _folded(cfg, args) if args.ckpt else None
    best, results = autotune_backend(cfg, batch_size=args.batch, steps=args.steps,
                                     seed=args.seed, params=params, int8=args.int8,
                                     device=args.device)
    value_key = "latency_ms" if args.batch == 1 else "images_per_sec"
    print(json.dumps({
        "variant": cfg.variant_name(),
        "dtype": "int8" if args.int8 else args.dtype,
        "batch": args.batch,
        "best": best,
        value_key: {k: round(v, 4 if args.batch == 1 else 1) for k, v in results.items()},
    }), flush=True)


def main(argv=None):
    from .runtime import eval as teval  # noqa: PLC0415

    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, dtype="bfloat16", batch=None, ckpt="folded .npz checkpoint path",
               device=True):
        """The flags every command shares: the model, its variant, the seed
        and the weights; --dtype and --batch where given, and --device where
        the command runs the model (export runs on the host only)."""
        sp.add_argument("--model", default="v1", choices=["v1", "v2", "v3", "v3small"],
                        help="model family: v1 (default), v2 (inverted residuals; "
                             "alphas 0.35-1.4), v3 (MobileNet-V3-Large) or v3small "
                             "(MobileNet-V3-Small)")
        sp.add_argument("--minimalistic", action="store_true",
                        help="with --model v3 or v3small: the -minimalistic variant "
                             "(kernel 3, relu, no squeeze-excite)")
        sp.add_argument("--alpha", type=float, default=1.0)
        sp.add_argument("--res", type=int, default=224)
        sp.add_argument("--dtype", default=dtype, choices=["float32", "bfloat16"])
        if batch is not None:
            sp.add_argument("--batch", type=int, default=batch)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--ckpt", default=None, help=ckpt)
        if device:
            sp.add_argument("--device", default="cuda",
                            help="torch device: cuda (default), cuda:N or cpu")

    sp = sub.add_parser("serve")
    sp.add_argument("--streams", type=int, default=64)
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--tcp", action="store_true",
                    help="after the selftest, bind the NDJSON TCP front end "
                         "on --port and serve until killed")
    sp.add_argument("--int8", action="store_true",
                    help="serve the exact int8 path of --model (per-layer "
                         "requantization, exact against the int8 oracle; V2 and "
                         "V3 calibrate their scales at start); --dtype is then unused")
    sp.add_argument("--variants", default=None,
                    help='serve several variants from one process, e.g. '
                         '"1.0:224,0.25:128,v2:1.0:224" (the first is the default; '
                         'requests route with a "variant" field); --alpha, --res '
                         'and --model are then unused')
    sp.add_argument("--dp", type=int, default=1,
                    help="data-parallel width: split each micro-batch over N ranks (the "
                         "first N cards; N host ranks with --device cpu); 1 = one device")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("warmup")
    sp.add_argument("--int8", action="store_true",
                    help="warm the model's int8 pipeline")
    sp.add_argument("--batches", default=None,
                    help="comma list of batch sizes to run (default: the serving "
                         "buckets of --streams)")
    sp.add_argument("--streams", type=int, default=64,
                    help="the --streams the server will run with (its bucket sizes)")
    sp.add_argument("--dp", type=int, default=1,
                    help="match `serve --dp N`: the data-parallel pipeline and buckets")
    common(sp, batch=None)
    sp.add_argument("--batch", type=int, default=None,
                    help="one more batch size to run")
    sp.set_defaults(fn=cmd_warmup)

    sp = sub.add_parser("train")
    sp.add_argument("--steps", type=int, default=10)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--out", default=None, help="save the trained folded .npz here")
    sp.add_argument("--qat", action="store_true",
                    help="quantization-aware training: the int8 quantizer in the graph "
                         "(quant/qat.py; V2 and V3 calibrate, then freeze)")
    common(sp, batch=32)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("verify")
    sp.add_argument("--int8", action="store_true",
                    help="the model's exact int8 gate (V1 against --oracle; V2 and V3 "
                         "calibrate, then gate against the NumPy int8 oracle)")
    sp.add_argument("--oracle", default="cpp", choices=teval.ORACLES,
                    help="cpp (default; the C++ oracle, built with g++ at first use) "
                         "or numpy")
    sp.add_argument("--routing", default="plain",
                    choices=teval.ROUTINGS,
                    help="plain (default): the per-layer oracle gate; any other: the "
                         "logits gate of that route against plain at --dtype (dw: "
                         "MobileNet-V1's depthwise-kernel route); --dtype is the "
                         "routing gate's, the per-layer gate is float32")
    common(sp, dtype="float32", batch=2)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("classify")
    sp.add_argument("image")
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--int8", action="store_true",
                    help="classify with the model's int8 pipeline (V2 and V3 "
                         "calibrate their scales first)")
    common(sp, batch=1)
    sp.set_defaults(fn=cmd_classify)

    sp = sub.add_parser("eval")
    sp.add_argument("--dir", default=None,
                    help="directory of images to evaluate (default: synthetic)")
    sp.add_argument("--n", type=int, default=32,
                    help="synthetic image count when --dir is not given")
    sp.add_argument("--synth", default="structured", choices=["structured", "noise"],
                    help="synthetic family: structured (noise, gradients, patches, "
                         "blobs) or pure noise")
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--int8", action="store_true",
                    help="evaluate the model's int8 pipeline (exact: tie margin 0)")
    sp.add_argument("--oracle", default="numpy", choices=teval.ORACLES)
    sp.add_argument("--min-agreement", type=float, default=1.0,
                    help="exit 1 below this tie-aware top-1 agreement")
    sp.add_argument("--tie-margin", type=float, default=None,
                    help="relative oracle-logit margin under which a top-1 flip "
                         "counts as a near tie, not a mismatch (0 = strict). "
                         "Default: 1e-3 in float32, the family's bf16 flip class "
                         "in bfloat16 (golden.BF16_TIE_MARGIN)")
    # the gate compares with a float32 oracle at a threshold of 1.0, so the
    # device side runs in float32 too unless asked otherwise
    common(sp, dtype="float32", batch=16)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("export")
    sp.add_argument("--out", default="checkpoints_out")
    sp.add_argument("--from-keras", metavar="H5",
                    help="convert a keras MobileNet .h5 checkpoint")
    sp.add_argument("--from-tf-slim", metavar="CKPT_PREFIX",
                    help="convert a TF-slim MobilenetV1 checkpoint prefix")
    common(sp, batch=1, ckpt="raw (unfolded) .npz checkpoint path", device=False)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("bench")
    sp.add_argument("--steps", type=int, default=40)
    sp.add_argument("--int8", action="store_true",
                    help="benchmark the model's int8 pipeline (V2 and V3 calibrate first)")
    sp.add_argument("--profile", metavar="DIR", default=None,
                    help="trace the timed call with torch.profiler into DIR "
                         "(a Chrome trace file)")
    common(sp, batch=256)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("sweep")
    sp.add_argument("--steps", type=int, default=20)
    sp.add_argument("--alphas", default=None, help="comma list, e.g. 0.25,0.5")
    sp.add_argument("--resolutions", default=None, help="comma list, e.g. 128,224")
    sp.add_argument("--int8", action="store_true",
                    help="sweep the model's int8 pipeline")
    common(sp, batch=256)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("autotune")
    sp.add_argument("--steps", type=int, default=10)
    sp.add_argument("--int8", action="store_true",
                    help="race the model's int8 routing candidates")
    common(sp, batch=256)
    sp.set_defaults(fn=cmd_autotune)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError) as e:
        raise SystemExit(f"mobilenet_tpu_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
