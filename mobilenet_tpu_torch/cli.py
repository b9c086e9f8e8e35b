"""Command-line interface of the PyTorch/CUDA port.

    python -m mobilenet_tpu_torch.cli serve --streams 64 [--model v1|v2|v3|v3small] \\
        [--minimalistic] --alpha 1.0 --res 224 [--dtype bfloat16 | --int8] \\
        [--device cuda] [--tcp --port 8000]
    python -m mobilenet_tpu_torch.cli verify [--model v1|v2|v3|v3small] [--minimalistic] \\
        --alpha 1.0 --res 224 [--batch 2] [--int8] [--oracle cpp|numpy] \\
        [--routing plain|fused|mixed|auto|dw] [--dtype float32|bfloat16] [--device cuda]

`serve` builds the micro-batching server (MobileNet-V1, -V2, -V3-Large or
-V3-Small, the float path in --dtype, or the model's exact int8 path with
--int8), runs a selftest of `--streams` concurrent streams
(one JSON line of stats), and with --tcp then serves NDJSON requests on
--port until killed.

`verify` is the JAX package's per-layer correctness gate: the seeded (or
--ckpt) folded weights and a seeded input in [-1, 1] (seed + 1) through the
float32 plain route, every tap against the C++ or NumPy oracle at the
tolerances of `utils/golden.py` (`runtime/eval.verify_layers`); with
--int8 the exact int8 gate of the model (`quant/verify.py`); with a
--routing other than plain the logits gate of that route against the plain
route at --dtype (`runtime/eval.verify_routing`). Exits 0 when every layer
matches and 1 at the first divergence.
"""

from __future__ import annotations

import argparse


def cmd_serve(args):
    from .runtime.serving import serve_main  # noqa: PLC0415

    params = None
    if args.ckpt:
        from .checkpoints import load_npz  # noqa: PLC0415

        params = load_npz(args.ckpt)
    serve_main(alpha=args.alpha, res=args.res, dtype=args.dtype,
               streams=args.streams, port=args.port, device=args.device,
               seed=args.seed, selftest_only=not args.tcp, params=params,
               int8=args.int8, model=args.model, minimalistic=args.minimalistic)


def _folded(cfg, args):
    """The --ckpt folded tree, else the seeded weight set folded."""
    from .checkpoints import (  # noqa: PLC0415
        fold_bn, fold_bn_v2, fold_bn_v3, init_params, init_params_v2, init_params_v3, load_npz,
    )
    from .models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415

    if args.ckpt:
        return load_npz(args.ckpt)
    init, fold = ((init_params_v3, fold_bn_v3) if isinstance(cfg, V3Config)
                  else (init_params_v2, fold_bn_v2) if isinstance(cfg, V2Config)
                  else (init_params, fold_bn))
    return fold(init(cfg, seed=args.seed), eps=cfg.bn_eps)


def cmd_verify(args):
    """The per-layer gate (or the int8 or routing gate); SystemExit(1) at a
    divergence."""
    import numpy as np  # noqa: PLC0415

    from .runtime import eval as teval  # noqa: PLC0415
    from .runtime.serving import make_config  # noqa: PLC0415

    cfg = make_config(args.model, args.alpha, args.res, "float32", args.minimalistic)
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


def main(argv=None):
    from .runtime import eval as teval  # noqa: PLC0415

    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve")
    sp.add_argument("--streams", type=int, default=64)
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--tcp", action="store_true",
                    help="after the selftest, bind the NDJSON TCP front end "
                         "on --port and serve until killed")
    sp.add_argument("--model", default="v1", choices=["v1", "v2", "v3", "v3small"],
                    help="model family: v1 (default), v2 (inverted residuals; "
                         "alphas 0.35-1.4), v3 (MobileNet-V3-Large) or v3small "
                         "(MobileNet-V3-Small)")
    sp.add_argument("--minimalistic", action="store_true",
                    help="with --model v3 or v3small: the -minimalistic variant "
                         "(kernel 3, relu, no squeeze-excite)")
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--res", type=int, default=224)
    sp.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    sp.add_argument("--int8", action="store_true",
                    help="serve the exact int8 path of --model (per-layer "
                         "requantization, exact against the int8 oracle; V2 and "
                         "V3 calibrate their scales at start); --dtype is then unused")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ckpt", default=None, help="folded .npz checkpoint path")
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("verify")
    sp.add_argument("--model", default="v1", choices=["v1", "v2", "v3", "v3small"],
                    help="model family: v1 (default), v2, v3 (MobileNet-V3-Large) or "
                         "v3small (MobileNet-V3-Small)")
    sp.add_argument("--minimalistic", action="store_true",
                    help="with --model v3 or v3small: the -minimalistic variant")
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--res", type=int, default=224)
    sp.add_argument("--batch", type=int, default=2)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ckpt", default=None, help="folded .npz checkpoint path")
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
                         "MobileNet-V1's depthwise-kernel route)")
    sp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the routing gate's dtype; the per-layer gate is float32")
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    sp.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError) as e:
        raise SystemExit(f"mobilenet_tpu_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
