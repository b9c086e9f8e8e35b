"""Command-line interface of the PyTorch/CUDA port.

    python -m mobilenet_tpu_torch.cli serve --streams 64 --alpha 1.0 \\
        --res 224 --dtype bfloat16 [--device cuda] [--tcp --port 8000]

`serve` builds the micro-batching server, runs a selftest of `--streams`
concurrent streams (one JSON line of stats), and with --tcp then serves
NDJSON requests on --port until killed.
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
               seed=args.seed, selftest_only=not args.tcp, params=params)


def main(argv=None):
    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve")
    sp.add_argument("--streams", type=int, default=64)
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--tcp", action="store_true",
                    help="after the selftest, bind the NDJSON TCP front end "
                         "on --port and serve until killed")
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--res", type=int, default=224)
    sp.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ckpt", default=None, help="folded .npz checkpoint path")
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"mobilenet_tpu_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
