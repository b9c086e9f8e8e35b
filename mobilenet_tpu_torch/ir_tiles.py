"""Per-block times of the inverted-residual kernel at candidate tiles.

    python -m mobilenet_tpu_torch.ir_tiles [--batch 1 256] [--alpha 1.0] [--res 224]

For each expanded block of MobileNet-V2 at the given width and size, and
each batch, times the bf16 kernel (CUDA events, random operands) at the
tile that `ops.inverted_residual.ir_plan` picks and at a few others, and
prints one JSON line per block and batch: the shape, the plan, and the ms
of each tile. These are the timings behind ir_plan's time model
(CHUNK_OVERHEAD, SLOTS_TWO_PER_SM). Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json

import torch


def tile_ms(lib, args, tile, reps: int) -> float:
    """CUDA-event ms of one launch at `tile` (after warm-up)."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = lib.inverted_residual_bf16(*args, *tile, stream)
        if code:
            raise RuntimeError(f"inverted_residual_bf16: CUDA error {code}")

    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    from .models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from .ops import _build  # noqa: PLC0415
    from .ops.inverted_residual import (  # noqa: PLC0415
        MAX_FRAGS, SMEM_MAX, ir_plan, ir_smem_bytes,
    )

    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch.ir_tiles")
    p.add_argument("--batch", type=int, nargs="+", default=[1, 256])
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--res", type=int, default=224)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mobilenet_tpu_torch.ir_tiles measures the card; "
                         "torch.cuda.is_available() is False")
    lib = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    h = args.res // 2
    for i, (t, cin, cout, stride) in enumerate(V2Config(args.alpha, args.res).block_defs):
        e, ho = t * cin, -(-h // stride)
        for n in args.batch if t > 1 else ():
            x = rand(n, h, h, cin)
            weights = (rand(cin, e, scale=cin ** -0.5), rand(e, scale=0.1), rand(3, 3, 1, e),
                       rand(e, scale=0.1), rand(e, cout, scale=e ** -0.5), rand(cout, scale=0.1))
            out = torch.empty(n, ho, ho, cout, dtype=torch.bfloat16, device="cuda")
            call = (x.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(), n, h, h,
                    cin, e, cout, stride, int(stride == 1 and cin == cout))
            plan = ir_plan(n, h, h, cin, cout, stride, 2)
            tiles = {plan, (1, 1), (1, min(ho, 7)), (2, min(ho, 14)), (4, min(ho, 14)),
                     (min(ho, 7), min(ho, 7)), (min(ho, 8), min(ho, 8))}
            ms = {f"{th}x{tw}": tile_ms(lib, call, (th, tw), 20 if n == 1 else 5)
                  for th, tw in sorted(tiles)
                  if (th * tw <= 64 and -(-th * tw // 16) * -(-cout // 16) <= MAX_FRAGS
                      and ir_smem_bytes(th, tw, cin, cout, stride, 2) <= SMEM_MAX)}
            print(json.dumps({"device": torch.cuda.get_device_name(0), "block": i,
                              "batch": n, "h": h, "cin": cin, "e": e, "cout": cout,
                              "stride": stride, "plan": plan, "ms": ms}), flush=True)
        h = ho


if __name__ == "__main__":
    main()
