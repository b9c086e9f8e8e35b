"""Per-block times of the bottleneck kernels' Hopper tiles at candidate tiles.

    python -m mobilenet_tpu_torch.ir_tiles [--batch 1 256] [--alpha 1.0] [--res 224] \
        [--model v2|v3|v3small] [--int8]

For every expanded block of MobileNet-V2 (--model v2, the default: blocks
1-16, ReLU6, k 3, no SE), or every block of MobileNet-V3-Large (v3) or
-Small (v3small), at the given width and size and each batch, times the
bf16 V3 bottleneck kernel (its Hopper tile, `csrc/v3_wgmma.cuh`) at
`ops.v3_block.v3_wgmma_plan`'s plan and at other tiles with the plan's Cout
parts and the first ring slots that fit, or with --int8 the int8 bottleneck
kernel (`csrc/v3_i8_wgmma.cuh`) at `ops.v3_block_i8.v3_i8_wgmma_plan`'s
plan and at other tiles, likewise; SE blocks with all of their launches
(CUDA events, random operands). Prints one JSON line per block and batch:
the shape, the plan, and the ms of each tile. These are the timings behind
the plans' unit-time constants and ties. Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch


def tile_ms(fn, args, tile, reps: int, tail=()) -> float:
    """CUDA-event ms of one launch of the C entry `fn` at `tile` (after
    warm-up); `tail` are the arguments after the tile."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = fn(*args, *tile, *tail, stream)
        if code:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code}")

    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Block(NamedTuple):
    """A block's shape in the fields of mobilenet_v3's block definitions."""
    cin: int
    cexp: int
    cout: int
    kernel: int
    stride: int
    se_mid: int
    act: str
    has_res: bool
    has_expand: bool


def block_defs(args) -> list:
    """The blocks of --model at --alpha and --res, with their indices: V2's
    expanded blocks as ReLU6 bottlenecks (k 3, no SE; block 0, t == 1 at
    stride 1, runs the separable block), or V3-Large's / V3-Small's own."""
    if args.model == "v2":
        from .models.mobilenet_v2 import V2Config  # noqa: PLC0415

        defs = V2Config(args.alpha, args.res).block_defs
        return [(i, Block(cin, t * cin, cout, 3, stride, 0, "relu6",
                          stride == 1 and cin == cout, True))
                for i, (t, cin, cout, stride) in enumerate(defs) if t > 1]
    from .models.mobilenet_v3 import V3Config  # noqa: PLC0415

    variant = "small" if args.model == "v3small" else "large"
    return list(enumerate(V3Config(variant, args.alpha, args.res).block_defs))


def v3_rows(lib, args, gen):
    """One JSON line per block and batch: the bottleneck kernel's ms (bf16,
    or the int8 kernel with --int8) at the plan's tile and at candidate
    tiles of up to the plan's output cap."""
    from .ops.head import ACTS  # noqa: PLC0415
    from .ops.v3_block import (  # noqa: PLC0415
        V3W_RINGS, V3W_SMEM_LIMIT, V3W_TM, v3_wgmma_plan, v3_wgmma_smem_bytes,
    )
    from .ops.v3_block_i8 import (  # noqa: PLC0415
        FULL, GATED, I8W_RINGS, I8W_SMEM_LIMIT, I8W_TM, K_ALIGN, POOL, kernel_weights,
        v3_i8_wgmma_plan, v3_i8_wgmma_smem_bytes,
    )

    def rand(*shape, scale):
        if args.int8:
            return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                 dtype=torch.int8)
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    def layer(w_shape, c, scale):  # (w, b[, multiplier]) of one layer
        if args.int8:
            return (rand(*w_shape, scale=0), torch.zeros(c, dtype=torch.int32, device="cuda"),
                    torch.full((c,), 1e-3, device="cuda"))
        return rand(*w_shape, scale=scale), rand(c, scale=0.1)

    h = args.res // 2
    for i, bd in block_defs(args):
        e, ho, se, k, cout = bd.cexp, -(-h // bd.stride), bd.se_mid, bd.kernel, bd.cout
        identity = not bd.has_expand
        for n in args.batch:
            cx = -(-bd.cin // K_ALIGN) * K_ALIGN if args.int8 else bd.cin
            x = rand(n, h, h, cx, scale=1.0)
            exp = () if identity else layer((bd.cin, e), e, bd.cin ** -0.5)
            dw, prj = layer((k, k, 1, e), e, 0.3), layer((e, cout), cout, e ** -0.5)
            ses = (layer((e, se), se, e ** -0.5) + layer((se, e), e, se ** -0.5)) if se else ()
            out = torch.empty(n, ho, ho, cout, dtype=x.dtype, device="cuda")
            if args.int8:
                kw = kernel_weights(None if identity else {"w": exp[0]}, {"w": dw[0]},
                                    {"w": prj[0]})
                ep = -(-e // K_ALIGN) * K_ALIGN
                scratch = [torch.empty(n * e if se else 1, dtype=dt, device="cuda")
                           for dt in (torch.int32, torch.float32)]
                scratch.append(torch.empty(n * ho * ho * ep if se else 1, dtype=torch.int8,
                                           device="cuda"))
                ptrs = [x.data_ptr(), *((kw["exp"].data_ptr(), exp[1].data_ptr(),
                                         exp[2].data_ptr()) if exp else (0,) * 3),
                        kw["dw"].data_ptr(), dw[1].data_ptr(), dw[2].data_ptr(),
                        kw["prj"].data_ptr(), prj[1].data_ptr(), prj[2].data_ptr(),
                        *((t.data_ptr() for t in ses) if ses else (0,) * 6),
                        *(t.data_ptr() for t in scratch), out.data_ptr()]
                fn, cap = lib.v3_block_i8, I8W_TM
                m6 = 1e-3 if bd.act == "hswish" else 127.0  # hswish's m6, else the bound
                tail = (m6, m6, 1.0 / (ho * ho), 1.0 / 6)  # exp, dw, 1/hw, 1/6
                iplan = v3_i8_wgmma_plan(n, h, h, bd.cin, e, cout, k, bd.stride, se, identity)
                plan = iplan[:2]

                def full(th, tw, iplan=iplan):  # the C entry's plan arguments, or None
                    modes = (POOL, GATED) if se else (FULL,)
                    ring = next((r for r in I8W_RINGS if all(v3_i8_wgmma_smem_bytes(
                        th, tw, bd.cin, e, cout, k, bd.stride, iplan.cw, *r, identity, m)
                        <= I8W_SMEM_LIMIT for m in modes)), None)
                    return None if ring is None else (th, tw, iplan.split, iplan.cw, *ring)
            else:
                # the 1x1 tile's sums, then the gates
                part = torch.empty(n * ho * ho * e + n * e if se else 1, device="cuda")
                ptrs = [x.data_ptr(), *((t.data_ptr() for t in exp) if exp else (0, 0)),
                        *(t.data_ptr() for t in dw + prj),
                        *((t.data_ptr() for t in ses) if ses else (0,) * 4), part.data_ptr(),
                        out.data_ptr()]
                fn, tail, cap = lib.v3_block_bf16, (), V3W_TM
                wplan = v3_wgmma_plan(n, h, h, bd.cin, e, cout, k, bd.stride, se, identity)
                plan = wplan[:2]

                def full(th, tw, wplan=wplan):
                    ring = next((r for r in V3W_RINGS if v3_wgmma_smem_bytes(
                        th, tw, bd.cin, e, cout, k, bd.stride, wplan.cw, *r,
                        identity) <= V3W_SMEM_LIMIT), None)
                    return None if ring is None else (th, tw, wplan.split, wplan.cw, *ring)
            call = (*ptrs, n, h, h, bd.cin, e, cout, se, k, bd.stride,
                    ACTS["linear" if identity else bd.act], ACTS[bd.act], int(bd.has_res),
                    int(identity))
            tiles = {plan, (1, 1), (1, min(ho, 7)), (2, min(ho, 14)), (4, min(ho, 14)),
                     (4, min(ho, 16)), (min(ho, 7), min(ho, 7)), (min(ho, 8), min(ho, 8)),
                     (min(ho, 8), min(ho, 16)), (min(ho, 16), min(ho, 16)),
                     (min(ho, 7), min(ho, 14)), (min(ho, 14), min(ho, 14)),
                     (min(ho, 2), min(ho, 56)), (min(ho, 4), min(ho, 28)),
                     (min(ho, 4), min(ho, 32)), (min(ho, 9), min(ho, 14))}
            ms = {f"{th}x{tw}": tile_ms(fn, call, full(th, tw), 20 if n == 1 else 5, tail)
                  for th, tw in sorted(tiles) if th * tw <= cap and full(th, tw) is not None}
            print(json.dumps({"device": torch.cuda.get_device_name(0), "model": args.model,
                              "int8": args.int8, "block": i, "batch": n, "h": h,
                              "cin": bd.cin, "e": e, "cout": cout, "k": k,
                              "stride": bd.stride, "se": se, "plan": plan, "ms": ms}),
                  flush=True)
        h = ho


def main(argv=None):
    from .ops import _build  # noqa: PLC0415

    p = argparse.ArgumentParser(prog="mobilenet_tpu_torch.ir_tiles")
    p.add_argument("--batch", type=int, nargs="+", default=[1, 256])
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--res", type=int, default=224)
    p.add_argument("--int8", action="store_true", help="time the int8 kernel")
    p.add_argument("--model", default="v2", choices=["v2", "v3", "v3small"],
                   help="v2 (default): MobileNet-V2's expanded blocks; v3 (v3small): "
                        "MobileNet-V3-Large's (-Small's) blocks")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mobilenet_tpu_torch.ir_tiles measures the card; "
                         "torch.cuda.is_available() is False")
    v3_rows(_build.library(), args, torch.Generator(device="cuda").manual_seed(0))


if __name__ == "__main__":
    main()
