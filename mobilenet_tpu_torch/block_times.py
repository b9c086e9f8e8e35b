"""Times of the separable-block kernel and the V1 chain on the card.

    python -m mobilenet_tpu_torch.block_times [--batch 256 1] [--yardsticks]

At each block shape of MobileNet-V1 1.0-224 (and V2 1.0-224's linear block
0 at batch 256), and at the V1 chain's five blocks at batch 1, times the
bf16 `separable_block` (`chain`): CUDA events a call at batch 256,
torch.profiler's device time a call at batch 1 (a launch there is shorter
than its host work). With --yardsticks also the plain versions and the
unfused library sequence (`separable_library`, which the port never
calls). Prints one JSON line: the card and {"b00 256": {"ms": ...}, ...}.
It calls only the kernels' public wrappers, so this file copied into an
archive of an earlier commit times that commit's kernels (PERF.md's A/B:
parent, change, change, parent in one card call). Refuses to run without a
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def separable_library(x, dw_w, dw_b, pw_w, pw_b, stride, relu6=True, pw_act=True):
    """The unfused library sequence of a separable block, a yardstick the
    port never calls: returns a function that runs cuDNN's grouped 3x3 conv
    on the channels-last view with TF-SAME padding (stride 2 on an even
    input: F.pad at the high end) + dw bias, clamp, then torch.matmul,
    + pw bias, clamp (none in the linear mode)."""
    import torch.nn.functional as F  # noqa: PLC0415

    c = x.shape[-1]
    wl = dw_w.reshape(3, 3, c).permute(2, 0, 1).unsqueeze(1).contiguous()
    hi = 6.0 if relu6 else None

    def run():
        xn = x.permute(0, 3, 1, 2)
        if stride == 2:
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), wl, dw_b, 2, 0, 1, c)
        else:
            y = F.conv2d(xn, wl, dw_b, 1, 1, 1, c)
        y = y.clamp_(0, hi).permute(0, 2, 3, 1).reshape(-1, c)
        z = torch.matmul(y, pw_w).add_(pw_b)
        return z.clamp_(0, hi) if pw_act else z

    return run


def device_ms(fn, reps: int = 30) -> float:
    """torch.profiler's device ms a call of fn (all its kernels), after
    warm-up."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[256, 1])
    p.add_argument("--yardsticks", action="store_true",
                   help="also the plain versions and the library sequence")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_times: needs a CUDA card")
    from .config import ModelConfig  # noqa: PLC0415
    from .floors import cuda_ms  # noqa: PLC0415
    from .ops.chain import chain, chain_plain  # noqa: PLC0415
    from .ops.separable_block import separable_block, separable_block_plain  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(n, h, cin, cout, k=None):
        def r(*shape, scale=1.0):
            t = torch.randn(*shape, generator=gen, device="cuda") * scale
            return t.bfloat16().contiguous()

        x = (torch.rand(n, h, h, cin, generator=gen, device="cuda") * 2 - 1).bfloat16()
        if k:
            return (x, r(k, 3, 3, cin, scale=0.5), r(k, cin, scale=0.2),
                    r(k, cin, cin, scale=cin ** -0.5), r(k, cin, scale=0.2))
        return (x, r(3, 3, 1, cin, scale=0.5), r(cin, scale=0.2),
                r(cin, cout, scale=cin ** -0.5), r(cout, scale=0.2))

    def times(batch, calls):
        timer = (lambda f: cuda_ms(f, reps=20, warmup=3)) if batch == 256 else device_ms
        return {k: timer(f) for k, f in calls.items()}

    cfg = ModelConfig(1.0, 224)
    out = {}
    for batch in args.batch:
        h, cin = cfg.resolution // 2, cfg.stem_channels
        for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
            a = operands(batch, h, cin, cout)
            calls = {"ms": lambda a=a, s=stride: separable_block(*a, s, True)}
            if args.yardsticks:
                calls["plain_ms"] = lambda a=a, s=stride: separable_block_plain(*a, s, True)
                calls["library_ms"] = separable_library(*a, stride, True)
            out[f"b{i:02d} {batch}"] = times(batch, calls)
            h, cin = -(-h // stride), cout
    if 256 in args.batch:
        a = operands(256, 112, 32, 16)
        calls = {"ms": lambda: separable_block(*a, 1, True, pw_act=False)}
        if args.yardsticks:
            calls["plain_ms"] = lambda: separable_block_plain(*a, 1, True, pw_act=False)
            calls["library_ms"] = separable_library(*a, 1, True, pw_act=False)
        out["v2b00 256"] = times(256, calls)
    if 1 in args.batch:
        a = operands(1, 14, 512, 512, k=5)
        calls = {"ms": lambda: chain(*a, True)}
        if args.yardsticks:
            calls["plain_ms"] = lambda: chain_plain(*a, True)
        out["chain 1"] = times(1, calls)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **out}),
          flush=True)


if __name__ == "__main__":
    main()
