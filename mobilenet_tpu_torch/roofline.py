"""Per-block and per-segment roofline floors of the MobileNets on an H100.

    python -m mobilenet_tpu_torch.roofline [--model v1|v2|v3|v3small]
        [--alpha A] [--res R] [--batch N] [--int8] [--minimalistic]
        [--composition] [--achievable [PATH]]

The analytic part of the JAX package's tools/roofline.py, with the peak
rates as arguments (`Rates`) instead of module globals. For every segment
(V1: the stem, block 0, block 1, blocks 2-5, 6-12, the head) or block (V2,
V3) three floors:
  - mxu: the pointwise and convolution products (multiply-adds x 2) over
    the bf16 tensor-core rate;
  - vpu: the depthwise taps and their epilogue on the CUDA cores, each an
    FMA, over the float32 FMA rate;
  - hbm: activation bytes in and out over the memory rate (a fused block
    never writes its depthwise or expanded tensor; weights are left out);
and the binding one, their maximum; `--composition` adds the serial-phase
sum of a fused V2/V3 block's phases. Rates default to NVIDIA's H100 SXM
data sheet (989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores =
33.5e12 FMA/s, 3.35 TB/s); `--achievable` takes the rates that
`python -m mobilenet_tpu_torch.floors` measured on the card
(build/achievable_h100.json), the HBM rate keyed by channel width. The JAX
tool's `--measure` (prefix-differenced segment times on the TPU) is not
ported. Computes from shapes alone: no card needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

DEFAULT_ACHIEVABLE = Path(__file__).resolve().parents[1] / "build" / "achievable_h100.json"


@dataclasses.dataclass(frozen=True)
class Rates:
    """Peak rates: bf16 tensor-core FLOP/s, float32 CUDA-core FMA/s (an FMA
    one operation), HBM bytes/s; `hbm_by_channels` {width: bytes/s} keys the
    HBM rate by the nearest channel width (measured copy rates)."""

    mxu_flops: float = 989e12
    vpu_fmas: float = 33.5e12
    hbm_bps: float = 3.35e12
    hbm_by_channels: Optional[Dict[int, float]] = None

    def hbm(self, c: int) -> float:
        if self.hbm_by_channels is None:
            return self.hbm_bps
        return self.hbm_by_channels[min(self.hbm_by_channels, key=lambda k: abs(k - c))]


H100 = Rates()


def achievable_rates(path=DEFAULT_ACHIEVABLE) -> Tuple[Rates, Dict]:
    """The rates of a floors run (`floors.py`'s JSON) and the JSON itself."""
    data = json.loads(Path(path).read_text())
    return Rates(mxu_flops=data["mxu_tflops"] * 1e12, vpu_fmas=data["stencil_tfmas"] * 1e12,
                 hbm_by_channels={int(label.split("x")[1]): gbps * 1e9
                                  for label, gbps in data["hbm_copy_gbps"].items()}), data


def _row(mxu: float, vpu: float, hbm: float) -> Dict:
    floor = max(mxu, vpu, hbm)
    binding = ("mxu", "vpu", "hbm")[[mxu, vpu, hbm].index(floor)]
    return dict(floor_ms=floor * 1e3, binding=binding, mxu_ms=mxu * 1e3, vpu_ms=vpu * 1e3,
                hbm_ms=hbm * 1e3)


def block_floor(n, hi, cin, cout, stride, esz, rates: Rates = H100):
    """(mxu_s, vpu_s, hbm_s) of one fused depthwise-separable block."""
    ho = hi // stride
    mxu = n * ho * ho * cin * cout * 2 / rates.mxu_flops
    vpu = n * ho * ho * cin * (9 + 2) / rates.vpu_fmas  # 9 taps + bias and act
    hbm = (n * hi * hi * cin * esz / rates.hbm(cin)
           + n * ho * ho * cout * esz / rates.hbm(cout))
    return mxu, vpu, hbm


def _stem(cfg, n, esz, rates):
    """(mxu, vpu, hbm) of the uint8 read and the 3x3x3 stem convolution."""
    res, c1 = cfg.resolution, cfg.stem_channels
    ho = res // 2
    return (n * ho * ho * 27 * c1 * 2 / rates.mxu_flops, 0.0,
            n * res * res * 3 / rates.hbm(64) + n * ho * ho * c1 * esz / rates.hbm(c1))


def segment_floors(cfg, batch, esz, rates: Rates = H100) -> Dict[str, Dict]:
    """{segment: floors} of MobileNet-V1 (a ModelConfig): the stem, B0,
    B1, B2-B5, B6-B12 and the head (the pool's read and the fc)."""
    n = batch
    segs = {"conv1+pre": _stem(cfg, n, esz, rates)}
    per_block, hw, cin = [], cfg.resolution // 2, cfg.stem_channels
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        per_block.append(block_floor(n, hw, cin, cout, stride, esz, rates))
        hw //= stride
        cin = cout
    for lo, hi, label in ((0, 1, "B0"), (1, 2, "B1"), (2, 6, "B2-B5"), (6, 13, "B6-B12")):
        segs[label] = tuple(sum(v) for v in zip(*per_block[lo:hi]))
    segs["head"] = (n * cfg.feature_channels * cfg.num_classes * 2 / rates.mxu_flops, 0.0,
                    n * hw * hw * cin * esz / rates.hbm(cin))
    return {label: _row(*f) for label, f in segs.items()}


def ir_block_floor(n, hi, cin, e, cout, k, stride, se_mid, esz, rates: Rates = H100):
    """(mxu_s, vpu_s, hbm_s) of one fused V2/V3 bottleneck: the expanded
    tensor stays on chip, so HBM moves Cin in and Cout out; the products
    are the expansion, the projection and the SE's two; the CUDA cores run
    the k x k taps and three epilogue operations on the expanded width."""
    ho = hi // stride
    mxu = (n * (hi * hi * cin * e + ho * ho * e * cout)
           + (n * 2 * e * se_mid if se_mid else 0)) * 2 / rates.mxu_flops
    vpu = n * ho * ho * e * (k * k + 3) / rates.vpu_fmas
    hbm = (n * hi * hi * cin * esz / rates.hbm(cin)
           + n * ho * ho * cout * esz / rates.hbm(cout))
    return mxu, vpu, hbm


def _family_blocks(cfg):
    """(label, e, cout, k, stride, se, has_expand) of each V2 or V3 block,
    with its input side and width."""
    is_v3 = hasattr(cfg, "variant")
    hw, cin = cfg.resolution // 2, cfg.stem_channels
    for i, bd in enumerate(cfg.block_defs):
        if is_v3:
            e, cout, k, stride, se = bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid
            has_exp = bd.has_expand
        else:
            t, _, cout, stride = bd
            e, k, se = int(round(t * cin)), 3, 0
            has_exp = t != 1
        yield f"B{i:02d}", hw, cin, e, cout, k, stride, se, has_exp
        hw //= stride
        cin = cout


def family_block_composition(cfg, batch, rates: Rates = H100) -> Dict[str, Dict]:
    """Per-block serial-phase composition of a fused V2/V3 kernel: the
    expansion, the activation pass on the expanded width padded to 128
    ("padded") or not ("dense"), the k x k taps (stride 2 at twice the
    output width when padded), the epilogue, the SE gate's multiply and the
    projection, summed (not maxed) as the bound a kernel that runs its
    phases one after another must beat."""
    n, out = batch, {}
    for label, hw, cin, e, cout, k, stride, se, has_exp in _family_blocks(cfg):
        ep = -(-e // 128) * 128
        ho = hw // stride
        mxu_exp = (n * hw * hw * cin * ep * 2 / rates.mxu_flops) if has_exp else 0.0
        vpu_act = n * hw * hw * ep * 3 / rates.vpu_fmas
        acc_w = ho if stride == 1 else 2 * ho
        vpu_dw = n * ho * acc_w * ep * k * k / rates.vpu_fmas
        vpu_ep = n * ho * ho * ep * 3 / rates.vpu_fmas
        vpu_se = (n * ho * ho * ep * 2 / rates.vpu_fmas) if se else 0.0
        mxu_prj = n * ho * ho * ep * cout * 2 / rates.mxu_flops
        total = mxu_exp + vpu_act + vpu_dw + vpu_ep + vpu_se + mxu_prj
        dense = ((n * hw * hw * cin * e * 2 / rates.mxu_flops if has_exp else 0.0)
                 + n * hw * hw * e * 3 / rates.vpu_fmas
                 + n * ho * ho * e * k * k / rates.vpu_fmas
                 + n * ho * ho * e * 5 / rates.vpu_fmas
                 + n * ho * ho * e * cout * 2 / rates.mxu_flops)
        out[label] = dict(total_ms=total * 1e3, dense_ms=dense * 1e3, mxu_exp=mxu_exp * 1e3,
                          vpu_act=vpu_act * 1e3, vpu_dw=vpu_dw * 1e3, vpu_ep=vpu_ep * 1e3,
                          vpu_se=vpu_se * 1e3, mxu_prj=mxu_prj * 1e3)
    return out


def family_block_floors(cfg, batch, esz, rates: Rates = H100) -> Dict[str, Dict]:
    """{row: floors} of a V2Config or V3Config: the stem, each bottleneck
    and the head (conv_last; V3 also its two post-pool products)."""
    n = batch
    segs = {"conv1+pre": _stem(cfg, n, esz, rates)}
    hw, cin = cfg.resolution // 2, cfg.stem_channels
    for label, hw, cin, e, cout, k, stride, se, has_exp in _family_blocks(cfg):
        mxu, vpu, hbm = ir_block_floor(n, hw, cin, e, cout, k, stride, se, esz, rates)
        if not has_exp:  # no expansion conv: take its products back out
            mxu -= n * hw * hw * cin * e * 2 / rates.mxu_flops
        segs[label] = (mxu, vpu, hbm)
        hw //= stride
        cin = cout
    is_v3 = hasattr(cfg, "variant")
    cl = cfg.last_conv_channels if is_v3 else cfg.last_channels
    head_mac = hw * hw * cin * cl
    if is_v3:
        head_mac += cl * cfg.last_point_channels + cfg.last_point_channels * cfg.num_classes
    else:
        head_mac += cl * cfg.num_classes
    segs["head"] = (n * head_mac * 2 / rates.mxu_flops, 0.0,
                    n * hw * hw * cin * esz / rates.hbm(cin))
    return {label: _row(*f) for label, f in segs.items()}


def model_config(model: str, alpha: float = 1.0, res: int = 224, minimalistic: bool = False):
    """The port's configuration of v1 | v2 | v3 | v3small (bf16)."""
    from .config import ModelConfig
    from .models.mobilenet_v2 import V2Config
    from .models.mobilenet_v3 import V3Config

    if model == "v1":
        return ModelConfig(alpha=alpha, resolution=res, compute_dtype="bfloat16")
    if model == "v2":
        return V2Config(alpha=alpha, resolution=res, compute_dtype="bfloat16")
    return V3Config("large" if model == "v3" else "small", alpha, res,
                    minimalistic=minimalistic, compute_dtype="bfloat16")


def floors(model: str, batch: int = 256, esz: int = 2, rates: Rates = H100, **cfg_kw):
    """(config, {row: floors}) of a model: V1 by segment, V2/V3 by block."""
    cfg = model_config(model, **cfg_kw)
    fn = segment_floors if model == "v1" else family_block_floors
    return cfg, fn(cfg, batch, esz, rates)


def table(title: str, rows: Dict[str, Dict]) -> str:
    lines = [title, f"{'segment':>10} | {'mxu':>7} | {'vpu':>7} | {'hbm':>7} | "
                    f"{'floor':>7} | bind"]
    for label, f in rows.items():
        lines.append(f"{label:>10} | {f['mxu_ms']:7.3f} | {f['vpu_ms']:7.3f} | "
                     f"{f['hbm_ms']:7.3f} | {f['floor_ms']:7.3f} | {f['binding']:>4}")
    total = sum(f["floor_ms"] for f in rows.values())
    lines.append(f"{'TOTAL':>10} | {'':>7} | {'':>7} | {'':>7} | {total:7.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="v1", choices=["v1", "v2", "v3", "v3small"])
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--int8", action="store_true", help="1-byte activations between blocks")
    ap.add_argument("--minimalistic", action="store_true")
    ap.add_argument("--composition", action="store_true",
                    help="also the per-block serial-phase composition (V2/V3)")
    ap.add_argument("--achievable", nargs="?", const=str(DEFAULT_ACHIEVABLE), default=None,
                    help="the rates of a floors run (default build/achievable_h100.json)")
    args = ap.parse_args(argv)
    rates = H100
    if args.achievable:
        rates, data = achievable_rates(args.achievable)
        print(f"achievable rates ({data['nvidia_smi']}): mxu {data['mxu_tflops']:.1f} "
              f"TFLOP/s, CUDA-core {data['stencil_tfmas']:.3f} T-FMA/s, hbm "
              f"{data['hbm_copy_gbps']} GB/s")
    esz = 1 if args.int8 else 2
    kw = dict(alpha=args.alpha, res=args.res)
    if args.model != "v1":
        kw["minimalistic"] = args.minimalistic
    elif args.composition:
        ap.error("--composition models the fused V2/V3 bottleneck kernels")
    cfg, rows = floors(args.model, args.batch, esz, rates, **kw)
    print(table(f"{cfg.variant_name()} batch={args.batch} {'int8' if args.int8 else 'bf16'} "
                f"(floors in ms/batch)", rows))
    print(json.dumps({"variant": cfg.variant_name(), "batch": args.batch,
                      "dtype": "int8" if args.int8 else "bf16",
                      "rates": "achievable" if args.achievable else "published",
                      "floors_ms": {k: v["floor_ms"] for k, v in rows.items()},
                      "binding": {k: v["binding"] for k, v in rows.items()}}))
    if args.composition:
        comp = family_block_composition(cfg, args.batch, rates)
        print(f"{'block':>6} | {'padded':>7} | {'dense':>7}")
        for label, c in comp.items():
            print(f"{label:>6} | {c['total_ms']:7.3f} | {c['dense_ms']:7.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
