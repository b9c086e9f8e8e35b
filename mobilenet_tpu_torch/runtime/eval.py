"""The end-to-end accuracy gate, its inputs, and the float verify gates.

`evaluate_agreement` is the JAX package's end-to-end gate (`cli eval`):
every image through the model's normal pipeline on the device (float:
`InferencePipeline`; int8: `Int8Pipeline`, `Int8PipelineV2`,
`Int8PipelineV3`) and through the golden oracle on the host on the same
folded weights (float: the NumPy twin `oracle/numpy_ref.py` or the C++
`cpu_ref`; int8: the NumPy int8 oracles, or for V1 the C++ int8 forward),
top-1 and top-k compared per image, near ties counted apart on the float
paths. The oracle's input is preprocessed on the host
(`numpy_ref.preprocess_batch_ref`), and the device's preprocessing is held
against it. Its inputs are a directory of images (`load_dir_images`: the native
decoder's thread pool, else PIL) or seeded ones (`synth_images`, the JAX
function copied verbatim, also the int8 V2 and V3 calibration set).

The float per-layer gate `verify_layers` is the JAX package's `cli verify`
(`cmd_verify`, `_verify_v2`, `_verify_v3`, one function choosing the
family's tolerance): every tap of the float32 plain route against an oracle
on the same folded weights and input, at the tolerances of
`utils/golden.py`. `verify_routing` is its `_verify_routing`: the logits of
a shipping route against the plain route's at one dtype."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config
from ..oracle import numpy_ref
from ..utils import golden

ORACLES = ("cpp", "numpy")
# The verify routings (the JAX package's names in brackets): "plain"
# ["xla"], "fused", "mixed", "auto", and on MobileNet-V1 "dw" ["pallas"].
ROUTINGS = ("plain", "fused", "mixed", "auto", "dw")


def _oracle(name: str):
    """The oracle module: `cpu_ref` ("cpp", built at first use) or
    `numpy_ref` ("numpy"); both have forward_all, _v2 and _v3."""
    if name == "cpp":
        from .. import cpu_ref  # noqa: PLC0415

        return cpu_ref
    if name == "numpy":
        return numpy_ref
    raise ValueError(f"oracle {name!r} not in {ORACLES}")


def _oracle_forward(oracle: str, config):
    mod = _oracle(oracle)
    if isinstance(config, V3Config):
        return mod.forward_all_v3
    if isinstance(config, V2Config):
        return mod.forward_all_v2
    return mod.forward_all


@torch.inference_mode()
def verify_layers(config, folded: Dict[str, Any], x_f32: np.ndarray, *,
                  oracle: str = "numpy", device="cuda") -> bool:
    """The float per-layer gate: every tap of the float32 plain route on
    `device` (the pipeline's activations) against the oracle on the same
    folded weights and input. MobileNet-V1 (conv1, blockNN_dw/_pw, pool,
    logits): golden.DW_TOL on depthwise taps, golden.MM_TOL on the rest.
    MobileNet-V2: golden.V2_TOL on every tap (the linear bottlenecks carry
    f32 noise unclipped). MobileNet-V3 (conv1, block{i:02d}_exp/_dw/_se/
    _prj/_out, conv_last, pool, head, logits): golden.V3_TOL (unbounded relu
    and hard-swish activations of O(30), the SE gates' pooled products).
    Prints one LayerReport line per tap, then "VERIFY OK: all N layers
    match (...)" or "VERIFY FAILED at <tap>"; a tap that the route and the
    oracle do not both produce at one shape fails there."""
    from .pipeline import InferencePipeline  # noqa: PLC0415

    cfg = dataclasses.replace(config, compute_dtype="float32")
    tol = (golden.V3_TOL if isinstance(cfg, V3Config)
           else golden.V2_TOL if isinstance(cfg, V2Config) else None)
    pipe = InferencePipeline(cfg, folded, device=device, dw_backend="plain")
    _, acts = pipe.activations(x_f32)
    _, ref = _oracle_forward(oracle, cfg)(folded, np.asarray(x_f32, np.float32), cfg)
    unpaired = [n for n in ref if n not in acts or acts[n].shape != ref[n].shape]
    unpaired += [n for n in acts if n not in ref]
    for n in unpaired:
        print(f"[FAIL] {n:14s} route {getattr(acts.get(n), 'shape', 'missing')} vs "
              f"oracle {getattr(ref.get(n), 'shape', 'missing')}")
    reports = [] if unpaired else golden.compare_activations(
        acts, ref, tols=None if tol is None else {n: tol for n in ref})
    for r in reports:
        print(r)
    bad = unpaired[0] if unpaired else getattr(golden.first_divergence(reports), "name", None)
    if bad is None:
        print(f"VERIFY OK: all {len(reports)} layers match ({oracle} oracle, "
              f"{cfg.variant_name()})")
        return True
    print(f"VERIFY FAILED at {bad}")
    return False


def _route_backend(config, routing: str):
    """A verify routing name -> the model's dw_backend. MobileNet-V1's
    "mixed" is the JAX package's: plain ops on the two 112-squared blocks,
    fused from block 2 on (the port's V1 routing takes it as a per-block
    tuple); "dw" is a MobileNet-V1 routing."""
    if routing not in ROUTINGS:
        raise ValueError(f"routing {routing!r} not in {ROUTINGS}")
    if isinstance(config, (V2Config, V3Config)):
        if routing == "dw":
            raise ValueError("routing 'dw' is a MobileNet-V1 routing; the V2 and V3 "
                             "families race plain against fused, mixed or auto")
        return routing
    if routing == "mixed":
        return ("plain",) * 2 + ("fused",) * (len(config.block_strides) - 2)
    return routing


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(a * a)))


@torch.inference_mode()
def verify_routing(config, folded: Dict[str, Any], x_f32: np.ndarray, routing: str, *,
                   dtype: str = "float32", oracle: str = "numpy", device="cuda") -> bool:
    """The routing gate (logits): a shipping route ("fused", "mixed",
    "auto", "dw") against the plain route of the same weights and input at
    `dtype`, end to end. float32: within (2e-4, 2e-3). bfloat16: the
    scale-aware golden.routing_bf16_atol (rtol 5e-2), and the route's RMS
    distance from the float32 oracle within ROUTING_ANCHOR_FACTOR x the
    plain route's + ROUTING_BF16_ATOL. Top-1 must agree row for row except
    between classes the plain route holds within the gate's atol (a near
    tie). The oracle's top-1 is printed beside, unchecked."""
    from .pipeline import InferencePipeline  # noqa: PLC0415

    backend = _route_backend(config, routing)
    cfg = dataclasses.replace(config, compute_dtype=dtype)
    pipe = InferencePipeline(cfg, folded, device=device, dw_backend="plain")
    x = torch.from_numpy(np.asarray(x_f32, np.float32)).to(pipe.device).to(pipe.dtype)

    def logits(route):
        out = pipe._forward(pipe.params, x, cfg, dw_backend=route)
        return out.float().cpu().numpy()

    got, ref = logits(backend), logits("plain")
    ora = np.asarray(_oracle_forward(oracle, cfg)(
        folded, np.asarray(x_f32, np.float32), cfg)[0], np.float32)
    anchor_ok = True
    if dtype == "bfloat16":
        atol = golden.routing_bf16_atol(float(np.abs(ref).max()), _rms(got - ref), got.size)
        rtol = 5e-2
        d_got, d_ref = _rms(got - ora), _rms(ref - ora)
        anchor = golden.ROUTING_ANCHOR_FACTOR * d_ref + golden.ROUTING_BF16_ATOL
        anchor_ok = d_got <= anchor
        print(f"[{'OK ' if anchor_ok else 'FAIL'}] oracle anchor (rms): "
              f"|{routing}-fp32|={d_got:.4f} vs {golden.ROUTING_ANCHOR_FACTOR}x"
              f"|plain-fp32|+atol={anchor:.4f} (max_abs {float(np.abs(got - ora).max()):.3f} "
              f"vs {float(np.abs(ref - ora).max()):.3f} [informational])")
    elif dtype == "float32":
        atol, rtol = 2e-4, 2e-3
    else:
        raise ValueError(f"dtype {dtype!r} is not float32 or bfloat16")
    report = golden.compare_activations({"logits": got}, {"logits": ref},
                                        tols={"logits": (atol, rtol)})[0]
    print(report)
    agree = got.argmax(-1) == ref.argmax(-1)
    srt = np.sort(ref, axis=-1)
    near_tie = (~agree) & (srt[:, -1] - srt[:, -2] < atol)
    top1_ok = bool((agree | near_tie).all())
    tie_note = (f" ({int(near_tie.sum())} near-tie flips within atol={atol}, not gated)"
                if near_tie.any() else "")
    print(f"top-1 routing({routing}) == routing(plain): {int(agree.sum())}/{len(got)}"
          f"{tie_note}")
    print(f"top-1 routing({routing}) == {oracle} oracle (fp32): "
          f"{int((got.argmax(-1) == ora.argmax(-1)).sum())}/{len(got)} [informational]")
    ok = report.ok and top1_ok and anchor_ok
    print(f"ROUTING VERIFY {'OK' if ok else 'FAILED'}: {routing} vs plain @ "
          f"{cfg.variant_name()} {dtype} batch={len(got)}")
    return ok


def synth_images(config: ModelConfig, n: int, seed: int,
                 structured: bool = True) -> List[np.ndarray]:
    """Seeded uint8 images at native resolution (no-network stand-in for
    sample ImageNet images).

    structured=True (default) cycles four deterministic families instead of
    pure noise — noise, linear gradients, block patches/checkerboards, and
    smooth low-frequency blobs. Natural-image-like structure stresses the
    resize/normalize path and produces less-uniform logits than iid noise,
    so top-1 margins vary more realistically.
    structured=False gives pure noise."""
    rng = np.random.default_rng(seed)
    res = config.resolution
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / max(res - 1, 1)
    images: List[np.ndarray] = []
    for i in range(n):
        kind = i % 4 if structured else 0
        if kind == 0:  # iid noise
            img = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        elif kind == 1:  # linear gradient, random direction/colors per channel
            a, b = rng.uniform(-1, 1, 2)
            t = (a * xx + b * yy - min(a, 0) - min(b, 0)) / (abs(a) + abs(b) + 1e-6)
            lo, hi = rng.integers(0, 256, (2, 3))
            img = (lo + t[..., None] * (hi.astype(np.float32) - lo)).astype(np.uint8)
        elif kind == 2:  # block patches (checkerboard-like, random cell size)
            cell = int(rng.integers(4, max(5, res // 4)))
            gy = (np.arange(res) // cell)
            colors = rng.integers(0, 256, (gy.max() + 1, gy.max() + 1, 3))
            img = colors[gy[:, None], gy[None, :]].astype(np.uint8)
        else:  # smooth low-frequency blobs (sums of 2-D sinusoids)
            img = np.zeros((res, res, 3), np.float32)
            for c in range(3):
                fx, fy = rng.uniform(0.5, 4.0, 2)
                px, py = rng.uniform(0, 2 * np.pi, 2)
                img[..., c] = (np.sin(2 * np.pi * fx * xx + px)
                               * np.sin(2 * np.pi * fy * yy + py))
            img = ((img + 1) * 127.5).astype(np.uint8)
        images.append(img)
    return images


def preprocess_tol(h: int, w: int) -> float:
    """The device's preprocessed (h, w) image against the host's reference
    (numpy_ref.preprocess_batch_ref), in the [-1, 1] output: a float32
    source coordinate is exact to within ~1.5 eps x max(h, w) pixels (taken
    as 2), two neighbours differ by at most 2 in the output, and 1e-5 covers
    the sums' rounding. At 400 pixels 1.9e-4; one uint8 step is 7.8e-3."""
    return 1e-5 + 4 * float(np.finfo(np.float32).eps) * max(h, w)


def _topk_rows(scores: np.ndarray, k: int) -> np.ndarray:
    return np.argsort(-scores, axis=-1)[:, :k]


def load_dir_images(path: str) -> List[np.ndarray]:
    """Decode every readable image directly under `path`, in name order.

    The native decoder's thread pool (`native_io.decode_batch`, off the
    interpreter lock) where it builds on this machine, and PIL for each file
    it refuses; PIL file by file where it does not build. Files that neither
    decodes are skipped; a directory with no image raises ValueError."""
    import os  # noqa: PLC0415

    from .. import native_io  # noqa: PLC0415
    from ..ops.preprocess import decode_image_host  # noqa: PLC0415

    paths = [os.path.join(path, name) for name in sorted(os.listdir(path))
             if os.path.isfile(os.path.join(path, name))]
    decoded = (native_io.decode_batch(paths, strict=False) if native_io.available()
               else [None] * len(paths))
    images: List[np.ndarray] = []
    for full, img in zip(paths, decoded):
        if img is None:  # no native decoder, or a file it refuses (BMP, GIF, ...)
            try:
                img = decode_image_host(full, backend="pil")
            except (OSError, ValueError):
                continue  # not an image
        images.append(img)
    if not images:
        raise ValueError(f"no decodable images found under {path!r}")
    return images


def _oracle_scores(folded, q, x: np.ndarray, config, *, int8: bool,
                   oracle: str) -> np.ndarray:
    """Golden logits of a preprocessed float32 batch `x` (resize is not an
    oracle layer: the caller preprocesses). `q` is the quantized
    tree of the int8 path, made once by the caller. int8: V2 and V3 have
    only the NumPy int8 oracle (`quant/v2`, `quant/v3`); V1 takes the C++
    int8 forward or the NumPy one."""
    if not int8:
        logits, _ = _oracle_forward(oracle, config)(folded, x, config)
        return np.asarray(logits, np.float32)
    from ..quant import quantize_input  # noqa: PLC0415

    x_i8 = quantize_input(x)
    if isinstance(config, V2Config):
        from ..quant.v2 import forward_all_v2_i8 as forward  # noqa: PLC0415
    elif isinstance(config, V3Config):
        from ..quant.v3 import forward_all_v3_i8 as forward  # noqa: PLC0415
    elif oracle == "cpp":
        from ..quant.verify import _cpp_forward_all as forward  # noqa: PLC0415
    else:
        from ..quant.oracle import forward_all as forward  # noqa: PLC0415
    logits, _ = forward(q, x_i8, config)
    return np.asarray(logits, np.float32)


def evaluate_agreement(
    config: ModelConfig,
    images: Sequence[np.ndarray],
    *,
    params: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    int8: bool = False,
    oracle: str = "numpy",
    batch_size: int = 16,
    top_k: int = 5,
    tie_margin: float = 0.0,
    device="cuda",
) -> Dict[str, Any]:
    """Every image through the device pipeline and the golden oracle; the
    report of top-1 and top-k agreement. `images`: HWC uint8 arrays of any
    sizes. `params`: a folded tree, else the seeded set of `seed`.
    `device`: "cuda" (default), "cuda:N" or "cpu".

    `tie_margin`: the relative oracle-logit margin under which a top-1
    disagreement counts as a near tie, not a mismatch, in
    `top1_agreement_tie_aware`. The float device path is gated by a
    tolerance against the float32 oracle, not bit for bit, so two logits
    within rounding of each other can swap top-1; with random weights such
    thin margins are common. `top1_agreement` is reported unmodified; int8
    is exact, so the two can differ only on the float paths.

    Images are grouped by shape and run in batches of `batch_size` within a
    group; a group's trailing partial batch is padded with copies of its
    first image to the batch size (when the group holds more than one
    batch), so that each group runs one batch shape.

    The oracle's input is the host's: `numpy_ref.preprocess_batch_ref`,
    without the code under test. The device's own preprocessing of each
    batch must agree with it within `preprocess_tol`, else ValueError; the
    int8 oracle reads the device's batch (its input quantization wants the
    very same floats)."""
    from ..checkpoints import default_folded  # noqa: PLC0415
    from ..ops.preprocess import preprocess  # noqa: PLC0415
    from ..quant import quantize  # noqa: PLC0415
    from .serving import build_pipeline  # noqa: PLC0415

    folded = params if params is not None else default_folded(config, seed=seed)
    pipe = build_pipeline(config, device=device, params=folded, int8=int8)
    # The oracle's quantized tree: V2 and V3 reuse the pipeline's calibrated
    # one (calibration runs an oracle sweep); V1 quantizes `folded` again,
    # without the channel padding the device tree may carry (padded
    # channels are zeros: the logits are the same).
    q = None
    if int8:
        q = pipe.q if isinstance(config, (V2Config, V3Config)) else quantize(folded, config)

    n = len(images)
    dev_top = np.zeros((n, top_k), np.int64)
    ora_top = np.zeros((n, top_k), np.int64)
    # The oracle-logit margin between the oracle's top-1 and the device's
    # top-1 class, relative to max(1, |top-1 logit|): 0 where they agree,
    # tiny where a near tie flipped, large on a real mismatch.
    rel_margin = np.zeros(n, np.float64)

    by_shape: Dict[tuple, List[int]] = {}
    for i, img in enumerate(images):
        by_shape.setdefault(img.shape, []).append(i)

    for idxs in by_shape.values():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            batch = np.stack([images[i] for i in chunk])
            if len(chunk) < batch_size and len(idxs) > batch_size:
                pad = np.repeat(batch[:1], batch_size - len(chunk), axis=0)
                batch = np.concatenate([batch, pad])
            probs = pipe.run_batch(batch)[: len(chunk)]
            dev_top[chunk] = _topk_rows(probs, top_k)
            x_ref = numpy_ref.preprocess_batch_ref(batch[: len(chunk)], config.resolution)
            with torch.inference_mode():
                x_dev = preprocess(pipe._to_device(batch[: len(chunk)]), config.resolution,
                                   torch.float32).cpu().numpy()
            err = float(np.abs(x_dev - x_ref).max())
            tol = preprocess_tol(*batch.shape[1:3])
            if err > tol:
                raise ValueError(
                    f"the device's preprocessing of images {chunk} ({batch.shape[1:]}) "
                    f"differs from the host reference by {err!r} > {tol!r}")
            # int8 quantizes the input: its oracle reads the device's own
            # preprocessed batch, just held against the host's, so that a
            # last-bit difference cannot move a quantization step
            golden_logits = _oracle_scores(folded, q, x_dev if int8 else x_ref, config,
                                           int8=int8, oracle=oracle)
            ora_top[chunk] = _topk_rows(golden_logits, top_k)
            rows = np.arange(len(chunk))
            g_ora1 = golden_logits[rows, ora_top[chunk, 0]]
            g_dev1 = golden_logits[rows, dev_top[chunk, 0]]
            rel_margin[chunk] = (g_ora1 - g_dev1) / np.maximum(1.0, np.abs(g_ora1))

    top1_match = dev_top[:, 0] == ora_top[:, 0]
    near_tie = ~top1_match & (rel_margin <= tie_margin)
    # the share of the oracle's top-k set that the device also ranks in its
    # top-k (order aside: last-bit ties may swap neighbouring ranks)
    topk_overlap = np.array([len(set(dev_top[i]) & set(ora_top[i])) / top_k
                             for i in range(n)])
    mismatches = [
        {"index": int(i), "device_top1": int(dev_top[i, 0]),
         "oracle_top1": int(ora_top[i, 0]),
         "oracle_rel_margin": float(rel_margin[i]),
         "near_tie": bool(near_tie[i])}
        for i in np.nonzero(~top1_match)[0]
    ]
    return {
        "n_images": n,
        # unrounded: `cli eval` gates on these, and rounding could hide a
        # lone mismatch in a large set; the print site rounds
        "top1_agreement": float(top1_match.mean()),
        "top1_agreement_tie_aware": float((top1_match | near_tie).mean()),
        "near_ties": int(near_tie.sum()),
        f"top{top_k}_overlap": float(topk_overlap.mean()),
        "dtype": "int8" if int8 else config.compute_dtype,
        "oracle": oracle,
        "tie_margin": tie_margin,
        "mismatches": mismatches,
    }
