"""Channel padding pass for V1: round narrow channel counts up to divisors
of 128, as the JAX package's `checkpoints/padding.py` does.

The alpha=0.75 family has channel counts (24, 48, 96) that divide neither
128 nor each other; the JAX package pads them (24->32, 48->64, 96->128) so
its lane-packed TPU kernels apply. The port's kernels take any multiple of
8, but the int8 device tree keeps the JAX package's padded shapes, so both
packages quantize one checkpoint to the same device weights. Zero-padded
channels have zero weights and bias and stay exactly 0 through every
requant; the classifier consumes the last block's channels (never padded),
so logits are unchanged bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _next_lane_divisor(c: int) -> int:
    """Smallest d >= c with 128 % d == 0 (for c < 128); c unchanged otherwise."""
    if c >= 128:
        return c
    d = c
    while 128 % d:
        d += 1
    return d


def _pad_to(arr, axis: int, target: int) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape[axis] >= target:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, widths)


def pad_channels(folded: Dict[str, Any]) -> Dict[str, Any]:
    """Zero-pad the narrow channel dims of a folded V1 tree (numpy leaves)."""
    c1p = _next_lane_divisor(folded["conv1"]["w"].shape[3])
    out: Dict[str, Any] = {
        "conv1": {"w": _pad_to(folded["conv1"]["w"], 3, c1p),
                  "b": _pad_to(folded["conv1"]["b"], 0, c1p)},
        "blocks": [],
    }
    prev = c1p
    n_blocks = len(folded["blocks"])
    for i, blk in enumerate(folded["blocks"]):
        cout = blk["pw"]["w"].shape[1]
        # never pad the final feature channels: the fc consumes them as-is
        coutp = cout if i == n_blocks - 1 else _next_lane_divisor(cout)
        out["blocks"].append({
            "dw": {"w": _pad_to(blk["dw"]["w"], 3, prev),
                   "b": _pad_to(blk["dw"]["b"], 0, prev)},
            "pw": {"w": _pad_to(_pad_to(blk["pw"]["w"], 0, prev), 1, coutp),
                   "b": _pad_to(blk["pw"]["b"], 0, coutp)},
        })
        prev = coutp
    out["fc"] = {"w": np.asarray(folded["fc"]["w"]), "b": np.asarray(folded["fc"]["b"])}
    return out


def needs_padding(folded: Dict[str, Any]) -> bool:
    c = folded["conv1"]["w"].shape[3]
    if c < 128 and 128 % c:
        return True
    return any(b["pw"]["w"].shape[1] < 128 and 128 % b["pw"]["w"].shape[1]
               for b in folded["blocks"][:-1])
