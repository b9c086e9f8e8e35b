"""MobileNet-V2 weight init and BN folding (the V2 twin of io.py's V1
functions).

Tree layout (the folded form that models.mobilenet_v2.forward_v2 reads):

    conv1:     {w (3,3,3,C1), b (C1,)}
    blocks[i]: {exp: {w (Cin, t*Cin), b}?,   # absent when t == 1
                dw:  {w (3,3,1,Ce), b},
                prj: {w (Ce, Cout), b}}      # linear: bias only, no activation
    conv_last: {w (C, last_channels), b}
    fc:        {w (last_channels, classes), b}

The same draw order and float64 folding as the JAX package's
`checkpoints/v2.py`, so a seed gives bit-identical trees in both packages;
io.save_npz/load_npz store either form.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.mobilenet_v2 import V2Config
from .io import Params, _he_std, fold_weight


def init_params_v2(config: V2Config, seed: int = 0) -> Params:
    """Deterministic, seeded reference weight set with non-trivial BN
    stats, drawn in the JAX package's order."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return {
            "gamma": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            "beta": rng.uniform(-0.2, 0.2, size=(c,)).astype(np.float32),
            "mean": rng.normal(0.0, 0.3, size=(c,)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        }

    def conv(shape, fan_in):
        return (rng.standard_normal(shape) * _he_std(fan_in)).astype(np.float32)

    c1 = config.stem_channels
    params: Params = {"conv1": {"w": conv((3, 3, 3, c1), 27), "bn": bn(c1)},
                      "blocks": []}
    for t, cin, cout, _stride in config.block_defs:
        ce = t * cin
        blk: Params = {}
        if t > 1:
            blk["exp"] = {"w": conv((cin, ce), cin), "bn": bn(ce)}
        blk["dw"] = {"w": conv((3, 3, 1, ce), 9), "bn": bn(ce)}
        blk["prj"] = {"w": conv((ce, cout), ce), "bn": bn(cout)}
        params["blocks"].append(blk)
    cl = config.last_channels
    c_in = config.block_defs[-1][2]
    params["conv_last"] = {"w": conv((c_in, cl), c_in), "bn": bn(cl)}
    params["fc"] = {"w": conv((cl, config.num_classes), cl),
                    "b": np.zeros((config.num_classes,), dtype=np.float32)}
    return params


def fold_bn_v2(params: Params, eps: float = 1e-3) -> Params:
    """Fold BN into each conv's weight and a per-channel bias (float64
    math, as io.fold_bn)."""

    def fold(layer: Dict[str, np.ndarray], out_axis: int) -> Dict[str, np.ndarray]:
        w, b = fold_weight(layer["w"], layer["bn"], out_axis, eps)
        return {"w": w, "b": b}

    out: Params = {"conv1": fold(params["conv1"], 3), "blocks": []}
    for blk in params["blocks"]:
        fblk: Params = {}
        if "exp" in blk:
            fblk["exp"] = fold(blk["exp"], 1)
        fblk["dw"] = fold(blk["dw"], 3)
        fblk["prj"] = fold(blk["prj"], 1)
        out["blocks"].append(fblk)
    out["conv_last"] = fold(params["conv_last"], 1)
    out["fc"] = {"w": np.asarray(params["fc"]["w"]), "b": np.asarray(params["fc"]["b"])}
    return out
