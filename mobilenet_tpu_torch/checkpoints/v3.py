"""MobileNet-V3 weight init and BN folding (the V3 twin of io.py's V1 and
v2.py's V2 functions).

Tree layout (the folded form that models.mobilenet_v3.forward_v3 reads):

    conv1:     {w (3,3,3,16), b}
    blocks[i]: {exp: {w (Cin, Ce), b}?,        # absent at block 0
                dw:  {w (k,k,1,Ce), b},        # k in {3, 5}
                se:  {w1 (Ce, Cr), b1, w2 (Cr, Ce), b2}?,  # bias convs, no BN
                prj: {w (Ce, Cout), b}}        # linear
    conv_last: {w (C, C6), b}                  # BN-folded + act
    head:      {w (C6, Cp), b}                 # bias conv, no BN (keras :345)
    fc:        {w (Cp, classes), b}

The same draw order and float64 folding as the JAX package's
`checkpoints/v3.py`, so a seed gives bit-identical trees in both packages.
The SE convs and the head conv carry a plain bias (zero in the seeded set)
and pass through folding unchanged. io.save_npz/load_npz store either form.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.mobilenet_v3 import V3Config
from .io import Params, _he_std, fold_weight

# Per-conv damping of the block weights: V3's unbounded ReLU and hard-swish
# chains have no ReLU6 re-bounding, so plain He init grows ~1.4x a block and
# Large's logits reach O(1e4) over 15 blocks; 0.8 keeps them O(30) (the JAX
# package's `_V3_BLOCK_GAIN`).
_V3_BLOCK_GAIN = 0.8


def init_params_v3(config: V3Config, seed: int = 0) -> Params:
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

    def conv(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    c1 = config.stem_channels
    params: Params = {"conv1": {"w": conv((3, 3, 3, c1), _he_std(27)), "bn": bn(c1)},
                      "blocks": []}
    g = _V3_BLOCK_GAIN
    for bd in config.block_defs:
        blk: Params = {}
        if bd.has_expand:
            blk["exp"] = {"w": conv((bd.cin, bd.cexp), g * _he_std(bd.cin)),
                          "bn": bn(bd.cexp)}
        k = bd.kernel
        blk["dw"] = {"w": conv((k, k, 1, bd.cexp), g * _he_std(k * k)), "bn": bn(bd.cexp)}
        if bd.se_mid:
            blk["se"] = {
                "w1": conv((bd.cexp, bd.se_mid), _he_std(bd.cexp)),
                "b1": np.zeros((bd.se_mid,), np.float32),
                "w2": conv((bd.se_mid, bd.cexp), _he_std(bd.se_mid)),
                "b2": np.zeros((bd.cexp,), np.float32),
            }
        blk["prj"] = {"w": conv((bd.cexp, bd.cout), g * _he_std(bd.cexp)), "bn": bn(bd.cout)}
        params["blocks"].append(blk)
    c_in = config.block_defs[-1].cout
    c6, cp = config.last_conv_channels, config.last_point_channels
    params["conv_last"] = {"w": conv((c_in, c6), _he_std(c_in)), "bn": bn(c6)}
    params["head"] = {"w": conv((c6, cp), _he_std(c6)), "b": np.zeros((cp,), np.float32)}
    params["fc"] = {"w": conv((cp, config.num_classes), _he_std(cp)),
                    "b": np.zeros((config.num_classes,), np.float32)}
    return params


def fold_bn_v3(params: Params, eps: float = 1e-3) -> Params:
    """Fold BN into each conv's weight and a per-channel bias (float64
    math, as io.fold_bn); the SE, head and fc entries pass through."""

    def fold(layer: Dict[str, np.ndarray], out_axis: int) -> Dict[str, np.ndarray]:
        w, b = fold_weight(layer["w"], layer["bn"], out_axis, eps)
        return {"w": w, "b": b}

    out: Params = {"conv1": fold(params["conv1"], 3), "blocks": []}
    for blk in params["blocks"]:
        fblk: Params = {}
        if "exp" in blk:
            fblk["exp"] = fold(blk["exp"], 1)
        fblk["dw"] = fold(blk["dw"], 3)
        if "se" in blk:
            fblk["se"] = {k: np.asarray(v) for k, v in blk["se"].items()}
        fblk["prj"] = fold(blk["prj"], 1)
        out["blocks"].append(fblk)
    out["conv_last"] = fold(params["conv_last"], 1)
    out["head"] = {"w": np.asarray(params["head"]["w"]), "b": np.asarray(params["head"]["b"])}
    out["fc"] = {"w": np.asarray(params["fc"]["w"]), "b": np.asarray(params["fc"]["b"])}
    return out
