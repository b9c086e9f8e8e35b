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
io.save_npz/load_npz store either form. `import_keras_h5_v2` reads a keras
MobileNetV2 .h5 into the raw tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.mobilenet_v2 import V2Config
from .io import Params, _he_std, _k3_bn, _k3_classes, _keras3_store, _legacy_h5, fold_weight


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


def _import_keras3_v2(store, config: V2Config) -> Params:
    """Map a keras-3 `.weights.h5` store (io._keras3_store) onto the V2
    tree. Creation order (keras mobilenet_v2.py): Conv2D = [Conv1] +
    per-block([expand if t>1] + [project]) + [Conv_1]; DepthwiseConv2D = one
    per block; BatchNormalization = [bn_Conv1] + per-block([exp_bn?, dw_bn,
    prj_bn]) + [Conv_1_bn]; Dense = [predictions]."""
    convs, dws, bns, dense_l = _k3_classes(
        store, "conv2d", "depthwise_conv2d", "batch_normalization", "dense")
    dense = dense_l[0]
    n_exp = sum(1 for t, *_ in config.block_defs if t > 1)
    n_blk = len(config.block_defs)
    want = (1 + n_exp + n_blk + 1, n_blk, 1 + n_exp + 2 * n_blk + 1)
    if (len(convs), len(dws), len(bns)) != want:
        raise ValueError(
            f"keras-3 store shape mismatch: {len(convs)} convs/{len(dws)} dw/{len(bns)} bn "
            f"vs expected {want[0]}/{want[1]}/{want[2]} — wrong model family or alpha")
    params: Params = {"conv1": {"w": convs[0][0], "bn": _k3_bn(bns[0])}, "blocks": []}
    ci = bi = 1
    for i, (t, _cin, _cout, _s) in enumerate(config.block_defs):
        blk: Params = {}
        if t > 1:
            blk["exp"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
            ci += 1
            bi += 1
        blk["dw"] = {"w": dws[i][0].transpose(0, 1, 3, 2), "bn": _k3_bn(bns[bi])}
        bi += 1
        blk["prj"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
        ci += 1
        bi += 1
        params["blocks"].append(blk)
    if ci != len(convs) - 1 or bi != len(bns) - 1:
        raise ValueError(
            f"keras-3 store walk mismatch: consumed {ci}/{len(convs)} convs, "
            f"{bi}/{len(bns)} bns with one of each expected to remain — "
            "wrong model family or alpha")
    params["conv_last"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
    params["fc"] = {"w": dense[0].reshape(config.last_channels, -1), "b": dense[1]}
    return params


def import_keras_h5_v2(path: str, config: V2Config) -> Params:
    """Convert a keras MobileNetV2 .h5 checkpoint into the raw V2 tree (the
    V2 twin of io.import_keras_h5).

    Two layouts, as in io.import_keras_h5: legacy named .h5 (Conv1 /
    bn_Conv1; block 0 expanded_conv_{depthwise,project}[_BN], no expand
    conv; blocks 1..16 block_{i}_{expand,depthwise,project}[_BN]; the tail
    Conv_1 / Conv_1_bn and the `predictions` Dense) and keras-3
    `.weights.h5` (`_import_keras3_v2`). Keras depthwise kernels are
    (3,3,C,1); the tree's are (3,3,1,C)."""
    import h5py  # noqa: PLC0415

    store = _keras3_store(path)
    if store is not None:
        return _import_keras3_v2(store, config)
    with h5py.File(path, "r") as f:
        grp, bn_of = _legacy_h5(f)
        params: Params = {
            "conv1": {"w": np.asarray(grp("Conv1")["kernel:0"]), "bn": bn_of("bn_Conv1")},
            "blocks": [],
        }
        for i, (t, _cin, _cout, _s) in enumerate(config.block_defs):
            pre = "expanded_conv" if i == 0 else f"block_{i}"
            blk: Params = {}
            if t > 1:
                blk["exp"] = {"w": np.asarray(grp(f"{pre}_expand")["kernel:0"])[0, 0],
                              "bn": bn_of(f"{pre}_expand_BN")}
            dw_k = np.asarray(grp(f"{pre}_depthwise")["depthwise_kernel:0"])
            blk["dw"] = {"w": dw_k.transpose(0, 1, 3, 2), "bn": bn_of(f"{pre}_depthwise_BN")}
            blk["prj"] = {"w": np.asarray(grp(f"{pre}_project")["kernel:0"])[0, 0],
                          "bn": bn_of(f"{pre}_project_BN")}
            params["blocks"].append(blk)
        params["conv_last"] = {"w": np.asarray(grp("Conv_1")["kernel:0"])[0, 0],
                               "bn": bn_of("Conv_1_bn")}
        preds = grp("predictions")
        params["fc"] = {"w": np.asarray(preds["kernel:0"]).reshape(config.last_channels, -1),
                        "b": np.asarray(preds["bias:0"])}
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
