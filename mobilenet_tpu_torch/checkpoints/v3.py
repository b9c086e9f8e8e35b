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
`import_keras_h5_v3` reads a keras MobileNetV3 .h5 into the raw tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.mobilenet_v3 import V3Config
from .io import Params, _he_std, _k3_bn, _k3_classes, _keras3_store, _legacy_h5, fold_weight

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


def _import_keras3_v3(store, config: V3Config) -> Params:
    """Map a keras-3 `.weights.h5` store (io._keras3_store) onto the V3
    tree. Creation order (keras mobilenet_v3.py): Conv2D = [stem] +
    per-block([expand?] + [se_conv1, se_conv2 if SE] + [project]) +
    [Conv_1 (conv_last), Conv_2 (post-pool head), Logits]; DepthwiseConv2D
    = one per block; BatchNormalization = [stem_bn] + per-block([exp_bn?,
    dw_bn, prj_bn]) + [Conv_1_bn]. SE and head convs carry [kernel, bias]."""
    convs, dws, bns = _k3_classes(store, "conv2d", "depthwise_conv2d", "batch_normalization")
    n_exp = sum(1 for bd in config.block_defs if bd.has_expand)
    n_se = sum(1 for bd in config.block_defs if bd.se_mid)
    n_blk = len(config.block_defs)
    want = (1 + n_exp + 2 * n_se + n_blk + 3, n_blk, 1 + n_exp + 2 * n_blk + 1)
    if (len(convs), len(dws), len(bns)) != want:
        raise ValueError(
            f"keras-3 store shape mismatch: {len(convs)} convs/{len(dws)} dw/{len(bns)} bn "
            f"vs expected {want[0]}/{want[1]}/{want[2]} — wrong variant, alpha, or "
            "minimalistic flag")
    params: Params = {"conv1": {"w": convs[0][0], "bn": _k3_bn(bns[0])}, "blocks": []}
    ci = bi = 1
    for i, bd in enumerate(config.block_defs):
        blk: Params = {}
        if bd.has_expand:
            blk["exp"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
            ci += 1
            bi += 1
        blk["dw"] = {"w": dws[i][0].transpose(0, 1, 3, 2), "bn": _k3_bn(bns[bi])}
        bi += 1
        if bd.se_mid:
            se1, se2 = convs[ci], convs[ci + 1]
            ci += 2
            blk["se"] = {"w1": se1[0][0, 0], "b1": se1[1], "w2": se2[0][0, 0], "b2": se2[1]}
        blk["prj"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
        ci += 1
        bi += 1
        params["blocks"].append(blk)
    if ci != len(convs) - 3 or bi != len(bns) - 1:
        raise ValueError(
            f"keras-3 store walk mismatch: consumed {ci}/{len(convs)} convs, "
            f"{bi}/{len(bns)} bns with conv_last+head+logits / conv_last_bn "
            "expected to remain — wrong variant or minimalistic flag")
    params["conv_last"] = {"w": convs[ci][0][0, 0], "bn": _k3_bn(bns[bi])}
    head, logits = convs[ci + 1], convs[ci + 2]
    params["head"] = {"w": head[0][0, 0], "b": head[1]}
    params["fc"] = {"w": logits[0].reshape(config.last_point_channels, -1), "b": logits[1]}
    return params


def import_keras_h5_v3(path: str, config: V3Config) -> Params:
    """Convert a keras MobileNetV3 .h5 checkpoint into the raw V3 tree (the
    V3 twin of io.import_keras_h5).

    Two layouts, as in io.import_keras_h5. The legacy named .h5
    (keras.applications.mobilenet_v3) has slash-scoped names, which h5py
    resolves as nested groups: the stem Conv + Conv/BatchNorm; block i under
    `expanded_conv[_{i}]` with sublayers expand[/BatchNorm] (absent at block
    0), depthwise[/BatchNorm], squeeze_excite/Conv and squeeze_excite/Conv_1
    (bias convs, no BN), project[/BatchNorm]; the tail Conv_1[/BatchNorm],
    the post-pool head conv Conv_2 (bias) and the Logits 1x1 conv (bias).
    Keras-3 `.weights.h5` is the class-ordinal layout (`_import_keras3_v3`).
    Keras depthwise kernels are (k,k,C,1); the tree's are (k,k,1,C). The
    sublayers read follow config.block_defs, so the minimalistic variants
    (no SE) read cleanly."""
    import h5py  # noqa: PLC0415

    store = _keras3_store(path)
    if store is not None:
        return _import_keras3_v3(store, config)
    with h5py.File(path, "r") as f:
        grp, bn_of = _legacy_h5(f)
        params: Params = {
            "conv1": {"w": np.asarray(grp("Conv")["kernel:0"]), "bn": bn_of("Conv/BatchNorm")},
            "blocks": [],
        }
        for i, bd in enumerate(config.block_defs):
            pre = "expanded_conv" if i == 0 else f"expanded_conv_{i}"
            blk: Params = {}
            if bd.has_expand:
                blk["exp"] = {"w": np.asarray(grp(f"{pre}/expand")["kernel:0"])[0, 0],
                              "bn": bn_of(f"{pre}/expand/BatchNorm")}
            dw_k = np.asarray(grp(f"{pre}/depthwise")["depthwise_kernel:0"])
            blk["dw"] = {"w": dw_k.transpose(0, 1, 3, 2),
                         "bn": bn_of(f"{pre}/depthwise/BatchNorm")}
            if bd.se_mid:
                se1 = grp(f"{pre}/squeeze_excite/Conv")
                se2 = grp(f"{pre}/squeeze_excite/Conv_1")
                blk["se"] = {"w1": np.asarray(se1["kernel:0"])[0, 0],
                             "b1": np.asarray(se1["bias:0"]),
                             "w2": np.asarray(se2["kernel:0"])[0, 0],
                             "b2": np.asarray(se2["bias:0"])}
            blk["prj"] = {"w": np.asarray(grp(f"{pre}/project")["kernel:0"])[0, 0],
                          "bn": bn_of(f"{pre}/project/BatchNorm")}
            params["blocks"].append(blk)
        params["conv_last"] = {"w": np.asarray(grp("Conv_1")["kernel:0"])[0, 0],
                               "bn": bn_of("Conv_1/BatchNorm")}
        head = grp("Conv_2")
        params["head"] = {"w": np.asarray(head["kernel:0"])[0, 0],
                          "b": np.asarray(head["bias:0"])}
        logits = grp("Logits")
        params["fc"] = {
            "w": np.asarray(logits["kernel:0"]).reshape(config.last_point_channels, -1),
            "b": np.asarray(logits["bias:0"])}
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
