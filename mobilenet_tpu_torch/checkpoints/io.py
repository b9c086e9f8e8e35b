"""Checkpoint subsystem: seeded weight init, BN folding, .npz save/load, and
the one-time move of the weights onto the device, and the importers of
published checkpoints: keras .h5 (legacy named and keras-3 layouts) and
TF-slim, for MobileNet-V1 here and in `v2.py` and `v3.py`.

Host-side arrays are float32 numpy, in the same NHWC/HWIO layouts and the
same flat-`.npz` key scheme ("blocks/3/dw/w") as the JAX package, so a file
either package saves loads in the other, and `init_params` gives the
bit-identical weight set for a seed.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig

Params = Dict[str, Any]


def _he_std(fan_in: int) -> float:
    return float(np.sqrt(2.0 / fan_in))


def init_params(config: ModelConfig, seed: int = 0) -> Params:
    """Deterministic, seeded reference weight set with non-trivial BN stats.

    The draw order follows the JAX package's `init_params` exactly: the same
    seed gives bit-identical float32 arrays in both packages.
    """
    rng = np.random.default_rng(seed)

    def bn(c):
        return {
            "gamma": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            "beta": rng.uniform(-0.2, 0.2, size=(c,)).astype(np.float32),
            "mean": rng.normal(0.0, 0.3, size=(c,)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        }

    c1 = config.stem_channels
    params: Params = {
        "conv1": {
            "w": (rng.standard_normal((3, 3, 3, c1)) * _he_std(27)).astype(np.float32),
            "bn": bn(c1),
        },
        "blocks": [],
        "fc": {},
    }
    c_in = c1
    for c_out in config.block_channels:
        params["blocks"].append(
            {
                "dw": {
                    "w": (rng.standard_normal((3, 3, 1, c_in)) * _he_std(9)).astype(np.float32),
                    "bn": bn(c_in),
                },
                "pw": {
                    "w": (rng.standard_normal((c_in, c_out)) * _he_std(c_in)).astype(np.float32),
                    "bn": bn(c_out),
                },
            }
        )
        c_in = c_out
    params["fc"] = {
        "w": (rng.standard_normal((c_in, config.num_classes)) * _he_std(c_in)).astype(
            np.float32
        ),
        "b": np.zeros((config.num_classes,), dtype=np.float32),
    }
    return params


def fold_weight(w: np.ndarray, bnp: Dict[str, np.ndarray], out_axis: int,
                eps: float):
    """One conv's BatchNorm folded into (weight, bias), float32 on host.

    s = gamma / sqrt(var + eps), b = beta - mean * s; the weight's
    output-channel axis absorbs s. Done in float64 then cast, as the JAX
    package does, so both packages hold the same folded bits.
    """
    s64 = bnp["gamma"].astype(np.float64) / np.sqrt(bnp["var"].astype(np.float64) + eps)
    b64 = bnp["beta"].astype(np.float64) - bnp["mean"].astype(np.float64) * s64
    shape = [1] * w.ndim
    shape[out_axis] = -1
    w_f = (w.astype(np.float64) * s64.reshape(shape)).astype(np.float32)
    return w_f, b64.astype(np.float32)


def fold_bn(params: Params, eps: float = 1e-3) -> Params:
    """Fold BatchNorm into conv weights + per-channel bias (float32, on
    host; `fold_weight` per conv)."""
    out: Params = {"blocks": []}
    w, b = fold_weight(params["conv1"]["w"], params["conv1"]["bn"], 3, eps)
    out["conv1"] = {"w": w, "b": b}
    for blk in params["blocks"]:
        dw_w, dw_b = fold_weight(blk["dw"]["w"], blk["dw"]["bn"], 3, eps)
        pw_w, pw_b = fold_weight(blk["pw"]["w"], blk["pw"]["bn"], 1, eps)
        out["blocks"].append({"dw": {"w": dw_w, "b": dw_b}, "pw": {"w": pw_w, "b": pw_b}})
    out["fc"] = {"w": np.asarray(params["fc"]["w"]), "b": np.asarray(params["fc"]["b"])}
    return out


def to_device(params: Params, device, dtype: torch.dtype = torch.float32) -> Params:
    """Move a host tree onto `device` once. Every float32 array, biases
    included, is cast to the compute dtype, as the JAX package does; other
    dtypes keep theirs. Tensors are contiguous."""

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [put(v) for v in x]
        arr = np.ascontiguousarray(np.asarray(x))
        t = torch.from_numpy(arr)
        if arr.dtype == np.float32:
            t = t.to(dtype)
        return t.to(device).contiguous()

    return put(params)


# ---------------------------------------------------------------------------
# On-disk format: flat .npz, keys are slash-joined paths ("blocks/3/dw/w").
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_npz(path: str, params: Params) -> None:
    flat = _flatten(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> Params:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# Importers of published checkpoints (h5py and tensorflow imported lazily).
# ---------------------------------------------------------------------------


def _keras3_store(path: str):
    """Read a keras-3 `.weights.h5` into {class_base: [per-layer var lists]}.

    Keras 3 `save_weights` keys layers by class-default names in creation
    order (`layers/conv2d_14/vars/0`), not by the application's layer names.
    Within one file the numeric suffix rises strictly in creation order, so
    sorting each class's groups by suffix recovers the model's layer
    schedule; the per-family mappers walk that schedule. BatchNormalization
    vars are [gamma, beta, moving_mean, moving_variance]; conv vars are
    [kernel(, bias)]. Returns None when the file is not in the keras-3
    layout (no top-level "layers" group: a legacy named .h5).
    """
    import re  # noqa: PLC0415

    import h5py  # noqa: PLC0415

    with h5py.File(path, "r") as f:
        if "layers" not in f:
            return None
        entries = []
        for name in f["layers"]:
            m = re.fullmatch(r"(.*?)(?:_(\d+))?", name)
            base, idx = m.group(1), int(m.group(2) or 0)
            grp = f["layers"][name]
            if "vars" not in grp or len(grp["vars"]) == 0:
                continue  # weightless layers (activations, pads, reshapes)
            arrs = [np.asarray(grp["vars"][str(i)]) for i in range(len(grp["vars"]))]
            entries.append((base, idx, arrs))
    store: Dict[str, list] = {}
    for base, _idx, arrs in sorted(entries, key=lambda e: (e[0], e[1])):
        store.setdefault(base, []).append(arrs)
    return store


def _k3_bn(v):
    return {"gamma": v[0], "beta": v[1], "mean": v[2], "var": v[3]}


def _k3_classes(store, *bases):
    """The class-base lists of a keras-3 store; a ValueError naming what is
    absent and what was found where a class is missing (a V1 file, with no
    Dense layer, given to the V2 importer; a writer that keys layers by the
    application's names)."""
    missing = [b for b in bases if b not in store]
    if missing:
        raise ValueError(
            f"unrecognized keras-3 layout: expected layer classes {list(bases)} but "
            f"{missing} are absent; found classes {sorted(store)} — wrong model "
            "family, or a .weights.h5 whose layers carry custom (non-class-default) names")
    return tuple(store[b] for b in bases)


def _legacy_h5(f):
    """(grp, bn_of) of an open legacy named keras .h5: `grp(name)` the layer's
    weight group (under "model_weights" where the file has it, the layer
    name repeated inside its group where it is), `bn_of(name)` a
    BatchNormalization layer's {gamma, beta, mean, var}."""
    mw = f["model_weights"] if "model_weights" in f else f

    def grp(name):
        g = mw[name]
        return g[name] if name in g else g

    def bn_of(name):
        g = grp(name)
        return {"gamma": np.asarray(g["gamma:0"]), "beta": np.asarray(g["beta:0"]),
                "mean": np.asarray(g["moving_mean:0"]),
                "var": np.asarray(g["moving_variance:0"])}

    return grp, bn_of


def _import_keras3_v1(store, config: ModelConfig) -> Params:
    """Map a keras-3 store onto the V1 tree. Creation order (keras
    mobilenet.py): Conv2D = [conv1, pw_1..pw_13, conv_preds]; DepthwiseConv2D
    = [dw_1..dw_13]; BatchNormalization = [conv1_bn] + [dw_i_bn, pw_i_bn]*13.
    """
    convs, dws, bns = _k3_classes(store, "conv2d", "depthwise_conv2d", "batch_normalization")
    n = len(config.block_channels)
    if len(convs) != n + 2 or len(dws) != n or len(bns) != 2 * n + 1:
        raise ValueError(
            f"keras-3 store shape mismatch: {len(convs)} convs/{len(dws)} dw/{len(bns)} bn "
            f"vs expected {n + 2}/{n}/{2 * n + 1} — wrong model family or truncated file")
    params: Params = {"conv1": {"w": convs[0][0], "bn": _k3_bn(bns[0])}, "blocks": []}
    for i in range(n):
        params["blocks"].append({
            "dw": {"w": dws[i][0].transpose(0, 1, 3, 2), "bn": _k3_bn(bns[1 + 2 * i])},
            "pw": {"w": convs[1 + i][0][0, 0], "bn": _k3_bn(bns[2 + 2 * i])},
        })
    preds = convs[n + 1]
    params["fc"] = {"w": preds[0].reshape(config.feature_channels, -1), "b": preds[1]}
    return params


def import_keras_h5(path: str, config: ModelConfig) -> Params:
    """Convert a keras MobileNet .h5 checkpoint into the raw V1 tree.

    Two on-disk layouts:
    - legacy named .h5 (what published keras<3 `save_weights` files hold):
      conv1, conv1_bn, conv_dw_{i}, conv_dw_{i}_bn, conv_pw_{i},
      conv_pw_{i}_bn, conv_preds;
    - keras-3 `.weights.h5`: class-default names in creation order
      (`_keras3_store`).
    Keras depthwise kernels are (3,3,C,1); the tree's are (3,3,1,C).
    """
    import h5py  # noqa: PLC0415

    store = _keras3_store(path)
    if store is not None:
        return _import_keras3_v1(store, config)
    with h5py.File(path, "r") as f:
        grp, bn_of = _legacy_h5(f)
        params: Params = {
            "conv1": {"w": np.asarray(grp("conv1")["kernel:0"]), "bn": bn_of("conv1_bn")},
            "blocks": [],
        }
        for i in range(1, 14):
            dw_k = np.asarray(grp(f"conv_dw_{i}")["depthwise_kernel:0"])  # (3,3,C,1)
            pw_k = np.asarray(grp(f"conv_pw_{i}")["kernel:0"])  # (1,1,Cin,Cout)
            params["blocks"].append({
                "dw": {"w": dw_k.transpose(0, 1, 3, 2), "bn": bn_of(f"conv_dw_{i}_bn")},
                "pw": {"w": pw_k[0, 0], "bn": bn_of(f"conv_pw_{i}_bn")},
            })
        preds = grp("conv_preds")
        params["fc"] = {
            "w": np.asarray(preds["kernel:0"]).reshape(config.feature_channels, -1),
            "b": np.asarray(preds["bias:0"]),
        }
    return params


def import_tf_slim(path: str, config: ModelConfig) -> Params:
    """Convert a TF-slim MobileNet-V1 checkpoint into the raw V1 tree.

    Variable names (tensorflow/models research/slim mobilenet_v1.py):

        MobilenetV1/Conv2d_0/weights                       (3,3,3,C1)
        MobilenetV1/Conv2d_0/BatchNorm/{gamma,beta,moving_mean,moving_variance}
        MobilenetV1/Conv2d_{i}_depthwise/depthwise_weights (3,3,C,1)
        MobilenetV1/Conv2d_{i}_depthwise/BatchNorm/...
        MobilenetV1/Conv2d_{i}_pointwise/weights           (1,1,Cin,Cout)
        MobilenetV1/Conv2d_{i}_pointwise/BatchNorm/...
        MobilenetV1/Logits/Conv2d_1c_1x1/{weights,biases}  (1,1,Cf,1001)

    Slim classifiers carry 1001 classes (index 0 the background); where
    config.num_classes is 1000 the background column is dropped, the usual
    ImageNet mapping. `path` is the checkpoint prefix (as for
    tf.train.load_checkpoint), e.g. ".../mobilenet_v1_1.0_224.ckpt". Needs
    tensorflow (its checkpoint reader only).
    """
    from tensorflow.python.training import py_checkpoint_reader  # noqa: PLC0415

    r = py_checkpoint_reader.NewCheckpointReader(path)

    def t(name):
        return np.asarray(r.get_tensor(f"MobilenetV1/{name}"), np.float32)

    def bn_of(scope):
        return {"gamma": t(f"{scope}/BatchNorm/gamma"), "beta": t(f"{scope}/BatchNorm/beta"),
                "mean": t(f"{scope}/BatchNorm/moving_mean"),
                "var": t(f"{scope}/BatchNorm/moving_variance")}

    params: Params = {"conv1": {"w": t("Conv2d_0/weights"), "bn": bn_of("Conv2d_0")},
                      "blocks": []}
    for i in range(1, 14):
        dw_k = t(f"Conv2d_{i}_depthwise/depthwise_weights")  # (3,3,C,1)
        pw_k = t(f"Conv2d_{i}_pointwise/weights")  # (1,1,Cin,Cout)
        params["blocks"].append({
            "dw": {"w": dw_k.transpose(0, 1, 3, 2), "bn": bn_of(f"Conv2d_{i}_depthwise")},
            "pw": {"w": pw_k[0, 0], "bn": bn_of(f"Conv2d_{i}_pointwise")},
        })
    fc_w = t("Logits/Conv2d_1c_1x1/weights")[0, 0]  # (Cf, 1001 or 1000)
    fc_b = t("Logits/Conv2d_1c_1x1/biases")
    if fc_w.shape[1] == config.num_classes + 1:
        fc_w, fc_b = fc_w[:, 1:], fc_b[1:]  # drop slim's background class
    params["fc"] = {"w": fc_w, "b": fc_b}
    return params
