"""Checkpoint subsystem: seeded weight init, BN folding, .npz save/load, and
the one-time move of the weights onto the device.

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


def fold_bn(params: Params, eps: float = 1e-3) -> Params:
    """Fold BatchNorm into conv weights + per-channel bias (float32, on host).

    s = gamma / sqrt(var + eps), b = beta - mean * s; the weight's
    output-channel axis absorbs s. Done in float64 then cast, as the JAX
    package does, so both packages hold the same folded bits.
    """

    def fold(w: np.ndarray, bnp: Dict[str, np.ndarray], out_axis: int):
        s64 = bnp["gamma"].astype(np.float64) / np.sqrt(
            bnp["var"].astype(np.float64) + eps
        )
        b64 = bnp["beta"].astype(np.float64) - bnp["mean"].astype(np.float64) * s64
        shape = [1] * w.ndim
        shape[out_axis] = -1
        w_f = (w.astype(np.float64) * s64.reshape(shape)).astype(np.float32)
        return w_f, b64.astype(np.float32)

    out: Params = {"blocks": []}
    w, b = fold(params["conv1"]["w"], params["conv1"]["bn"], out_axis=3)
    out["conv1"] = {"w": w, "b": b}
    for blk in params["blocks"]:
        dw_w, dw_b = fold(blk["dw"]["w"], blk["dw"]["bn"], out_axis=3)
        pw_w, pw_b = fold(blk["pw"]["w"], blk["pw"]["bn"], out_axis=1)
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
