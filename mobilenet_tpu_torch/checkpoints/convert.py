"""Weights from the JAX package, and the layouts the kernels want at load.

`from_jax_params` (V1), `from_jax_params_v2` and `from_jax_params_v3` take
the JAX package's folded tree as numpy arrays (the same nested dict/list
scheme and NHWC/HWIO layouts this package uses) and return device tensors
ready for `models.mobilenet_v1.forward` / `models.mobilenet_v2.forward_v2` /
`models.mobilenet_v3.forward_v3`. The tests use them so that both packages
compute on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chain import stride1_runs
from .io import Params, to_device


def prepare_kernel_layouts(params: Params, strides) -> Params:
    """Add the stacked per-run weights the chain kernel reads, once, under
    params["chain"][start] = (dw_ws (K,3,3,C), dw_bs (K,C), pw_ws (K,C,C),
    pw_bs (K,C)). The per-block kernels read the tree's own tensors."""
    shapes = [tuple(b["pw"]["w"].shape) for b in params["blocks"]]
    runs = stride1_runs(shapes, strides, [True] * len(strides))
    chain = {i: stack_run(params["blocks"][i:i + run]) for i, run in runs.items()}
    return {**params, "chain": chain}


def stack_run(blks) -> tuple:
    """(dw_ws (K,3,3,C), dw_bs (K,C), pw_ws (K,C,C), pw_bs (K,C)) of a run
    of blocks, contiguous."""
    return (
        torch.stack([b["dw"]["w"].reshape(3, 3, -1) for b in blks]),
        torch.stack([b["dw"]["b"] for b in blks]),
        torch.stack([b["pw"]["w"] for b in blks]),
        torch.stack([b["pw"]["b"] for b in blks]),
    )


def from_jax_params(tree: Params, device, dtype: torch.dtype, strides) -> Params:
    """JAX folded tree (numpy leaves) -> this package's device tensors, with
    the chain stacks prepared. Raises on a tree that is not a folded V1
    tree."""
    for key in ("conv1", "blocks", "fc"):
        if key not in tree:
            raise ValueError(f"not a folded V1 tree: missing {key!r}")
    if "conv_last" in tree:
        raise ValueError("a V2 tree (it has conv_last): use from_jax_params_v2")
    if len(tree["blocks"]) != len(strides):
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, "
                         f"config has {len(strides)}")
    host = {
        "conv1": {k: np.asarray(v) for k, v in tree["conv1"].items()},
        "blocks": [{layer: {k: np.asarray(v) for k, v in blk[layer].items()}
                    for layer in ("dw", "pw")} for blk in tree["blocks"]],
        "fc": {k: np.asarray(v) for k, v in tree["fc"].items()},
    }
    return prepare_kernel_layouts(to_device(host, device, dtype), strides)


def from_jax_params_v2(tree: Params, device, dtype: torch.dtype, config) -> Params:
    """JAX folded V2 tree (numpy leaves) -> this package's device tensors.
    Raises on a tree that is not a folded V2 tree of `config` (a V2Config):
    the block count, each block's expansion and the projection widths must
    match `config.block_defs`."""
    for key in ("conv1", "blocks", "conv_last", "fc"):
        if key not in tree:
            raise ValueError(f"not a folded V2 tree: missing {key!r}")
    defs = config.block_defs
    if len(tree["blocks"]) != len(defs):
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config has {len(defs)}")
    for i, ((t, cin, cout, _s), blk) in enumerate(zip(defs, tree["blocks"])):
        if ("exp" in blk) != (t > 1) or tuple(np.shape(blk["prj"]["w"])) != (t * cin, cout):
            raise ValueError(f"block {i} does not match (t={t}, {cin}->{cout})")
    return to_device(tree, device, dtype)


def from_jax_params_v3(tree: Params, device, dtype: torch.dtype, config) -> Params:
    """JAX folded V3 tree (numpy leaves) -> this package's device tensors.
    Raises on a tree that is not a folded V3 tree of `config` (a V3Config):
    the block count and each block's expansion, depthwise kernel, SE and
    projection shapes must match `config.block_defs`."""
    for key in ("conv1", "blocks", "conv_last", "head", "fc"):
        if key not in tree:
            raise ValueError(f"not a folded V3 tree: missing {key!r}")
    defs = config.block_defs
    if len(tree["blocks"]) != len(defs):
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config has {len(defs)}")
    for i, (bd, blk) in enumerate(zip(defs, tree["blocks"])):
        shapes = {name: tuple(np.shape(blk[name]["w"])) for name in ("dw", "prj")}
        ok = (("exp" in blk) == bd.has_expand and ("se" in blk) == bool(bd.se_mid)
              and shapes["dw"] == (bd.kernel, bd.kernel, 1, bd.cexp)
              and shapes["prj"] == (bd.cexp, bd.cout)
              and (not bd.has_expand or tuple(np.shape(blk["exp"]["w"])) == (bd.cin, bd.cexp))
              and (not bd.se_mid or tuple(np.shape(blk["se"]["w1"])) == (bd.cexp, bd.se_mid)))
        if not ok:
            raise ValueError(f"block {i} does not match {bd}")
    return to_device(tree, device, dtype)
