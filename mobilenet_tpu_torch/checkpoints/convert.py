"""Weights from the JAX package, and the layouts the kernels want at load.

`from_jax_params` takes the JAX package's folded tree as numpy arrays (the
same nested dict/list scheme and NHWC/HWIO layouts this package uses) and
returns device tensors ready for `models.mobilenet_v1.forward`. The tests use
it so that both packages compute on the same weights.
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
