"""Numerics debugging: find the first layer that makes a NaN or an Inf.

The port of the JAX package's `utils/debug.py`:
  - `checked_forward` runs the MobileNet-V1 forward with its per-layer taps
    and names the first layer, in network order, whose output is not
    finite (the JAX package wraps the forward in checkify's float checks);
  - `assert_finite_tree` names every non-finite floating leaf of a nested
    dict / list / tuple of tensors or arrays.
`interpret_mode` and `nan_debug_enabled` have no counterpart: they switch
JAX machinery (Pallas's interpreter, the `jax_debug_nans` flag). On the CPU
every kernel wrapper of the port already runs its plain version, and
PyTorch has no global NaN trap.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def _finite(leaf) -> bool:
    """True unless `leaf` is a floating tensor or array holding a NaN or Inf."""
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return not np.issubdtype(arr.dtype, np.floating) or bool(np.isfinite(arr).all())


def checked_forward(params, x, config, **kw):
    """The V1 forward (`models.mobilenet_v1.forward`, `kw` passed on) with
    collect=True; returns the logits, or raises FloatingPointError naming the
    first tap (conv1, blockNN_dw, blockNN_pw, pool, logits) whose output is
    not finite."""
    from ..models import mobilenet_v1  # noqa: PLC0415

    logits, acts = mobilenet_v1.forward(params, x, config, collect=True, **kw)
    for name, act in acts.items():  # the taps in network order
        if not _finite(act):
            raise FloatingPointError(f"non-finite values first at layer {name}")
    return logits


def _walk(tree, path: str, bad: List[str]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, f"{path}[{k!r}]", bad)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{path}[{i}]", bad)
    elif tree is not None and not _finite(tree):
        bad.append(path)


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise AssertionError naming the key path of every non-finite floating
    leaf (e.g. "['blocks'][3]['pw']['w']")."""
    bad: List[str] = []
    _walk(tree, "", bad)
    if bad:
        raise AssertionError(f"non-finite values in {name}: {bad}")
