"""Channel tensor-parallel MobileNet-V1 inference through the separable
kernel: the port of the JAX package's `parallel/tp_fused.py`.

Each rank of the model axis runs the block on its CHANNEL shard and the
per-block reduction is one `psum` over the model axis (mesh.py):

    activations   full channels on every rank, the batch split over "data"
    dw weights    channel-sharded over "model" (depthwise is per channel)
    pw weights    ROW-sharded [Cin/tp, Cout] (the contraction is sharded)
    pw bias       replicated, applied after the psum
    conv1         replicated; fc row-sharded with a logits psum

A block: each rank slices its channel shard from the full activation (a
contiguous copy, so the kernel's 16-byte alignment holds), runs the fused
block with `pw_epilogue=False` (the kernel's raw float32 pointwise
accumulation: bias and ReLU do not commute with the sum over shards), the
partials are summed, and bias and the activation apply once.

Per-block backends: "fused" the separable kernel's raw-partial mode
(ops/separable_block.py), "xla" the plain depthwise and float32
product. "auto" takes "fused" where the shard holds at least 128
channels (the JAX rule, cin / tp >= 128) and the kernel's multiple of 8, else
"xla". A "fused" block on a shard the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch

from ..ops import conv as ops
from ..ops.separable_block import separable_block
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, gather_batch, on_device, psum,
                   shard_batch)

_PARTIAL_BACKENDS = ("fused", "xla")


def param_specs_tp_fused(params: Dict[str, Any]) -> Dict[str, Any]:
    """Per leaf, the mesh axis of each dimension (None: not sharded; () a
    replicated leaf): the fused-TP layout (row-sharded pw)."""
    out: Dict[str, Any] = {
        "conv1": {"w": (), "b": ()},
        "blocks": [],
        "fc": {"w": (MODEL_AXIS, None), "b": ()},
    }
    for _ in params["blocks"]:
        out["blocks"].append({
            "dw": {"w": (None, None, None, MODEL_AXIS), "b": (MODEL_AXIS,)},
            "pw": {"w": (MODEL_AXIS, None), "b": ()},
        })
    return out


def shard_leaf(t: torch.Tensor, spec, m: int, tp: int, device) -> torch.Tensor:
    """Model rank m's part of `t` under `spec`, contiguous on `device`."""
    t = torch.as_tensor(t)
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            size = int(t.shape[dim])
            if size % tp:
                raise ValueError(f"dimension {dim} of size {size} does not shard over "
                                 f"the model axis of size {tp}")
            t = t.narrow(dim, m * (size // tp), size // tp)
    return t.contiguous().to(device, copy=True)


def shard_tree(params, specs, mesh: Mesh) -> List[List[Any]]:
    """trees[d][m]: rank (d, m)'s shard of `params` under `specs`, on its
    device (replicated over the data axis)."""
    dp, tp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]

    def one(tree, spec, m, dev):
        if isinstance(spec, dict):
            return {k: one(tree[k], spec[k], m, dev) for k in spec}
        if isinstance(spec, list):
            return [one(t, s, m, dev) for t, s in zip(tree, spec)]
        return shard_leaf(tree, spec, m, tp, dev)

    return [[one(params, specs, m, mesh.devices[d, m]) for m in range(tp)]
            for d in range(dp)]


def shard_params_tp_fused(params: Dict[str, Any], mesh: Mesh) -> List[List[Any]]:
    """A folded V1 tree (tensors or numpy arrays, in the compute dtype)
    placed on the mesh in the fused-TP layout: trees[d][m] per rank."""
    return shard_tree(params, param_specs_tp_fused(params), mesh)


def _block_cins(config) -> List[int]:
    """Input channel count entering each of the 13 blocks."""
    return [config.stem_channels, *config.block_channels[:-1]]


def tp_routing(config, tp: int, dw_backend) -> tuple:
    """The per-block partial backend tuple ("fused" or "xla")."""
    n = len(config.block_strides)
    if isinstance(dw_backend, str):
        if dw_backend == "auto":
            return tuple("fused" if c // tp >= 128 and (c // tp) % 8 == 0 else "xla"
                         for c in _block_cins(config))
        routing = (dw_backend,) * n
    else:
        routing = tuple(dw_backend)
    if len(routing) != n or any(b not in _PARTIAL_BACKENDS for b in routing):
        raise ValueError(f"dw_backend must be 'auto' or {n} names from "
                         f"{_PARTIAL_BACKENDS}, got {dw_backend!r}")
    return routing


@ops.ieee_f32
def _matmul_f32(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., C) @ (C, D) from float32 operands, float32 result."""
    return (z.float().reshape(-1, z.shape[-1]) @ w.float()).reshape(*z.shape[:-1], -1)


def _block_partial(y_shard, blk, stride, relu6, backend) -> torch.Tensor:
    """One rank's raw pointwise partial (float32, no bias, no activation)
    of its channel shard."""
    if backend == "fused":
        return separable_block(y_shard, blk["dw"]["w"], blk["dw"]["b"], blk["pw"]["w"],
                               blk["pw"]["b"], stride, relu6, pw_epilogue=False)
    # the plain route: the depthwise with its per-channel epilogue (shard-local),
    # then the raw product
    z = ops.depthwise_conv(y_shard, blk["dw"]["w"], stride, bias=blk["dw"]["b"], relu6=relu6)
    return _matmul_f32(z, blk["pw"]["w"])


def forward_tp_fused(params: List[List[Any]], x: torch.Tensor, config, mesh: Mesh, *,
                     dw_backend: Union[str, tuple] = "auto") -> torch.Tensor:
    """TP(+DP) forward: the separable kernel's raw partials on channel
    shards, one psum per block. `params` from shard_params_tp_fused; `x` the
    full preprocessed batch (N, H, W, 3) in the compute dtype, split over
    the data axis here (N must divide). Returns float32 logits (N, classes)
    on the first rank's device, equal to mobilenet_v1.forward within its
    dtype's tolerance (the psum reassociates the pointwise sum)."""
    tp = mesh.shape[MODEL_AXIS]
    routing = tp_routing(config, tp, dw_backend)
    relu6, dtype = config.relu6, x.dtype
    outs = []
    for d, xd in enumerate(shard_batch(mesh, x)):
        ranks, devs = params[d], list(mesh.devices[d])
        ys = []
        for p, dev in zip(ranks, devs):
            with on_device(dev):
                ys.append(ops.conv2d_same(xd.to(dev), p["conv1"]["w"], 2,
                                          bias=p["conv1"]["b"], relu6=relu6))
        for i, stride in enumerate(config.block_strides):
            parts = []
            for m, (p, dev) in enumerate(zip(ranks, devs)):
                blk = p["blocks"][i]
                c = int(blk["dw"]["w"].shape[-1])
                with on_device(dev):
                    shard = ys[m][..., m * c:(m + 1) * c].contiguous()
                    parts.append(_block_partial(shard, blk, stride, relu6, routing[i]))
            totals = psum(parts)
            del parts
            ys = []
            for p, dev, total in zip(ranks, devs, totals):
                with on_device(dev):
                    b = p["blocks"][i]["pw"]["b"].float()
                    ys.append(ops.apply_activation(total + b, relu6).to(dtype))
            del totals
        parts = []
        for m, (p, dev) in enumerate(zip(ranks, devs)):
            with on_device(dev):
                pooled = ops.global_avg_pool(ys[m])
                f = int(p["fc"]["w"].shape[0])
                parts.append(_matmul_f32(pooled[:, m * f:(m + 1) * f], p["fc"]["w"]))
        logits = psum(parts)[0]
        outs.append(logits + ranks[0]["fc"]["b"].float())
    return gather_batch(outs, mesh.devices.flat[0])
