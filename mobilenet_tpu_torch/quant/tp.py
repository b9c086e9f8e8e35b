"""Channel tensor-parallel int8 MobileNet-V1 inference that keeps the exact
contract: the port of the JAX package's `quant/tp.py`.

Every pointwise accumulation is an int32 sum, and integer addition is
associative, so row-sharding the pointwise contraction and summing the int32
partials over the model axis gives logits bit-equal to the single-device
`quant.model.forward_i8`. The scheme is tp_fused's (parallel/tp_fused.py):
  conv1   replicated (qops.conv1_i8)
  dw      channel-sharded: int8 in and out, its per-channel requant local
  pw      ROW-sharded int8 product -> int32 partial -> psum (int32) -> + bias
          -> ONE requantize after the sum
  fc      row-sharded int32 partial -> psum -> float scale and bias
The ops are the JAX package's: the plain int8 depthwise, exact integer
products (`ops._int_matmul`: float64, exact for int8 x int8 sums of any
shard width here), no kernel (the JAX path reaches none either).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..parallel.mesh import MODEL_AXIS, Mesh, gather_batch, psum, shard_batch
from ..parallel.tp_fused import shard_tree
from . import ops as qops
from .quantize import ACT_HIDDEN_SCALE


def _split_static(dev: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(tensors-only tree, six_q dict): the requant clips stay Python
    floats, one per layer."""
    arrays = {
        "conv1": {k: dev["conv1"][k] for k in ("w", "b", "m")},
        "blocks": [{"dw": {k: b["dw"][k] for k in ("w", "b", "m")},
                    "pw": {k: b["pw"][k] for k in ("w", "b", "m")}} for b in dev["blocks"]],
        "fc": {k: dev["fc"][k] for k in ("w", "s_w", "b")},
    }
    six = {
        "conv1": float(dev["conv1"]["six_q"]),
        "dw": [float(b["dw"]["six_q"]) for b in dev["blocks"]],
        "pw": [float(b["pw"]["six_q"]) for b in dev["blocks"]],
    }
    return arrays, six


def param_specs_i8_tp(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Per leaf, the mesh axis of each dimension (tp_fused's notation): dw
    constants shard with the channels; the pw rescale constants are per Cout
    and apply after the psum, so they are replicated."""
    out: Dict[str, Any] = {
        "conv1": {"w": (), "b": (), "m": ()},
        "blocks": [],
        "fc": {"w": (MODEL_AXIS, None), "s_w": (), "b": ()},
    }
    for _ in arrays["blocks"]:
        out["blocks"].append({
            "dw": {"w": (None, None, None, MODEL_AXIS), "b": (MODEL_AXIS,),
                   "m": (MODEL_AXIS,)},
            "pw": {"w": (MODEL_AXIS, None), "b": (), "m": ()},
        })
    return out


def shard_dev_i8_tp(dev: Dict[str, Any], mesh: Mesh) -> Tuple[List[List[Any]], Dict[str, Any]]:
    """An int8 device tree (quant.model.to_device_i8) placed on the mesh:
    (trees[d][m] per rank, the six_q dict)."""
    arrays, six = _split_static(dev)
    return shard_tree(arrays, param_specs_i8_tp(arrays), mesh), six


def forward_i8_tp(arrays: List[List[Any]], six: Dict[str, Any], x_i8: torch.Tensor,
                  config, mesh: Mesh) -> torch.Tensor:
    """TP(+DP) int8 forward over `mesh`; float32 logits bit-equal to the
    single-device forward_i8 (int32 partial sums commute). `arrays`/`six`
    from shard_dev_i8_tp; `x_i8` the quantized input (N, H, W, 3), split
    over the data axis here. Returns the logits on the first rank's device."""
    relu6 = config.relu6
    outs = []
    for d, xd in enumerate(shard_batch(mesh, x_i8)):
        ranks, devs = arrays[d], list(mesh.devices[d])
        ys = [qops.conv1_i8(xd.to(dev), p["conv1"]["w"], p["conv1"]["b"], p["conv1"]["m"],
                            six["conv1"], relu6) for p, dev in zip(ranks, devs)]
        for i, stride in enumerate(config.block_strides):
            parts = []
            for m, p in enumerate(ranks):
                dw, pw = p["blocks"][i]["dw"], p["blocks"][i]["pw"]
                c = int(dw["w"].shape[-1])
                z = qops.depthwise_i8(ys[m][..., m * c:(m + 1) * c], dw["w"], dw["b"],
                                      dw["m"], six["dw"][i], stride, relu6)
                parts.append(qops._int_matmul(z.reshape(-1, c), pw["w"]))
            n, h, w = (int(s) for s in z.shape[:3])
            ys = [qops.requantize(acc + p["blocks"][i]["pw"]["b"][None, :],
                                  p["blocks"][i]["pw"]["m"], six["pw"][i], relu6
                                  ).reshape(n, h, w, -1)
                  for p, acc in zip(ranks, psum(parts))]
        parts = []
        for m, p in enumerate(ranks):
            pooled = qops.avgpool_i8(ys[m])
            f = int(p["fc"]["w"].shape[0])
            parts.append(qops._int_matmul(pooled[:, m * f:(m + 1) * f], p["fc"]["w"]))
        fc = ranks[0]["fc"]
        scale = fc["s_w"].float() * qops._f32(ACT_HIDDEN_SCALE)
        outs.append(psum(parts)[0].float() * scale + fc["b"].float())
    return gather_batch(outs, mesh.devices.flat[0])
