"""INT8 MobileNet-V1 forward and pipeline: the port of the JAX package's
`quant/model.py`.

int8 activations end to end with per-layer requantization; the tap names of
collect mode match the float pipeline and the oracles. Backends per block:
  "plain" - the plain int8 depthwise (or the depthwise kernel, with
            use_dw_kernel=True) and the plain pointwise (the reference route);
  "fused" - the fused int8 block kernel (ops/separable_block_i8.py);
  "mixed" - "plain" on blocks 0-1, "fused" from block 2 on.
The stem, input quantization, pool, fc and softmax are plain ops on every
route.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..checkpoints import fold_bn, init_params
from ..checkpoints.padding import needs_padding, pad_channels
from ..config import ModelConfig
from ..ops.conv import softmax
from ..ops.depthwise_i8 import depthwise_i8
from ..ops.preprocess import preprocess
from ..ops.separable_block_i8 import kmajor, separable_block_i8
from ..runtime.pipeline import PipelineBase
from . import ops as qops
from .quantize import ACT_HIDDEN_SCALE, ACT_IN_SCALE, QuantizedParams, quantize

DW_BACKENDS = ("plain", "fused")


def resolve_i8_routing(n: int, dw_backend) -> tuple:
    """The per-block int8 backend tuple of an n-block network: None ->
    "plain"; "auto" -> "fused" at every batch (the TPU's measured all-plain
    batch-1 rule does not carry over; runtime/autotune.py races the routes
    on the card); "mixed" -> the JAX package's tuple, plain on blocks 0-1
    and "fused" from block 2 on (MobileNet-V1's; the V2 and V3 int8 routings
    refuse it); a name; or n names."""
    if dw_backend is None:
        dw_backend = "plain"
    if dw_backend == "auto":
        dw_backend = "fused"
    if dw_backend == "mixed":
        return ("plain",) * 2 + ("fused",) * (n - 2)
    if isinstance(dw_backend, str):
        if dw_backend not in DW_BACKENDS:
            raise ValueError(f"dw_backend {dw_backend!r} not in {DW_BACKENDS}, "
                             "'auto' or 'mixed'")
        return (dw_backend,) * n
    if len(dw_backend) != n or any(b not in DW_BACKENDS for b in dw_backend):
        raise ValueError(f"per-block dw_backend must be {n} names from "
                         f"{DW_BACKENDS}, got {dw_backend!r}")
    return tuple(dw_backend)


def _routing_i8(config: ModelConfig, dw_backend, batch: int):
    """Resolve the per-block int8 backend tuple (len == 13), as the float
    path's models.mobilenet_v1._routing (`resolve_i8_routing`)."""
    return resolve_i8_routing(len(config.block_strides), dw_backend)


def forward_i8(dev: Dict[str, Any], x_i8: torch.Tensor, config: ModelConfig, *,
               dw_backend=None, use_dw_kernel: bool = False, collect: bool = False):
    """x_i8: (N, H, W, 3) quantized input at s_in = 1/127 (int8).

    collect=True runs every block on the per-layer route and also returns
    each layer's int8 output by tap name (conv1, blockNN_dw, blockNN_pw,
    pool, logits). use_dw_kernel=True runs that route's depthwise through
    the depthwise kernel (ops/depthwise_i8.py).
    Returns float32 logits (N, classes), or (logits, {tap: tensor})."""
    acts: Dict[str, torch.Tensor] = {}
    relu6 = config.relu6
    routing = _routing_i8(config, dw_backend, int(x_i8.shape[0]))
    dw_op = depthwise_i8 if use_dw_kernel else qops.depthwise_i8

    c1 = dev["conv1"]
    y = qops.conv1_i8(x_i8, c1["w"], c1["b"], c1["m"], c1["six_q"], relu6)
    if collect:
        acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(dev["blocks"], config.block_strides)):
        d, p = blk["dw"], blk["pw"]
        if routing[i] == "fused" and not collect:
            y = separable_block_i8(y, d["w"], d["b"], d["m"], p["w"], p["b"], p["m"],
                                   stride, d["six_q"], p["six_q"], relu6, pw_wt=p["wt"])
            continue
        y = dw_op(y, d["w"], d["b"], d["m"], d["six_q"], stride, relu6)
        if collect:
            acts[f"block{i:02d}_dw"] = y
        y = qops.pointwise_i8(y, p["w"], p["b"], p["m"], p["six_q"], relu6)
        if collect:
            acts[f"block{i:02d}_pw"] = y

    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    fc = dev["fc"]
    logits = qops.fc_i8_logits(pooled, fc["w"], ACT_HIDDEN_SCALE, fc["s_w"], fc["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def quantize_for_device(folded, config: ModelConfig, dw_backend="auto") -> QuantizedParams:
    """Quantize, with the JAX package's channel-padding pass applied when
    any block may route the fused kernel (every spec but "plain"). Padded
    channels quantize to zero weights and bias, so logits are unchanged bit
    for bit (checkpoints/padding.py)."""
    if dw_backend not in (None, "plain") and needs_padding(folded):
        folded = pad_channels(folded)
    return quantize(folded, config)


def _put(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device).contiguous()


def device_layer(ql, device) -> Dict[str, Any]:
    """One QuantLayer on `device`: int8 weights, int32 biases, float32
    multipliers, and six_q as a Python float."""
    return {"w": _put(ql.w_i8, device), "b": _put(ql.bias_i32, device),
            "m": _put(ql.m, device), "six_q": float(ql.six_q)}


def device_pw_layer(ql, device) -> Dict[str, Any]:
    """A pointwise QuantLayer that the fused block kernel reads: `device_layer`
    plus "wt", the K-major (Cout, Cin) copy of its weight, made once here."""
    layer = device_layer(ql, device)
    layer["wt"] = kmajor(layer["w"])
    return layer


def device_fc(q, device) -> Dict[str, Any]:
    return {"w": _put(q.fc_w_i8, device), "s_w": _put(q.fc_s_w, device),
            "b": _put(q.fc_b_f32, device)}


def to_device_i8(q, device) -> Dict[str, Any]:
    """Quantized constants onto `device`, once (`device_layer`; the pointwise
    layers with their K-major copy, `device_pw_layer`). `q` is a
    QuantizedParams of this package or of the JAX package (both hold only
    numpy fields)."""
    return {
        "conv1": device_layer(q.conv1, device),
        "blocks": [{"dw": device_layer(b["dw"], device), "pw": device_pw_layer(b["pw"], device)}
                   for b in q.blocks],
        "fc": device_fc(q, device),
    }


class Int8Pipeline(PipelineBase):
    """Device-resident int8 weights and the uint8 -> probabilities entry:
    the `.config` / `run_batch` surface MicroBatchServer needs, plus
    classify and benchmark()."""

    _forward = staticmethod(forward_i8)
    _weights_attr = "dev"

    def __init__(self, config: ModelConfig, params=None, *, device="cuda", seed: int = 0,
                 dw_backend: Any = "auto", mesh=None):
        """`params`: a folded host tree (numpy leaves, e.g. from load_npz);
        None draws the seeded weight set. `device`: "cuda" (default),
        "cuda:N" or "cpu". `dw_backend`: "auto" (the fused kernel), "plain",
        "fused", "mixed", or a per-block tuple (_routing_i8). `mesh`: data-parallel
        over a parallel.mesh.Mesh (runtime/pipeline.py); `device` is then
        unused."""
        self.config = config
        self.device = self._init_mesh(mesh, device)
        self.dw_backend = dw_backend
        folded = params if params is not None else fold_bn(
            init_params(config, seed=seed), eps=config.bn_eps)
        self.q = quantize_for_device(folded, config, dw_backend)
        self.dev = to_device_i8(self.q, self.device)
        self._replicate()

    def _entry(self, kind: str, rank: int = 0):
        if kind != "probs_u8":
            raise KeyError(kind)
        cfg, forward, dev = self.config, self._forward, self._weights(rank)

        def fn(images_u8):
            x = preprocess(images_u8, cfg.resolution, torch.float32)
            x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
            return softmax(forward(dev, x_q, cfg, dw_backend=self.dw_backend))

        return fn
