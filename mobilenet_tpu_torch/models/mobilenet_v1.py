"""MobileNet-V1 forward pass in PyTorch, with per-block kernel routing.

The layer schedule, the routing helpers (`_routing`, `_chain_runs`,
`_run_blocks`) and the tap names follow the JAX package's
`models/mobilenet_v1.py`. Backends per block:
  "plain" - plain PyTorch depthwise + pointwise ops (the reference route);
  "fused" - the fused separable-block kernel (ops/separable_block.py), and
            at batch 1 the chain kernel over the 14x14 stretch.
The stem convolution, normalize and softmax are plain ops on every route.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..checkpoints.convert import stack_run
from ..config import ModelConfig
from ..ops import conv as ops
from ..ops.chain import chain, chain_fits, stride1_runs
from ..ops.head import fused_head, head_fits
from ..ops.preprocess import preprocess
from ..ops.separable_block import separable_block

DW_BACKENDS = ("plain", "fused")

# Collapse the eligible stride-1 run (blocks 6-10) into one chain launch at
# batch 1, where the forward is bound by launches and idle SMs.
CHAIN_AT_BATCH1 = True


def _routing(config: ModelConfig, dw_backend, batch: int):
    """Resolve the per-block backend tuple (len == 13).

    None -> "plain". "auto" -> "fused" at every batch: the TPU's measured
    batch thresholds do not carry over, and the H100 crossover has not been
    measured yet, so "mixed" is not accepted."""
    n = len(config.block_strides)
    if dw_backend is None:
        dw_backend = "plain"
    if dw_backend == "auto":
        dw_backend = "fused"
    if isinstance(dw_backend, str):
        if dw_backend not in DW_BACKENDS:
            raise ValueError(f"dw_backend {dw_backend!r} not in {DW_BACKENDS} "
                             "or 'auto'")
        return (dw_backend,) * n
    if len(dw_backend) != n or any(b not in DW_BACKENDS for b in dw_backend):
        raise ValueError(f"per-block dw_backend must be {n} names from "
                         f"{DW_BACKENDS}, got {dw_backend!r}")
    return tuple(dw_backend)


def forward(params: Dict[str, Any], x: torch.Tensor, config: ModelConfig, *,
            dw_backend=None, collect: bool = False) -> Any:
    """Run the 28-layer network on a folded-BN device tree.

    x: (N, H, W, 3) preprocessed NHWC images in [-1, 1], in the compute
    dtype. collect=True runs every block on plain ops and also returns each
    post-activation tensor by layer name (conv1, blockNN_dw, blockNN_pw,
    pool, logits).

    Returns logits (N, classes), or (logits, {name: activation}) if collect.
    """
    acts: Dict[str, torch.Tensor] = {}
    relu6 = config.relu6
    routing = _routing(config, dw_backend, int(x.shape[0]))

    y = ops.conv2d_same(x, params["conv1"]["w"], 2, bias=params["conv1"]["b"],
                        relu6=relu6)
    if collect:
        acts["conv1"] = y
    y = _run_blocks(params, y, config, routing, relu6, acts if collect else None)

    if (not collect and routing[-1] == "fused"
            and head_fits(int(y.shape[-1]), int(params["fc"]["w"].shape[-1]))):
        return fused_head(y, None, [(params["fc"]["w"], params["fc"]["b"], "linear")])
    pooled = ops.global_avg_pool(y)
    if collect:
        acts["pool"] = pooled
    logits = ops.fc(pooled, params["fc"]["w"], params["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def _chain_runs(params, config, routing, y_shape, itemsize):
    """Maximal runs of >= 3 consecutive fused stride-1 C->C blocks (the
    14x14 stretch) that the chain kernel takes (`chain_fits`). `y_shape` is
    the activation shape entering block 0. Returns {start_index: length}."""
    shapes = [tuple(b["pw"]["w"].shape) for b in params["blocks"]]
    runs = stride1_runs(shapes, config.block_strides,
                        [r == "fused" for r in routing])
    n, spatial, fits = int(y_shape[0]), int(y_shape[1]), {}
    for i, stride in enumerate(config.block_strides):
        spatial = -(-spatial // stride)  # output side of block i (TF-SAME)
        if i in runs and chain_fits(n, spatial, spatial, shapes[i][0], runs[i],
                                    itemsize):
            fits[i] = runs[i]
    return fits


def _chain_weights(params, i: int, run: int):
    """The run's stacked weights: prepared at load (checkpoints.convert.
    prepare_kernel_layouts) when the run matches, else stacked here."""
    prepared = params.get("chain", {}).get(i)
    if prepared is not None and prepared[0].shape[0] == run:
        return prepared
    return stack_run(params["blocks"][i:i + run])


def _run_blocks(params, y, config, routing, relu6, acts=None):
    """The 13 dw/pw blocks, per-block backend routing."""
    collect = acts is not None
    chain_on = CHAIN_AT_BATCH1 and int(y.shape[0]) == 1 and not collect
    chain_runs = (_chain_runs(params, config, routing, y.shape, y.element_size())
                  if chain_on else {})
    skip_until = 0
    for i, (blk, stride) in enumerate(zip(params["blocks"], config.block_strides)):
        if i < skip_until:
            continue
        if i in chain_runs:
            run = chain_runs[i]
            y = chain(y, *_chain_weights(params, i, run), relu6)
            skip_until = i + run
            continue
        if routing[i] == "fused" and not collect:
            y = separable_block(y, blk["dw"]["w"], blk["dw"]["b"], blk["pw"]["w"],
                                blk["pw"]["b"], stride, relu6)
            continue
        y = ops.depthwise_conv(y, blk["dw"]["w"], stride, bias=blk["dw"]["b"],
                               relu6=relu6)
        if collect:
            acts[f"block{i:02d}_dw"] = y
        y = ops.pointwise_conv(y, blk["pw"]["w"], bias=blk["pw"]["b"], relu6=relu6)
        if collect:
            acts[f"block{i:02d}_pw"] = y
    return y


def forward_u8(params: Dict[str, Any], images_u8: torch.Tensor,
               config: ModelConfig, *, dtype=torch.float32,
               dw_backend=None) -> torch.Tensor:
    """uint8 NHWC -> logits: preprocess (resize, normalize), then forward."""
    x = preprocess(images_u8, config.resolution, dtype)
    return forward(params, x, config, dw_backend=dw_backend)


def predict_probs(params, x, config: ModelConfig, **kw) -> torch.Tensor:
    """logits -> float32 softmax probabilities."""
    return ops.softmax(forward(params, x, config, **kw))


def predict_probs_u8(params, images_u8, config: ModelConfig, **kw) -> torch.Tensor:
    """uint8 images -> float32 softmax probabilities."""
    return ops.softmax(forward_u8(params, images_u8, config, **kw))
