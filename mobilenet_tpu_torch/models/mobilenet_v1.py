"""MobileNet-V1 forward pass in PyTorch, with per-block kernel routing.

The layer schedule, the routing helpers (`_routing`, `_chain_runs`,
`_run_blocks`) and the tap names follow the JAX package's
`models/mobilenet_v1.py`. Backends per block (the JAX package's names in
brackets):
  "plain" - plain PyTorch depthwise + pointwise ops, the reference route
            ["xla"];
  "dw"    - the standalone depthwise kernel (ops/depthwise.py), then the
            plain pointwise ["pallas"];
  "fused" - the fused separable-block kernel (ops/separable_block.py), and
            at batch 1 the chain kernel over the 14x14 stretch ["fused"].
With collect=True a "fused" block runs its depthwise tap through the
depthwise kernel, as the JAX package does, and a "dw" block the same; a
"plain" block keeps the plain ops.
The stem convolution follows block 0's route: the stem kernel (ops/stem.py
`stem_conv`) when block 0 is "fused", the plain convolution otherwise and
under collect=True, which taps the plain stem as it taps the plain
pointwise.
Under `forward_u8(fuse_stem=True)` normalize, the stem and block 0 run as
one kernel (`stem_block0`) where `_stem_fusible` allows. Softmax and, off
that kernel, normalize are plain ops on every route.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..checkpoints.convert import stack_run
from ..config import ModelConfig
from ..ops import conv as ops
from ..ops.chain import chain, chain_fits, stride1_runs
from ..ops.depthwise import depthwise
from ..ops.head import fused_head
from ..ops.preprocess import preprocess
from ..ops.separable_block import separable_block
from ..ops.stem import C1, stem_block0, stem_conv

DW_BACKENDS = ("plain", "dw", "fused")

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
    dtype. collect=True runs every block unfused (the depthwise kernel on
    "dw" and "fused" blocks, plain ops on "plain" blocks), the head on
    plain ops, and also returns each post-activation tensor by layer name
    (conv1, blockNN_dw, blockNN_pw, pool, logits).

    Returns logits (N, classes), or (logits, {name: activation}) if collect.
    """
    acts: Dict[str, torch.Tensor] = {}
    relu6 = config.relu6
    routing = _routing(config, dw_backend, int(x.shape[0]))

    w1, b1 = params["conv1"]["w"], params["conv1"]["b"]
    if routing[0] == "fused" and not collect:
        y = stem_conv(x.contiguous(), w1, b1, relu6)
    else:
        y = ops.conv2d_same(x, w1, 2, bias=b1, relu6=relu6)
    if not collect:
        return _logits(params, _run_blocks(params, y, config, routing, relu6), routing)
    acts["conv1"] = y
    y = _run_blocks(params, y, config, routing, relu6, acts)
    pooled = ops.global_avg_pool(y)
    acts["pool"] = pooled
    logits = ops.fc(pooled, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def _logits(params, y, routing):
    """The head: the fused pool + fc kernel on a "fused" last block, else
    the plain pool and fc."""
    if routing[-1] == "fused":
        return fused_head(y, None, [(params["fc"]["w"], params["fc"]["b"], "linear")])
    return ops.fc(ops.global_avg_pool(y), params["fc"]["w"], params["fc"]["b"])


def _chain_runs(params, config, routing, y_shape, itemsize, start: int = 0):
    """Maximal runs of >= 3 consecutive fused stride-1 C->C blocks (the
    14x14 stretch) from block `start` on that the chain kernel takes
    (`chain_fits`). `y_shape` is the activation shape entering block
    `start`. Returns {start_index: length}."""
    shapes = [tuple(b["pw"]["w"].shape) for b in params["blocks"]]
    runs = stride1_runs(shapes, config.block_strides,
                        [r == "fused" and i >= start for i, r in enumerate(routing)])
    n, spatial, fits = int(y_shape[0]), int(y_shape[1]), {}
    for i in range(start, len(config.block_strides)):
        spatial = -(-spatial // config.block_strides[i])  # output side of block i (TF-SAME)
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


def _run_blocks(params, y, config, routing, relu6, acts=None, start: int = 0,
                stop: Optional[int] = None):
    """The dw/pw blocks [start, stop) (y enters block `start`; all 13 by
    default), per-block backend routing; `acts` collects the taps (module
    docstring). A call with `stop` forms no chain run (as the JAX
    package's), so no chain crosses a pipeline stage's bound."""
    collect = acts is not None
    chain_on = (CHAIN_AT_BATCH1 and int(y.shape[0]) == 1 and not collect
                and stop is None)
    chain_runs = (_chain_runs(params, config, routing, y.shape, y.element_size(), start)
                  if chain_on else {})
    skip_until = start
    for i, (blk, stride) in enumerate(zip(params["blocks"], config.block_strides)):
        if i < skip_until:
            continue
        if stop is not None and i >= stop:
            break
        if i in chain_runs:
            run = chain_runs[i]
            y = chain(y, *_chain_weights(params, i, run), relu6)
            skip_until = i + run
            continue
        if routing[i] == "fused" and not collect:
            y = separable_block(y, blk["dw"]["w"], blk["dw"]["b"], blk["pw"]["w"],
                                blk["pw"]["b"], stride, relu6)
            continue
        if routing[i] == "plain":
            y = ops.depthwise_conv(y, blk["dw"]["w"], stride, bias=blk["dw"]["b"],
                                   relu6=relu6)
        else:
            y = depthwise(y, blk["dw"]["w"], stride, bias=blk["dw"]["b"], relu6=relu6)
        if collect:
            acts[f"block{i:02d}_dw"] = y
        y = ops.pointwise_conv(y, blk["pw"]["w"], bias=blk["pw"]["b"], relu6=relu6)
        if collect:
            acts[f"block{i:02d}_pw"] = y
    return y


def _stem_fusible(params, config: ModelConfig, x_shape, routing, dtype) -> bool:
    """True when `stem_block0` takes normalize + conv1 + block 0: the JAX
    package's gate (`models/mobilenet_v1.py` `_stem_fusible`), clause for
    clause: block 0 routed "fused" and stride 1, a 32-channel stem (alpha
    1.0), H and W even, (W/2) % 8 == 0, (8 * Cout) % 128 == 0, and no
    fusion for a 4-byte dtype above 160 px. That last clause comes from the
    TPU kernel, which held whole images in a 16 MB VMEM scope that float32
    overflows at 224; the card's kernel tiles and has no such limit, but
    the clause stays so that both packages take the same route on the same
    shapes."""
    h, w = int(x_shape[1]), int(x_shape[2])
    c1 = int(params["conv1"]["w"].shape[3])
    cout = int(params["blocks"][0]["pw"]["w"].shape[1])
    if dtype.itemsize > 2 and h > 160:
        return False
    return (routing[0] == "fused" and config.block_strides[0] == 1 and c1 == C1
            and h % 2 == 0 and w % 2 == 0 and (w // 2) % 8 == 0
            and (8 * cout) % 128 == 0)


def forward_u8(params: Dict[str, Any], images_u8: torch.Tensor,
               config: ModelConfig, *, dtype=torch.float32,
               dw_backend=None, fuse_stem: bool = False) -> torch.Tensor:
    """uint8 NHWC -> logits: preprocess (resize, normalize), then forward.

    With fuse_stem=True and `_stem_fusible` (images at model resolution),
    normalize + conv1 + block 0 run as one kernel (`stem_block0`), then
    blocks 1-12 and the head; where the gate refuses, preprocess + forward,
    as with fuse_stem=False. The JAX package keeps fuse_stem off by
    default, and so does the port."""
    routing = _routing(config, dw_backend, int(images_u8.shape[0]))
    if not (fuse_stem and _stem_fusible(params, config, images_u8.shape, routing, dtype)):
        x = preprocess(images_u8, config.resolution, dtype)
        return forward(params, x, config, dw_backend=dw_backend)
    blk0 = params["blocks"][0]
    y = stem_block0(images_u8, *(t.to(dtype) for t in (
        params["conv1"]["w"], params["conv1"]["b"], blk0["dw"]["w"], blk0["dw"]["b"],
        blk0["pw"]["w"], blk0["pw"]["b"])), config.relu6)
    y = _run_blocks(params, y, config, routing, config.relu6, start=1)
    return _logits(params, y, routing)


def predict_probs(params, x, config: ModelConfig, **kw) -> torch.Tensor:
    """logits -> float32 softmax probabilities."""
    return ops.softmax(forward(params, x, config, **kw))


def predict_probs_u8(params, images_u8, config: ModelConfig, **kw) -> torch.Tensor:
    """uint8 images -> float32 softmax probabilities."""
    return ops.softmax(forward_u8(params, images_u8, config, **kw))
