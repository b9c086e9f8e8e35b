"""GPipe pipeline parallelism over a "pipe" axis: the port of the JAX
package's `parallel/pp.py`.

The network is split into S contiguous stages of units (stem, blocks, head),
one a rank of a 1-D ("pipe",) mesh, and M microbatches stream through them
on the GPipe schedule: at step t (M + S - 1 steps) stage s runs microbatch
t - s on its device. The stage boundary is the activation itself, moved to
the next stage's device with `.to()` (the JAX package's padded float32
buffer exists only because one SPMD program needs one shape; bf16 -> f32 ->
bf16 is lossless, so dropping it changes no value). Each stage body runs
exactly what the single-device forward runs on a microbatch of size b =
N / M: its routing resolved at b (`_routing*(config, dw_backend, b)`), the
kernels where the route says so, the forward's own stem and head. A V1 stage
forms no batch-1 chain; a V3 chain never crosses a stage's bound.

Stage balance: analytic MACs per unit and a contiguous greedy partition
(`plan_stages`), the JAX package's bounds for every family. The weights are
replicated on every stage's device.

`pp_train_step` differentiates straight through the schedule: autograd
passes through the boundary copies (their transpose is the copy back) and
the replicated weights' copies (their cotangents sum onto the one tree),
so the pipeline needs no backward code, as `jax.grad` transposes the JAX
schedule.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import conv as ops
from ..ops.stem import stem_conv
from .mesh import Mesh, available_devices, on_device, replicate

PIPE_AXIS = "pipe"

# unit indexing: 0 = stem conv, 1 + i = separable block i (13), 14 = head
N_UNITS = 15


def make_pipe_mesh(n_stages: int, devices=None) -> Mesh:
    """1-D ("pipe",) mesh over the first n_stages of `devices` (default:
    the CUDA devices; mesh.make_mesh's rules)."""
    avail = available_devices(devices)
    if n_stages < 1 or n_stages > len(avail):
        raise ValueError(f"make_pipe_mesh: need {n_stages} devices, have {len(avail)} "
                         "(name them with devices=[...], e.g. ['cuda:0'] * n)")
    return Mesh(np.asarray(avail[:n_stages], dtype=object), (PIPE_AXIS,))


def _cout(layer) -> int:
    return int(layer["w"].shape[-1])


def _unit_in_shapes(config: ModelConfig, params: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """Per-sample activation shape entering each V1 unit (len == N_UNITS),
    TF-SAME ceil division."""
    res = config.resolution
    shapes = [(res, res, 3)]
    hw = -(-res // 2)  # stem is stride 2
    c = _cout(params["conv1"])
    for i, stride in enumerate(config.block_strides):
        shapes.append((hw, hw, c))
        hw = -(-hw // stride)
        c = _cout(params["blocks"][i]["pw"])
    shapes.append((hw, hw, c))  # entering the head
    return shapes


def _unit_costs(config: ModelConfig, params: Dict[str, Any]) -> List[float]:
    """Analytic MACs per V1 unit: the stage-balance weight."""
    shapes = _unit_in_shapes(config, params)
    costs = [0.0] * N_UNITS
    h, w, _ = shapes[1]
    costs[0] = h * w * 9 * 3 * float(_cout(params["conv1"]))
    for i, stride in enumerate(config.block_strides):
        cin, cout = (int(s) for s in params["blocks"][i]["pw"]["w"].shape)
        hin = shapes[1 + i][0]
        hout = -(-hin // stride)
        costs[1 + i] = float(hout * hout) * (9.0 * cin + cin * cout)
    hh, _, cc = shapes[14]
    costs[14] = float(hh * hh * cc + cc * config.num_classes)
    return costs


def _v1_units(config, params, dw_backend, b):
    """V1 adapter: (n_units, in_shapes, costs, run). `run(p, y, start, stop)`
    executes units [start, stop) as mobilenet_v1.forward does: the stem
    kernel where block 0 is "fused", the blocks, the head (float32
    logits)."""
    from ..models import mobilenet_v1 as mv1  # noqa: PLC0415

    shapes, costs = _unit_in_shapes(config, params), _unit_costs(config, params)
    routing = mv1._routing(config, dw_backend, b)
    relu6, n = config.relu6, N_UNITS

    def run(p, y, start, stop):
        u = start
        if u == 0:
            w1, b1 = p["conv1"]["w"], p["conv1"]["b"]
            y = (stem_conv(y.contiguous(), w1, b1, relu6) if routing[0] == "fused"
                 else ops.conv2d_same(y, w1, 2, bias=b1, relu6=relu6))
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv1._run_blocks(p, y, config, routing, relu6, None, start=u - 1, stop=blk_stop)
        if stop == n:
            y = mv1._logits(p, y, routing).float()
        return y

    return n, shapes, costs, run


def _family_shapes_costs(config, params, n, k_of, se_of):
    """Entering shapes and MACs of a V2/V3 stack's units: stem, blocks
    (expansion, k x k depthwise, projection, SE), head (filled by the
    caller)."""
    defs = config.block_defs
    res = config.resolution
    shapes = [(res, res, 3)]
    hw = -(-res // 2)
    c = _cout(params["conv1"])
    for i, bd in enumerate(defs):
        shapes.append((hw, hw, c))
        hw = -(-hw // _stride(bd))
        c = _cout(params["blocks"][i]["prj"])
    shapes.append((hw, hw, c))
    costs = [0.0] * n
    h0 = shapes[1][0]
    costs[0] = h0 * h0 * 9 * 3 * float(_cout(params["conv1"]))
    for i, bd in enumerate(defs):
        hin, _, cin_a = shapes[1 + i]
        blk = params["blocks"][i]
        e = _cout(blk["exp"]) if "exp" in blk else cin_a
        hout = -(-hin // _stride(bd))
        exp_macs = hin * hin * cin_a * e if "exp" in blk else 0
        k = k_of(bd)
        costs[1 + i] = float(exp_macs + hout * hout * (k * k * e + e * _cout(blk["prj"]))
                             + (2 * e * se_of(bd) if se_of(bd) else 0))
    return shapes, costs


def _stride(bd) -> int:
    return bd[3] if isinstance(bd, tuple) else bd.stride


def _v2_units(config, params, dw_backend, b):
    """V2 adapter (stem + 17 inverted-residual blocks + head)."""
    from ..models import mobilenet_v2 as mv2  # noqa: PLC0415

    n = len(config.block_defs) + 2
    shapes, costs = _family_shapes_costs(config, params, n, lambda bd: 3, lambda bd: 0)
    hh, _, cc = shapes[n - 1]
    cl = _cout(params["conv_last"])
    costs[n - 1] = float(hh * hh * cc * cl + cl * config.num_classes)
    routing = mv2._routing_v2(config, dw_backend, b)

    def run(p, y, start, stop):
        u = start
        if u == 0:
            y = ops.conv2d_same(y, p["conv1"]["w"], 2, bias=p["conv1"]["b"], relu6=True)
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv2.run_blocks_v2(p, y, config, routing, start=u - 1, stop=blk_stop)
        if stop == n:
            y = mv2.head_v2(p, y, routing).float()
        return y

    return n, shapes, costs, run


def _v3_units(config, params, dw_backend, b):
    """V3 adapter (stem + bottlenecks + conv_last, pool, head, fc)."""
    from ..models import mobilenet_v3 as mv3  # noqa: PLC0415

    n = len(config.block_defs) + 2
    shapes, costs = _family_shapes_costs(config, params, n, lambda bd: bd.kernel,
                                         lambda bd: bd.se_mid)
    hh, _, cc = shapes[n - 1]
    cl, hd = _cout(params["conv_last"]), _cout(params["head"])
    costs[n - 1] = float(hh * hh * cc * cl + cl * hd + hd * config.num_classes)
    routing = mv3._routing_v3(config, dw_backend, b)
    act = config.head_act

    def run(p, y, start, stop):
        u = start
        if u == 0:
            y = ops.conv2d_same(y, p["conv1"]["w"], 2, bias=p["conv1"]["b"], act=act)
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv3.run_blocks_v3(p, y, config, routing, start=u - 1, stop=blk_stop)
        if stop == n:
            y = mv3.head_v3(p, y, config, routing).float()
        return y

    return n, shapes, costs, run


def _units_for(config, params, dw_backend, b):
    """Family dispatch: the per-unit decomposition the schedule runs."""
    from ..models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from ..models.mobilenet_v3 import V3Config  # noqa: PLC0415

    if isinstance(config, V2Config):
        return _v2_units(config, params, dw_backend, b)
    if isinstance(config, V3Config):
        return _v3_units(config, params, dw_backend, b)
    return _v1_units(config, params, dw_backend, b)


def plan_stages(config, params: Dict[str, Any], n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) unit ranges, MAC-balanced greedily: every
    stage gets >= 1 unit, the greedy target re-divides the remaining mass at
    each cut (the JAX package's rule, bound for bound)."""
    n_units, _, costs, _ = _units_for(config, params, "plain", 1)
    if not 1 <= n_stages <= n_units:
        raise ValueError(f"n_stages must be in [1, {n_units}], got {n_stages}")
    bounds: List[Tuple[int, int]] = []
    start = 0
    for s in range(n_stages):
        stages_left = n_stages - s
        if stages_left == 1:
            bounds.append((start, n_units))
            break
        target = sum(costs[start:]) / stages_left
        stop, acc = start, 0.0
        max_stop = n_units - (stages_left - 1)  # a unit for each later stage
        while stop < max_stop:
            nxt = acc + costs[stop]
            if stop > start and nxt > target and (nxt - target) > (target - acc):
                break
            acc = nxt
            stop += 1
        stop = max(stop, start + 1)
        bounds.append((start, stop))
        start = stop
    assert bounds[-1][1] == n_units and len(bounds) == n_stages, bounds
    return bounds


def forward_pp(params: Dict[str, Any], x: torch.Tensor, config, mesh: Mesh, *,
               n_microbatches: Optional[int] = None, dw_backend="auto") -> torch.Tensor:
    """Pipeline-parallel forward: float32 logits (N, classes) on the first
    stage's device.

    `x` is the full preprocessed batch (N, H, W, 3) in the compute dtype,
    split into M microbatches of b = N / M (M defaults to min(2S, N); a
    batch that does not divide raises). `params` is a device tree of the
    family (checkpoints.to_device), replicated onto each stage's device
    here. dw_backend: the family's routing names, resolved at b ("auto":
    the kernels)."""
    devs = list(mesh.devices.reshape(-1))
    S = mesh.shape[PIPE_AXIS]
    N = int(x.shape[0])
    M = int(n_microbatches or min(2 * S, N))
    if N % M:
        raise ValueError(f"batch {N} not divisible by n_microbatches={M}")
    b = N // M
    _, _, _, run = _units_for(config, params, dw_backend, b)
    bounds = plan_stages(config, params, S)
    reps = replicate(params, devs)
    mbs = x.split(b)
    out: List[Optional[torch.Tensor]] = [None] * M
    buf: List[Optional[torch.Tensor]] = [None] * S  # the boundary entering each stage
    for t in range(M + S - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue
            y = mbs[mb].to(devs[0]) if s == 0 else buf[s]
            with on_device(devs[s]):
                y = run(reps[s], y, *bounds[s])
            if s == S - 1:
                out[mb] = y.to(devs[0])
            else:
                nxt[s + 1] = y.to(devs[s + 1])
        buf = nxt
    return torch.cat(out)


def pp_train_step(params: Dict[str, Any], x: torch.Tensor, labels: torch.Tensor, config,
                  mesh: Mesh, *, lr: float = 1e-3, n_microbatches: Optional[int] = None):
    """One plain SGD step (w - lr * g, no momentum) through the pipelined
    forward on the plain differentiable route in float32: the mean
    cross-entropy of `forward_pp`'s logits, `backward` through the schedule.
    Returns (updated params, loss); `params` is left as it was. The whole
    step runs under `no_tf32`, as models/train.sgd_train_step does."""
    from ..models.train import _nll, tree_leaves, tree_map  # noqa: PLC0415

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    x = x.float().to(mesh.devices.flat[0])
    with ops.no_tf32(x):
        logits = forward_pp(live, x, config, mesh, n_microbatches=n_microbatches,
                            dw_backend="plain")
        loss = _nll(logits, labels.to(logits.device))
        grads = torch.autograd.grad(loss, leaves)
        it = iter([(p - lr * g).detach() for p, g in zip(leaves, grads)])
    return tree_map(lambda _: next(it), params), loss.detach()
