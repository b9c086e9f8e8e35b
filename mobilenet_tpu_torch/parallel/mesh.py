"""A (data, model) grid of devices driven by one process, and its explicit
collectives: the port of the JAX package's `parallel/mesh.py`.

The JAX package runs its parallel paths single-controller: one process, a
`jax.sharding.Mesh` over local devices, `shard_map` with `psum` and
`ppermute`. The port keeps that shape. `Mesh` is an array of `torch.device`
with named axes; a rank is one cell of it. The process runs each rank's work
in turn on the rank's device (each CUDA launch is asynchronous, so ranks on
different cards overlap); a collective is an explicit reduction over the
ranks' tensors:
  - `psum` adds the partials in rank order on the first rank's device and
    copies the total to each rank's device (a fixed order: results
    reproduce);
  - the ring shift of a pipeline is a `.to(next_device)`.
Autograd passes through `.to()`, so a schedule built from these needs no
backward of its own.

The devices are the caller's to name: `make_mesh` takes `cuda:0..count-1`
unless `devices` is given, and raises when there are fewer than asked for.
`devices=["cpu"] * n` is an n-rank mesh on the host (the tests); on a
one-card machine `["cuda:0"] * n` is n ranks that share the card, each with
its own weights and partials. Neither is chosen silently.

Why not `torch.distributed`: the JAX package is single-host and
single-controller, NCCL refuses two ranks on one card, and process ranks
would cost seconds of start-up per call.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Devices on named axes: `devices` an object array of torch.device,
    one axis per name."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.frompyfunc(torch.device, 1, 1)(np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _named(devices) -> List[torch.device]:
    out = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA devices named but torch.cuda.is_available() "
                           "is False")
    return out


def available_devices(devices=None) -> List[torch.device]:
    """`devices` as torch.devices, or every CUDA device (cuda:0..count-1)."""
    if devices is not None:
        return _named(devices)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the first n of `devices` (default: the CUDA
    devices); n defaults to all of them."""
    avail = available_devices(devices)
    n = n_devices or len(avail)
    if n < 1 or n > len(avail):
        kind = "named" if devices is not None else "CUDA"
        raise ValueError(
            f"make_mesh: need {n} devices, have {len(avail)} {kind} device(s) (name them "
            "with devices=[...]: ['cpu'] * n for host ranks, ['cuda:0'] * n for ranks "
            "that share one card)")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.asarray(avail[:n], dtype=object).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def _require_dp_only_mesh(mesh: Mesh) -> None:
    """The pipelines implement data-parallel serving only: weights are
    replicated and each rank runs the whole network on its batch shard. A
    mesh with any other axis above 1 is refused, never reduced to its data
    axis silently."""
    extra = {name: size for name, size in mesh.shape.items()
             if name != DATA_AXIS and size > 1}
    if DATA_AXIS not in mesh.shape or extra:
        raise ValueError(
            f"pipeline meshes are data-parallel only (axis '{DATA_AXIS}'); got "
            f"{mesh.shape}. For channel-TP use parallel.tp_fused.forward_tp_fused "
            "(the separable kernel on channel shards, one psum per block) or "
            "quant.tp.forward_i8_tp (int8, bit-exact).")


def on_device(device: torch.device):
    """The context in which a rank's kernels launch: its card current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def data_devices(mesh: Mesh) -> List[torch.device]:
    """The first device of each data rank (model rank 0)."""
    return list(mesh.devices.reshape(mesh.shape[DATA_AXIS], -1)[:, 0])


def shard_batch(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """The batch's even split over the data axis (the counterpart of
    `batch_sharding`), shard d on data rank d's first device. A batch that
    does not divide raises."""
    dp = mesh.shape[DATA_AXIS]
    n = int(x.shape[0])
    if n % dp:
        raise ValueError(f"batch {n} does not divide over the data axis of size {dp}")
    return [s.to(dev) for s, dev in zip(x.split(n // dp), data_devices(mesh))]


def gather_batch(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The data ranks' outputs in rank order, on `device`."""
    return torch.cat([p.to(device) for p in parts])


def tree_to(tree, device: torch.device, copy: bool = False):
    """`tree` (dicts, lists, tuples of tensors; other leaves kept) on
    `device`; copy=True gives every tensor its own storage even where it
    already lies there (a rank owns its weights)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=copy)
    if isinstance(tree, dict):
        return {k: tree_to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, copy) for v in tree)
    return tree


def replicate(tree, devices: Sequence[torch.device]) -> List[Any]:
    """A copy of `tree` on each device (the counterpart of `replicated`):
    the first device's is `tree` itself where it already lies there."""
    return [tree_to(tree, d, copy=i > 0) for i, d in enumerate(devices)]


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over ranks: partials added in rank order on the first rank's
    device, the total then copied to each rank's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total if p.device == total.device else total.to(p.device) for p in parts]
