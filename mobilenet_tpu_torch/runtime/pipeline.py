"""Inference runtime: device-resident weights and the entry points.

The port of the JAX package's `runtime/pipeline.py` for MobileNet-V1,
MobileNet-V2 and MobileNet-V3 on one device, or data-parallel over a mesh
(parallel/mesh.py). `PipelineBase` holds the uint8-in paths (classify,
run_batch, benchmark) that the float `InferencePipeline` and the int8
`quant.model.Int8Pipeline` share. The weights move to the device once, at
construction; with `mesh=` to every rank of its data axis, once, and each
call splits its batch evenly over the ranks (an uneven batch raises, as
the JAX package's shard_map does), runs the whole route on each shard on
its rank's device and gathers the outputs in order on the first. A mesh
with a model axis above 1 is refused (`_require_dp_only_mesh`). PyTorch
runs eagerly, so an "entry" is a plain function; each call runs the
kernels on the current CUDA stream. `benchmark()` times with CUDA events on
a device-resident batch and refuses to run without a card.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoints import default_folded, to_device
from ..checkpoints.convert import prepare_kernel_layouts
from ..config import ModelConfig
from ..models import mobilenet_v1, mobilenet_v2, mobilenet_v3
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config
from ..ops.preprocess import preprocess
from ..parallel.mesh import (_require_dp_only_mesh, data_devices, gather_batch, on_device,
                             replicate, shard_batch)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# config type -> (forward, predict) of the inverted-residual families (their
# init and fold: checkpoints.family_fns)
_FAMILIES = {
    V2Config: (mobilenet_v2.forward_v2, mobilenet_v2.predict_probs_v2),
    V3Config: (mobilenet_v3.forward_v3, mobilenet_v3.predict_probs_v3),
}


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no silent move
    to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda."
                           "is_available() is False")
    return dev


def _gather(outs, device):
    """The data ranks' outputs (tensors, or tuples and dicts of them) in
    rank order, on `device`."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return gather_batch(outs, device)
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], device) for k in first}
    return type(first)(_gather(list(parts), device) for parts in zip(*outs))


class PipelineBase:
    """The uint8-in paths shared by the float and int8 pipelines: a subclass
    sets `config` and `device` (through `_init_mesh`), builds its weights in
    the attribute `_weights_attr`, calls `_replicate()`, and builds the
    `_entry(kind, rank)` functions (`kind` "probs_u8": uint8 NHWC on the
    rank's device -> float32 probabilities there) on `_weights(rank)`."""

    config: ModelConfig
    device: torch.device
    mesh = None
    _weights_attr = "params"

    def _init_mesh(self, mesh, device) -> torch.device:
        """The pipeline's device: `device`, or with a mesh its first data
        rank's (a model axis above 1 refused)."""
        self.mesh = mesh
        if mesh is None:
            return resolve_device(device)
        _require_dp_only_mesh(mesh)
        devices = [resolve_device(d) for d in data_devices(mesh)]  # each must exist
        return devices[0]

    def _replicate(self) -> None:
        """The weights on every data rank's device, once (a rank owns its
        copy, also where ranks share a card)."""
        if self.mesh is not None:
            self._replicas = replicate(getattr(self, self._weights_attr),
                                       data_devices(self.mesh))

    def _weights(self, rank: int = 0):
        if self.mesh is None:
            return getattr(self, self._weights_attr)
        return self._replicas[rank]

    def _entry(self, kind: str, rank: int = 0):
        raise NotImplementedError

    def _call(self, kind: str, x: torch.Tensor):
        """The entry `kind` on x (host or device): on the pipeline's device,
        or each data rank's shard on its device, gathered on the first."""
        if self.mesh is None:
            return self._entry(kind)(x.to(self.device))
        outs = []
        for rank, shard in enumerate(shard_batch(self.mesh, x)):
            with on_device(shard.device):
                outs.append(self._entry(kind, rank)(shard))
        return _gather(outs, self.device)

    @staticmethod
    def _host(arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr))

    def _to_device(self, arr) -> torch.Tensor:
        return self._host(arr).to(self.device)

    # -- user-facing paths --------------------------------------------------

    @torch.inference_mode()
    def classify(self, image_u8: np.ndarray, top_k: int = 5):
        """One (H, W, 3) uint8 image -> top-k [(class, prob)] (a mesh of
        more than one data rank cannot split it and raises)."""
        probs = self._call("probs_u8", self._host(image_u8[None]))[0]
        probs = probs.cpu().numpy()
        idx = np.argsort(-probs)[:top_k]
        return [(int(i), float(probs[i])) for i in idx]

    @torch.inference_mode()
    def run_batch(self, images_u8) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, classes) float32 probabilities (host)."""
        return self._call("probs_u8", self._host(images_u8)).cpu().numpy()

    # -- throughput mode ----------------------------------------------------

    @torch.inference_mode()
    def benchmark(self, batch_size: int = 256, steps: int = 40, warmup: int = 5,
                  latency_iters: int = 30) -> Dict[str, Any]:
        """uint8-in throughput and batch-1 latency on the card.

        images_per_sec: CUDA-event time of `steps` back-to-back calls on one
        device-resident uint8 batch. e2e_images_per_sec: the same with each
        batch copied host->device from pinned memory inside the window.
        p50/p99_latency_ms: host clock around a batch-1 call from host
        uint8 to host probabilities, synchronized (with a mesh, a batch of
        one image a data rank: `latency_batch`)."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark() measures the card; the pipeline's "
                               f"device is {self.device}")
        res = self.config.resolution
        entry = functools.partial(self._call, "probs_u8")
        rng = np.random.default_rng(0)
        host = torch.from_numpy(
            rng.integers(0, 256, (batch_size, res, res, 3), dtype=np.uint8)).pin_memory()
        dev_batch = host.to(self.device)
        for _ in range(warmup):
            entry(dev_batch)
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            entry(dev_batch)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3

        e2e_steps = max(4, steps // 4)
        start.record()
        for _ in range(e2e_steps):
            entry(host.to(self.device, non_blocking=True))
        end.record()
        end.synchronize()
        e2e_dt = start.elapsed_time(end) / 1e3

        one = host[:1 if self.mesh is None else len(data_devices(self.mesh))].numpy()
        self.run_batch(one)
        lats = []
        for _ in range(latency_iters):
            t = time.perf_counter()
            self.run_batch(one)
            lats.append(time.perf_counter() - t)
        return {
            "device": torch.cuda.get_device_name(self.device),
            "images_per_sec": steps * batch_size / dt,
            "e2e_images_per_sec": e2e_steps * batch_size / e2e_dt,
            "batch_size": batch_size,
            "latency_batch": len(one),
            "steps": steps,
            "wall_s": dt,
            "p50_latency_ms": float(np.percentile(lats, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lats, 99) * 1e3),
        }


class InferencePipeline(PipelineBase):
    """Owns device-resident weights and the entry points for one V1 variant
    (a ModelConfig), one V2 variant (a V2Config) or one V3 variant (a
    V3Config)."""

    def __init__(self, config, params: Optional[Dict[str, Any]] = None,
                 *, device="cuda", seed: int = 0, dw_backend: Any = "auto",
                 dtype: Optional[torch.dtype] = None, fuse_stem: bool = False, mesh=None):
        """`params`: a folded host tree (numpy leaves, e.g. from load_npz);
        None draws the seeded weight set. `device`: "cuda" (default),
        "cuda:N" or "cpu". `dw_backend`: "auto" (kernels), "plain", "fused",
        a per-block tuple (models.mobilenet_v1._routing), or for V2 and V3
        also "mixed" (models.mobilenet_v2._routing_v2,
        models.mobilenet_v3._routing_v3). `fuse_stem` (MobileNet-V1 only;
        V2 and V3 ignore it, as in the JAX package): uint8 batches at model
        resolution take `mobilenet_v1.forward_u8(fuse_stem=True)`, the
        normalize + stem + block-0 kernel; off by default. `mesh`: a
        data-parallel parallel.mesh.Mesh (module docstring); `device` is
        then unused."""
        self.config = config
        self.device = self._init_mesh(mesh, device)
        self.dtype = dtype if dtype is not None else _DTYPES[config.compute_dtype]
        self.dw_backend = dw_backend
        self.fuse_stem = fuse_stem
        if type(config) not in _FAMILIES and not isinstance(config, ModelConfig):
            raise TypeError(f"config must be a ModelConfig, a V2Config or a V3Config, "
                            f"got {config!r}")
        host = params if params is not None else default_folded(config, seed=seed)
        if type(config) in _FAMILIES:
            self._forward, self._predict = _FAMILIES[type(config)]
            self.params = to_device(host, self.device, self.dtype)
        else:
            self.params = prepare_kernel_layouts(
                to_device(host, self.device, self.dtype), config.block_strides)
            self._forward, self._predict = mobilenet_v1.forward, mobilenet_v1.predict_probs
        self._replicate()

    # -- entries ------------------------------------------------------------

    def _entry(self, kind: str, rank: int = 0):
        cfg, params = self.config, self._weights(rank)
        if kind == "probs_u8":
            fuse = self.fuse_stem and isinstance(cfg, ModelConfig)

            def fn(images_u8):
                if fuse and images_u8.shape[1] == images_u8.shape[2] == cfg.resolution:
                    return mobilenet_v1.predict_probs_u8(
                        params, images_u8, cfg, dtype=self.dtype,
                        dw_backend=self.dw_backend, fuse_stem=True)
                x = preprocess(images_u8, cfg.resolution, self.dtype)
                return self._predict(params, x, cfg, dw_backend=self.dw_backend)
        elif kind == "probs_f":
            def fn(x):
                return self._predict(params, x.to(self.dtype), cfg,
                                     dw_backend=self.dw_backend)
        elif kind == "collect":
            def fn(x):
                return self._forward(params, x.to(self.dtype), cfg,
                                     dw_backend=self.dw_backend, collect=True)
        else:
            raise KeyError(kind)
        return fn

    # -- per-layer and preprocessed paths ---------------------------------

    @torch.inference_mode()
    def run_preprocessed(self, x) -> torch.Tensor:
        """Preprocessed NHWC -> device probabilities."""
        return self._call("probs_f", torch.as_tensor(x))

    @torch.inference_mode()
    def activations(self, x):
        """Per-layer taps for the verify gates: (logits, {name: array}), on
        the pipeline's routing (MobileNet-V1: the depthwise kernel gives the
        depthwise taps of "fused" and "dw" blocks, the plain ops the rest)."""
        logits, acts = self._call("collect", torch.as_tensor(x))
        return (logits.float().cpu().numpy(),
                {k: v.float().cpu().numpy() for k, v in acts.items()})
