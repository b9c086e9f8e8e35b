"""Tracing and first-call timing.

The port of the JAX package's `utils/profiling.py`:
  - `trace(log_dir)`: a torch.profiler session (the host's activities, and
    the card's where one is used) that writes a Chrome trace file into
    log_dir, viewable in Perfetto or chrome://tracing;
  - `CompileClock`: the wall time of an entry's first call. Where the JAX
    package pays XLA's trace and compile, the port pays the kernels' nvcc
    build at first use (`ops/_build.py`) and the libraries' setup.
`cost_analysis` has no counterpart: it reads XLA's cost model, and the port
compiles no XLA program (as `runtime/metrics.py` says of its XLA fields).
The work per image is `utils/flops.flops_per_image`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

_traces = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host activity, and the card's where one is
    present; on exit write the trace to `<log_dir>/trace_<pid>_<n>.json`,
    whose path the context yields."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_traces)}.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class CompileClock:
    """The wall time of an entry's first call, its card work included."""

    def __init__(self):
        self.seconds: Optional[float] = None

    def compile(self, fn, *args, **kwargs):
        """Call fn(*args, **kwargs) once, timed; returns fn, ready to call."""
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        return fn
