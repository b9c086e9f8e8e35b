"""Fenced throughput windows and differenced latency chains.

The port of the JAX package's `utils/timing.py`. A call on the card returns
when its kernels are queued, not when they finish, so a timed window ends
with a fence: the caller's `sync`, which on the card reads a few bytes of
the last output back to the host. The fence's own cost is inside the window
once, so a short window is stretched until that cost is small.

One change from the JAX package: `fenced_window` extends a short window
until it reaches `min_window_s` (or `max_steps`), where the JAX version
extends once and can fall short. The clock is the module's `_clock`.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

_clock = time.perf_counter

# The default window on the card: long enough that a fence of ~0.03 ms and
# the first launches' host work stay far below 1% of it.
CARD_WINDOW_S = 1.5


def _on_card(out) -> bool:
    """True when `out` (a tensor, or a tuple or list that holds one first)
    lies on a CUDA device."""
    while isinstance(out, (tuple, list)) and out:
        out = out[0]
    return isinstance(out, torch.Tensor) and out.is_cuda


def fenced_window(run_step: Callable[[], object], sync: Callable[[object], object],
                  steps: int, *, min_window_s: Optional[float] = None,
                  max_steps: int = 4000) -> Tuple[float, int]:
    """Time `steps` back-to-back calls of run_step, fenced by sync(last out).

    min_window_s: default CARD_WINDOW_S when the timed work's output lies on
    the card, 0 elsewhere (no extension). While the window is shorter than
    min_window_s, the step count grows by the window's shortfall (at least
    twice, at most `max_steps`) and the window is timed again. With
    min_window_s 0 exactly max(1, steps) steps run. Returns (seconds,
    steps run in the returned window)."""
    steps = max(1, steps)  # steps=0 would leave the fence with nothing to sync

    def window(n):
        t0 = _clock()
        for _ in range(n):
            out = run_step()
        sync(out)
        return _clock() - t0, out

    dt, out = window(steps)
    if min_window_s is None:
        min_window_s = CARD_WINDOW_S if _on_card(out) else 0.0
    while min_window_s and dt < min_window_s and steps < max_steps:
        grow = max(2, math.ceil(min_window_s / max(dt, 1e-3)))
        steps = min(steps * grow, max_steps)
        dt, _ = window(steps)
    return dt, steps


def _fetch(value):
    """The value on the host (a tensor on the card is read back: the fence)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def differenced_chain_ms(make_chain, x, k: int, *, reps: int = 3,
                         long_factor: int = 4) -> float:
    """Per-forward ms from two chain lengths, the fixed costs cancelled.

    `make_chain(length)` returns a function whose call on x runs `length`
    data-dependent forwards and returns (carry, small); fetching `small`
    fences the chain. Best-of-`reps` times of chains of k and long_factor*k
    forwards are differenced: ms = (dt_long - dt_short) / ((long_factor-1)*k),
    which cancels the fence and every other cost paid once a chain.

    A non-positive difference means noise swamped the measurement; the pair
    is measured once more with twice the reps, and if the difference is
    still non-positive the result is NaN: a failed measurement, never a
    latency of 0.0 ms."""

    def best_of(fn, n_reps):
        _fetch(fn(x)[1])  # warm
        best = float("inf")
        for _ in range(n_reps):
            t0 = _clock()
            _fetch(fn(x)[1])
            best = min(best, _clock() - t0)
        return best

    short_fn = make_chain(k)
    long_fn = make_chain(long_factor * k)
    diff = best_of(long_fn, reps) - best_of(short_fn, reps)
    if diff <= 0:  # noise-swamped window: one retry with doubled reps
        diff = best_of(long_fn, 2 * reps) - best_of(short_fn, 2 * reps)
    if diff <= 0:
        return float("nan")
    return diff / ((long_factor - 1) * k) * 1e3
