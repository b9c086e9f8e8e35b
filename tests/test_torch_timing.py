"""The port's timing, tracing and numerics-debugging utilities
(`utils/timing.py`, `utils/profiling.py`, `utils/debug.py`): the JAX
package's timing tests ported onto a patched clock (so that no test sleeps
or races the machine's load), `fenced_window`'s step counts and its window
reached where the JAX version falls short, a trace file written around a
forward, and the first non-finite layer and leaf named."""

import json

import numpy as np
import pytest
import torch

from mobilenet_tpu.utils import debug as jax_debug
from mobilenet_tpu_torch import InferencePipeline, ModelConfig
from mobilenet_tpu_torch.models import mobilenet_v1
from mobilenet_tpu_torch.utils import debug, profiling, timing

CFG = ModelConfig(0.25, 64, compute_dtype="float32")


class FakeClock:
    """A clock that moves only when the timed work says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(timing, "_clock", c)
    return c


# -- differenced_chain_ms (the JAX package's tests/test_round3_fixes.py:77-114) ----------------


def test_differenced_chain_nan_on_nonpositive(clock):
    """A long chain measured no slower than the short one (noise) gives NaN,
    never 0.0, after one retry."""
    calls = []

    def make_chain(length):
        def fn(x):
            calls.append(length)
            clock.advance(0.005 if length == 4 else 0.001)
            return x, np.zeros(())

        return fn

    ms = timing.differenced_chain_ms(make_chain, np.zeros(1), 4, reps=1)
    assert ms != ms  # NaN
    # the pair once (a warm call and one rep each), then again at twice the reps
    assert calls.count(16) == 2 + 3 and calls.count(4) == 2 + 3


def test_differenced_chain_measures_real_work(clock):
    per_step_ms = 2.0

    def make_chain(length):
        def fn(x):
            clock.advance(per_step_ms * length / 1e3)
            return x, np.zeros(())

        return fn

    ms = timing.differenced_chain_ms(make_chain, np.zeros(1), 4, reps=2)
    assert ms == pytest.approx(per_step_ms, rel=1e-9)


def test_differenced_chain_retry_recovers(clock):
    """A first pair swamped by noise (a stall in the short chain's warm call
    and both its reps) is measured again with doubled reps; the positive
    difference then counts."""
    short_calls = []

    def make_chain(length):
        def fn(x):
            if length == 5:
                short_calls.append(1)
            stall = 1.0 if length == 5 and len(short_calls) <= 3 else 0.0
            clock.advance(length * 1e-3 + stall)
            return x, torch.zeros(())

        return fn

    ms = timing.differenced_chain_ms(make_chain, np.zeros(1), 5, reps=2)
    assert len(short_calls) == 3 + 5
    assert ms == pytest.approx(1.0, rel=1e-9)


# -- fenced_window ----------------------------------------------------------------------------


def _stepper(clock, seconds_per_step, calls):
    def run():
        calls.append(1)
        clock.advance(seconds_per_step(len(calls)))
        return torch.zeros(2)

    return run


def test_fenced_window_exact_steps_without_window(clock):
    """min_window_s=0 runs exactly `steps` steps, as the JAX version; 0 steps
    run one, so that the fence has an output."""
    for steps, want in ((7, 7), (1, 1), (0, 1)):
        calls, synced = [], []
        dt, n = timing.fenced_window(_stepper(clock, lambda i: 0.01, calls), synced.append,
                                     steps, min_window_s=0)
        assert (n, len(calls), len(synced)) == (want, want, 1)
        assert dt == pytest.approx(0.01 * want)


def test_fenced_window_cpu_output_needs_no_window(clock):
    """By default a window whose output lies on the CPU is not extended."""
    calls = []
    dt, n = timing.fenced_window(_stepper(clock, lambda i: 1e-4, calls), lambda o: o, 3)
    assert (n, len(calls)) == (3, 3)
    assert not timing._on_card((torch.zeros(1), 1))


def test_fenced_window_card_default_window(clock, monkeypatch):
    """Work on the card gets the default 1.5 s window."""
    monkeypatch.setattr(timing, "_on_card", lambda out: True)
    calls = []
    dt, n = timing.fenced_window(_stepper(clock, lambda i: 1 / 64, calls), lambda o: o, 10)
    assert dt >= timing.CARD_WINDOW_S and n == 100  # 10 steps, 0.156 s: 10x more


def test_fenced_window_reaches_the_window(clock):
    """Steps that speed up after the first window (a warm-up the first window
    paid for) leave the JAX version's single extension short of the window
    (30 steps, 0.23 s of 1.5 here); the port extends until the window is
    reached."""
    calls = []
    dt, n = timing.fenced_window(_stepper(clock, lambda i: 1 / 16 if i <= 10 else 1 / 128,
                                          calls), lambda o: o, 10, min_window_s=1.5)
    assert dt >= 1.5
    assert (n, len(calls)) == (210, 10 + 30 + 210)


def test_fenced_window_stops_at_max_steps(clock):
    calls = []
    dt, n = timing.fenced_window(_stepper(clock, lambda i: 1e-6, calls), lambda o: o, 10,
                                 min_window_s=1.5, max_steps=50)
    assert n == 50 and dt < 1.5
    assert len(calls) == 10 + 50


# -- profiling --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipe():
    return InferencePipeline(CFG, device="cpu", seed=4)


@pytest.fixture(scope="module")
def x():
    return torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32))


def test_trace_writes_a_trace_file(pipe, x, tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as path:
        mobilenet_v1.forward(pipe.params, x, CFG, dw_backend="plain")
    events = json.loads(open(path).read())["traceEvents"]
    assert path.startswith(str(tmp_path / "prof"))
    assert any("conv" in e.get("name", "") for e in events)


def test_compile_clock(pipe, x):
    clock = profiling.CompileClock()
    fn = clock.compile(mobilenet_v1.forward, pipe.params, x, CFG)
    assert fn is mobilenet_v1.forward
    assert clock.seconds > 0


# -- debug ------------------------------------------------------------------------------------


@pytest.mark.parametrize("layer,leaf", [("block03_pw", ("pw", "w")),
                                        ("block07_dw", ("dw", "b"))])
def test_checked_forward_names_the_layer(pipe, x, layer, leaf):
    """A NaN planted in one layer's weights is named at that layer's tap, the
    first non-finite one in network order."""
    params = {**pipe.params, "blocks": [
        {k: dict(v) for k, v in b.items()} for b in pipe.params["blocks"]]}
    blk = int(layer[5:7])
    w = params["blocks"][blk][leaf[0]][leaf[1]].clone()
    w.view(-1)[0] = float("nan")
    params["blocks"][blk][leaf[0]][leaf[1]] = w
    with pytest.raises(FloatingPointError, match=f"layer {layer}$"):
        debug.checked_forward(params, x, CFG)
    got = debug.checked_forward(pipe.params, x, CFG)
    torch.testing.assert_close(got, mobilenet_v1.forward(pipe.params, x, CFG), rtol=0, atol=0)


def test_assert_finite_tree_names_the_leaf():
    """The bad leaves by key path, as the JAX package names them (its
    keystr), for numpy leaves; tensors, integer leaves and None too."""
    tree = {"a": np.array([1.0, np.nan]), "b": [np.ones(2), np.array([np.inf])],
            "c": {"d": np.arange(3)}}
    with pytest.raises(AssertionError) as ours:
        debug.assert_finite_tree(tree, "weights")
    with pytest.raises(AssertionError) as theirs:
        jax_debug.assert_finite_tree(tree, "weights")
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value) == "non-finite values in weights: [\"['a']\", \"['b'][1]\"]"
    t = {"w": torch.tensor([1.0, float("-inf")], dtype=torch.bfloat16),
         "n": torch.arange(4), "none": None, "ok": [torch.ones(3)]}
    with pytest.raises(AssertionError, match=r"\['w'\]\"\]$"):
        debug.assert_finite_tree(t)
    debug.assert_finite_tree({"ok": [torch.ones(3), np.zeros(2), 1.5]})
