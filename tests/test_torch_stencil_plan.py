"""The stencil probe's plan (`floors.stencil_plan`) on the CPU: every unit
covered once, a thread's units of one channel, work balanced within one
chain a thread, one wave, the audit runs filling the card; and the claim
the kernel's bf16 variant rests on: a bf16 product or sum rounded once from
its exact value equals the plain version's rounding (float32, then bf16)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from mobilenet_tpu_torch import floors

SMS = 132
# blocks an SM holds of the kernels with 1, 2, 3, 4 and 8 chains: register
# budgets the H100's occupancy query may give
BLOCKS_PER_SM = [(8, 8, 8, 8, 8), (8, 8, 8, 6, 4), (6, 5, 5, 4, 4), (2, 2, 1, 1, 1)]
MAX_ELEMS = 8 * 56 * 56 * 128


def _elem_counts(c):
    """Element counts (multiples of C) from one pixel up to 8 x 56^2 x 128:
    fixed edge counts and a seeded log-uniform sample."""
    targets = [1, 2, 17, 1000, 12544, 100352, 270336, 270337, 401408, 1000003, MAX_ELEMS]
    rng = np.random.default_rng(c)
    targets += [int(v) for v in np.exp(rng.uniform(0, np.log(MAX_ELEMS), 12))]
    return sorted({max(1, t // c) * c for t in targets if t // c * c <= MAX_ELEMS} | {c})


def _check_plan(units, c, bps, seen=set()):
    p = floors.stencil_plan(units, c, SMS, bps)
    k = p.chains * p.passes
    assert p.chains in floors.STENCIL_CHAINS and p.passes >= 1
    assert p.stride % c == 0 and p.stride >= 1
    assert (p.grid - 1) * floors.STENCIL_THREADS < p.stride <= p.grid * floors.STENCIL_THREADS
    assert p.grid <= SMS * bps[floors.STENCIL_CHAINS.index(p.chains)]  # one wave
    assert k * p.stride >= units
    if (units, c, p) in seen:  # the cover below depends on these alone
        return p
    seen.add((units, c, p))
    # thread t's units are t + j stride (j < k): each unit once
    t = np.arange(p.stride, dtype=np.int64)
    idx = (t[:, None] + np.arange(k, dtype=np.int64)[None, :] * p.stride).ravel()
    real = idx[idx < units]
    assert real.size == units
    assert np.array_equal(np.bincount(real, minlength=units), np.ones(units, np.int64))
    # all of one channel: unit u is element u, or (bf16) elements 2u and 2u + 1
    for ch in (idx % c, 2 * idx % c):
        ch = ch.reshape(p.stride, k)
        assert (ch == ch[:, :1]).all()
    # balanced within one chain a thread
    counts = (idx < units).reshape(p.stride, k).sum(axis=1)
    assert counts.max() - counts.min() <= 1
    return p


@pytest.mark.parametrize("c", [1, 3, 16, 17, 128, 512, 1024])
def test_stencil_plan_covers_once(c):
    """For C in {1, 3, 16, 17, 128, 512, 1024}, element counts from one
    pixel to 8 x 56^2 x 128, each variant's units (bf16: pairs) and four
    occupancy budgets on 132 SMs: every unit covered exactly once, a
    thread's units of one channel, at most one chain between two threads'
    work, the grid one wave."""
    for elems in _elem_counts(c):
        for units in {elems, floors.stencil_units(elems, "bf16")}:
            for bps in BLOCKS_PER_SM:
                _check_plan(units, c, bps)


@pytest.mark.parametrize("run", floors.STENCIL_RUNS, ids=lambda r: r[0])
def test_stencil_plan_fills_the_card(run):
    """At the timed runs the plan's chain-rounds an SM are within 2% of an
    even split of the work over the card's thread slots, at each of the
    full-occupancy budgets."""
    _, variant, h, w, c, _, images = run
    units = floors.stencil_units(images * h * w * c, variant)
    for bps in BLOCKS_PER_SM[:3]:
        p = _check_plan(units, c, bps)
        per_sm = -(-p.grid // SMS) * p.chains * p.passes * floors.STENCIL_THREADS
        assert units / (SMS * per_sm) >= 0.98, (bps, p)


def test_stencil_plan_rejects():
    with pytest.raises(ValueError):
        floors.stencil_plan(0, 8, SMS, BLOCKS_PER_SM[0])
    with pytest.raises(ValueError):
        floors.stencil_plan(10, 8, 1, (0, 0, 0, 0, 0))


def _bf16_bits_to_fraction(bits):
    """bf16 bit patterns (uint16) -> exact Fractions, via float32."""
    f32 = (bits.astype(np.uint32) << 16).view(np.float32)
    return [Fraction(float(v)) for v in f32]


def _round_bf16(q: Fraction):
    """(q rounded to the nearest bf16 value, ties to even; whether q was a
    tie), in the normal range."""
    if q == 0:
        return Fraction(0), False
    sign, a = (1 if q > 0 else -1), abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (e - 7)  # 8 significant bits
    n, rem = divmod(a, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and n % 2 == 1):
        n += 1
    return sign * n * ulp, rem * 2 == ulp


def _bf16(sign, exp, mant):
    """bf16 bit patterns from sign (0/1), unbiased exponent and 7-bit mantissa."""
    return ((sign.astype(np.uint32) << 15) | ((exp + 127).astype(np.uint32) << 7)
            | mant.astype(np.uint32)).astype(np.uint16)


def _pairs(rng, n):
    """n bf16 pairs: random signs, exponents and mantissas with exponent
    gaps of 0-25 (half of them 7-17), and pairs whose sum lies exactly
    halfway between two bf16 values or one bf16 step of b beside it."""
    sa, sb = rng.integers(0, 2, n), rng.integers(0, 2, n)
    ea = rng.integers(-30, 31, n)
    gap = np.where(rng.random(n) < 0.5, rng.integers(7, 18, n), rng.integers(0, 26, n))
    a = _bf16(sa, ea, rng.integers(0, 128, n))
    b = _bf16(sb, ea - gap, rng.integers(0, 128, n))
    # halfway: b = half of a's step (times 1 + k 2^-7 for k in {0, 1, 127})
    m = n // 4
    k = rng.choice([0, 1, 127], m)
    a_h = _bf16(np.zeros(m, int), ea[:m], rng.integers(0, 128, m))
    b_h = _bf16(rng.integers(0, 2, m), ea[:m] - 8, k)
    return np.concatenate([a, a_h]), np.concatenate([b, b_h])


def _torch_bf16(bits):
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def test_bf16_single_rounding_equals_plain():
    """A bf16 sum and product rounded once to bf16 from the exact value
    (Python fractions), which Hopper's add.rn / mul.rn.bf16x2 compute,
    equals the plain version's bf16 add and multiply (float32, then bf16)
    over a seeded sample: random pairs with exponent gaps of 0-25, many of
    7-17, halfway sums, and every pair of bf16 significands (all halfway
    products among them)."""
    rng = np.random.default_rng(20)
    a, b = _pairs(rng, 40000)
    ma, mb = np.meshgrid(np.arange(128), np.arange(128))  # every significand pair
    zeros = np.zeros(ma.size, int)
    a = np.concatenate([a, _bf16(zeros, rng.integers(-5, 6, ma.size), ma.ravel())])
    b = np.concatenate([b, _bf16(rng.integers(0, 2, ma.size), rng.integers(-5, 6, ma.size),
                                 mb.ravel())])
    ta, tb = _torch_bf16(a), _torch_bf16(b)
    fa, fb = _bf16_bits_to_fraction(a), _bf16_bits_to_fraction(b)
    ties = 0
    for op, plain in ((lambda x, y: x + y, ta + tb), (lambda x, y: x * y, ta * tb)):
        via_f32 = (op(ta.float(), tb.float())).to(torch.bfloat16)
        assert torch.equal(plain.view(torch.int16), via_f32.view(torch.int16))
        for x, y, g in zip(fa, fb, plain.float().tolist()):
            want, tie = _round_bf16(op(x, y))
            assert want == Fraction(g), (x, y, op(x, y), g)
            ties += tie
    assert ties > 1000  # the sample holds ties


@pytest.mark.parametrize("variant", floors.VARIANTS)
def test_stencil_bound_at_its_types_peak(variant):
    """A stencil run's bound takes its operations at the CUDA cores' peak
    for the variant's type (bf16 twice float32's) and its bytes at HBM's
    rate: at 56^2 x 128 x 256 rounds the operations bind (float32 0.0307
    ms, bf16 half of it); at 0 rounds the bytes do."""
    elems = 56 * 56 * 128
    bound, bytes_ms, ops_ms = floors.stencil_bound(elems, 128, 256, variant)
    tflops = 133.8 if variant == "bf16" else 67.0
    assert ops_ms == pytest.approx(256 * 20 * elems / (tflops * 1e12) * 1e3)
    assert bytes_ms == pytest.approx((4 * elems + 18 * 128) / 3.35e12 * 1e3)
    assert bound == ops_ms > bytes_ms
    assert floors.stencil_bound(elems, 128, 0, variant)[0] == bytes_ms
