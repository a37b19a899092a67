"""The port's exact changepoint (int64, 31-bit limbs) vs the JAX
binseg_l2_device (uint64, 32-bit limbs) and an exact rational brute
force.  Integer outputs: exact equality."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_ops import _exact_best_t
from topsicle_tpu.ops import binseg_l2_device as jax_binseg
from topsicle_tpu_torch.ops import binseg_l2_device
from topsicle_tpu_torch.ops.changepoint import _mul_limbs, _mul_limbs_1, _sq_limbs


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(y: np.ndarray, n: np.ndarray):
    t, h = binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n))
    tj, hj = jax_binseg(jnp.asarray(y), jnp.asarray(n))
    return t.numpy(), h.numpy(), np.asarray(tj), np.asarray(hj)


def _limbs_value(limbs, i):
    return sum(int(limb[i]) << (31 * j) for j, limb in enumerate(limbs))


@pytest.mark.parametrize("seed,W", [(0, 400), (1, 3312), (2, 7)])
def test_changepoint_matches_jax(seed, W):
    """Random ragged signals, half with a planted level shift; t and
    has agree on every row, including rows with no admissible
    candidate (t is then the tournament's deterministic pick)."""
    rng = np.random.default_rng(seed)
    B = 16
    y = rng.integers(14, 1400, (B, W)).astype(np.int32)
    cut = rng.integers(1, W, B)
    y[::2] += np.where(np.arange(W)[None, :] < cut[::2, None], 900, 0).astype(np.int32)
    n = rng.integers(0, W + 1, B).astype(np.int32)
    n[:2] = [W, 0]
    t, h, tj, hj = _both(y, n)
    assert t.dtype == np.int64 and h.dtype == np.bool_
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(h, hj)


def test_changepoint_exact_vs_bruteforce():
    rng = random.Random(1234)
    B, W = 16, 400
    ys, ns = [], []
    for b in range(B):
        n = rng.randrange(10, W)
        base = [rng.randrange(1, 60) for _ in range(n)]
        if b % 2 == 0:
            c = rng.randrange(5, n - 5)
            base = [v + 80 for v in base[:c]] + base[c:]
        ys.append(base + [0] * (W - n))
        ns.append(n)
    t, has = binseg_l2_device(torch.tensor(ys, dtype=torch.int64),
                              torch.tensor(ns, dtype=torch.int32))
    for b in range(B):
        want = _exact_best_t(ys[b], ns[b])
        if want is None:
            assert not has[b]
        else:
            assert bool(has[b]) and int(t[b]) == want, b


def test_changepoint_ties_first_best():
    """Constant signal: every candidate ties, the first (t = 5) wins."""
    t, h = binseg_l2_device(torch.full((1, 100), 7, dtype=torch.int32),
                            torch.tensor([100], dtype=torch.int32))
    assert bool(h[0]) and int(t[0]) == 5


def test_changepoint_admissibility_bounds():
    """min_size <= t <= n - min_size: n=6 and n=4 admit no multiple of 5."""
    t, h = binseg_l2_device(torch.ones((3, 50), dtype=torch.int32),
                            torch.tensor([6, 7, 4], dtype=torch.int32))
    assert not h[0] and h[1] and int(t[1]) == 5 and not h[2]


def test_changepoint_no_candidates():
    t, has = binseg_l2_device(torch.ones((2, 4), dtype=torch.int32),
                              torch.tensor([4, 4], dtype=torch.int32))
    assert t.tolist() == [0, 0] and has.tolist() == [False, False]


def test_changepoint_two_limb_divisor_branch():
    """W >= 131072 windows: D = t*(n-t) no longer fits one 32-bit digit,
    so the 2-digit multiplier decides.  Held against the exact brute
    force (the JAX program at this width takes seconds to compile on the
    CPU, and test_ops holds it against the same brute force), with a
    constant tie row."""
    W = 131072
    assert (W * W) // 4 > 0xFFFFFFFF
    rng = random.Random(7)
    y0 = np.fromiter((rng.randrange(1, 60) for _ in range(W)), np.int64, W)
    y0[:77775] += 80
    y1 = np.full(W, 7, np.int64)
    y = np.stack([y0, y1]).astype(np.int32)
    n = np.array([W, W], np.int32)
    t, has = binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n))
    assert bool(has[0]) and int(t[0]) == _exact_best_t(y0.tolist(), W)
    assert bool(has[1]) and int(t[1]) == 5


def test_limb_arithmetic_vs_bignum():
    """Squares of |a| up to 2**63-1 and products with multipliers at the
    edges of the 1-digit (< 2**32) and 2-digit (< 2**62) ranges."""
    a = torch.tensor([(1 << 63) - 1, -((1 << 62) + 999), (1 << 31) - 1, 3, 0,
                      -(1 << 40) - 5], dtype=torch.int64)
    sq = _sq_limbs(a)
    for i in range(len(a)):
        assert _limbs_value(sq, i) == int(a[i]) ** 2
    for d_vals, mul in (([0xFFFFFFFF, 1, (1 << 31) + 7, 12, 0, 1 << 31], _mul_limbs_1),
                        ([(1 << 62) - 1, 1, (1 << 40) + 3, 0xFFFFFFFF, 0, 1 << 31],
                         _mul_limbs)):
        d = torch.tensor(d_vals, dtype=torch.int64)
        prod = mul(sq, d)
        assert all(int(limb.min()) >= 0 for limb in prod)
        for i in range(len(a)):
            assert _limbs_value(prod, i) == int(a[i]) ** 2 * d_vals[i]
    # the 2-digit multiplier agrees with the 1-digit one where both apply
    d = torch.tensor([0xFFFFFFFF, 1, 5, 7, 0, 2], dtype=torch.int64)
    lo, hi = _mul_limbs_1(sq, d), _mul_limbs(sq, d)
    for i in range(len(a)):
        assert _limbs_value(lo, i) == _limbs_value(hi, i)


@pytest.mark.parametrize("W,jump", [(10243, 5), (8193, 4)])
def test_changepoint_matches_jax_at_tile_edges(W, jump):
    """The inputs the tiled CUDA changepoint is held to on the card
    (tests/test_torch_binseg_tiles.py::tile_edge_rows): ties across
    2,048- and 4,096-window edges, odd W, n - 1 on an edge, a larger step
    past n, y up to 2**30.  The port's plain version, which the card test
    compares with, equals the JAX program on every row."""
    from tests.test_torch_binseg_tiles import tile_edge_rows

    y, n, known = tile_edge_rows(W, jump)
    t, h = binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n), jump=jump)
    tj, hj = jax_binseg(jnp.asarray(y), jnp.asarray(n), jump=jump)
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    assert all(bool(h[i]) and int(t[i]) == want for i, want in known.items())
