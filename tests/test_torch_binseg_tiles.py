"""binseg_l2's tiles: the plan (ops.geometry.binseg_tiles) and the
decomposition csrc/binseg.cu runs on it, held here on the CPU.

The decomposition is mirrored step by step in Python integers (tile sums
and the partial sum up to index n - 1 in pass 1; in pass 2 each tile's
offset and S_n from them, a thread's V consecutive values, an exclusive
scan, the candidates t whose t - 1 the tile holds, the tile's best, and
the row's best over the tiles in any order) and held against the plain
changepoint, ops.binseg_l2_device, on inputs built against the tiles'
edges.  The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py) on the same inputs.  Integer outputs:
tolerance 0.
"""

import random

import numpy as np
import pytest
import torch

from topsicle_tpu_torch import ops
from topsicle_tpu_torch.ops import cuda_kernels, geometry


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tile_edge_rows(W, jump, seed=0):
    """y [R, W] int32 and n [R] int32 built against tile edges of 2,048
    and 4,096 windows, and {row: t} where the answer is known:
    - ties: a signal symmetric over its n windows (high, low, high) gives
      g(t1) == g(n - t1) exactly, with t1 - 1 before an edge and n - t1 - 1
      after it: the smaller t1 must win, whichever tile finishes first;
    - a step at each multiple of 2,048 that is a candidate, so that the best
      t has t - 1 on a tile's last index;
    - n - 1 on an edge (n = 2,048, 2,049, 4,096, 4,097), n = 0, 1, W - 1, W;
    - n < W with a far larger step in a tile past n, which no valid
      candidate reaches;
    - y up to 2**30 (A**2 past 64 bits) and a constant row (every
      candidate ties)."""
    rng = np.random.default_rng(seed)
    rows, ns, known = [], [], {}
    n_all = (W // jump) * jump
    for edge in (2048, 4096):
        t1 = (edge // jump) * jump
        if n_all - t1 <= edge:
            t1 -= jump
        y = np.full(W, 10)
        y[:t1] = y[n_all - t1:n_all] = 50
        y[n_all:] = rng.integers(0, 1000, W - n_all)
        known[len(rows)] = t1
        rows.append(y)
        ns.append(n_all)
    for t in range(2048, W - 1, 2048):
        if t % jump == 0:
            y = rng.integers(0, 20, W)
            y[t:] += 30
            known[len(rows)] = t
            rows.append(y)
            ns.append(W)
    for n in (2048, 2049, 4096, 4097, 0, 1, W - 1, W):
        y = rng.integers(1, 60, W)
        y[: rng.integers(1, max(2, n))] += 25
        rows.append(y)
        ns.append(n)
    y = rng.integers(1, 60, W)
    y[:1500] += 40
    y[W - 1200:] = 1 << 20
    rows.append(y)
    ns.append(3000)
    rows.append(rng.integers(0, 1 << 30, W))
    ns.append(W)
    known[len(rows)] = jump
    rows.append(np.full(W, 7))
    ns.append(W)
    return np.stack(rows).astype(np.int32), np.array(ns, np.int32), known


def _beats(p, q):
    """binseg.cuh::beats on (|A|, D, t) in Python integers."""
    if p is None:
        return False
    if q is None:
        return True
    lhs, rhs = p[0] * p[0] * q[1], q[0] * q[0] * p[1]
    return lhs > rhs or (lhs == rhs and p[2] < q[2])


def tiled_changepoint(y, n, jump, min_size, tw, threads=geometry.BINSEG_THREADS, seed=0):
    """csrc/binseg.cu's two passes over one row y [W], in Python integers:
    (t, has)."""
    W = len(y)
    tw = min(tw, W)
    if W // jump < 1:
        return 0, False
    y = [int(v) for v in y]
    n_tiles = -(-W // tw)
    idx_n = max(0, min(n - 1, W - 1))
    tiles = [(i * tw, min(tw, W - i * tw)) for i in range(n_tiles)]
    # pass 1: the tile sums, and the partial sum up to idx_n in its tile
    tile_sums = [sum(y[t0:t0 + cnt]) for t0, cnt in tiles]
    tile_n = idx_n // tw
    upto_n = sum(y[tile_n * tw:idx_n + 1])
    s_n = sum(tile_sums[:tile_n]) + upto_n
    # pass 2: each tile's best candidate
    V = -(-tw // threads)
    bests = []
    for i, (t0, cnt) in enumerate(tiles):
        chunks = [(min(j * V, cnt), min(j * V + V, cnt)) for j in range(threads)]
        local = [sum(y[t0 + lo:t0 + hi]) for lo, hi in chunks]
        run_before = sum(tile_sums[:i])
        best = None
        for (lo, hi), excl in zip(chunks, np.cumsum([0] + local[:-1]).tolist()):
            run = run_before + int(excl)
            next_t = ((t0 + lo) // jump + 1) * jump
            for p in range(lo, hi):
                run += y[t0 + p]
                if t0 + p + 1 == next_t:
                    t = next_t
                    next_t += jump
                    if min_size <= t <= n - min_size:
                        cand = (abs(n * run - t * s_n), t * (n - t), t)
                        if _beats(cand, best):
                            best = cand
        bests.append(best)
    random.Random(seed).shuffle(bests)          # the blocks arrive in any order
    best = None
    for cand in bests:
        if _beats(cand, best):
            best = cand
    return (jump, False) if best is None else (best[2], True)


@pytest.mark.parametrize("W", [1, 4, 5, 255, 256, 3312, 4096, 4097, 8193, 10243, 131080,
                               174747, 999936])
def test_plan_tiles_cover_a_row(W):
    """The plan's tiles cover the W windows exactly, at least one a row,
    each a multiple of 256 windows (V = tile / 256 values a thread)."""
    tw, n_tiles = geometry.binseg_tiles(4, W)
    assert n_tiles >= 1 and tw % geometry.BINSEG_THREADS == 0
    assert (n_tiles - 1) * tw < W <= n_tiles * tw
    assert min(tw, W) <= geometry.BINSEG_MAX_TILE
    assert tw // geometry.BINSEG_THREADS in (4, 8, 16)


@pytest.mark.parametrize("W,forced,n_tiles", [
    (3312, 32, 104), (3312, 100, 34), (3312, 2048, 2), (3312, 1, 3312), (174747, 2048, 86),
    (100, 8192, 1), (10, 100000, 1), (8192, 8192, 1), (8193, 8192, 2)])
def test_forced_tiles_are_any_positive_count(W, forced, n_tiles):
    tw, n = geometry.binseg_tiles(128, W, forced)
    assert (tw, n) == (forced, n_tiles)
    assert (n - 1) * tw < W <= n * tw


def test_forced_tiles_out_of_range_raise():
    with pytest.raises(ValueError, match=">= 0"):
        geometry.binseg_tiles(4, 100, -1)
    with pytest.raises(ValueError, match="at most 8192"):
        geometry.binseg_tiles(4, 10000, 8193)
    with pytest.raises(ValueError, match="grid"):
        geometry.binseg_tiles(2 ** 21, 2 ** 20, 1)
    y = torch.ones((2, 10000), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 8192"):
        cuda_kernels.binseg_l2(y, torch.tensor([10000, 5], dtype=torch.int32),
                               tile_windows=9000)


def test_plan_at_the_measured_shapes():
    """The tile counts PERF.md states: the step-2 batch's y [128, 3,312] is
    one tile a row (one launch), the megabase scan's y [4, 174,747] 86
    tiles of 2,048 windows (two launches of 344 blocks)."""
    assert geometry.binseg_tiles(128, 3312) == (4096, 1)
    assert geometry.binseg_tiles(4, 174747) == (2048, 86)
    assert geometry.binseg_tiles(8, 59805) == (2048, 30)


@pytest.mark.parametrize("W,jump,tw", [(10243, 5, 2048), (10243, 5, 4096), (8193, 4, 2048),
                                       (8193, 4, 4096), (10243, 5, 1000), (8193, 4, 8192)])
def test_tile_decomposition_matches_plain(W, jump, tw):
    """The two passes, mirrored in Python integers, give the plain
    changepoint's (t, has) on every tile-edge row, with the tiles' bests
    reduced in a shuffled order; the tie rows are real ties."""
    y, n, known = tile_edge_rows(W, jump)
    t, has = ops.binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n), jump=jump)
    for i in range(len(n)):
        got = tiled_changepoint(y[i], int(n[i]), jump, 2, tw, seed=i)
        assert got == (int(t[i]), bool(has[i])), (i, int(n[i]))
    for i, want in known.items():
        assert bool(has[i]) and int(t[i]) == want, i
    for i, edge in enumerate((2048, 4096)):      # the symmetric rows
        S = np.concatenate([[0], np.cumsum(y[i].astype(np.int64))]).tolist()
        nn, t1 = int(n[i]), known[i]
        (a1, d1), (a2, d2) = [(nn * S[t] - t * S[nn], t * (nn - t)) for t in (t1, nn - t1)]
        assert a1 * a1 * d2 == a2 * a2 * d1 and t1 < nn - t1
        assert (t1 - 1) // edge != (nn - t1 - 1) // edge


@pytest.mark.parametrize("W,tw", [(4, 1), (7, 3), (333, 32), (3312, 100)])
def test_tile_decomposition_small_rows(W, tw):
    """Rows shorter than jump, of a few tiles, and tiles of one window."""
    rng = np.random.default_rng(W)
    y = rng.integers(0, 50, (6, W)).astype(np.int32)
    y[:, : W // 3] += 20
    n = np.array([W, 0, 1, 3, max(W - 1, 0), W // 2], np.int32)
    t, has = ops.binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n))
    for i in range(len(n)):
        assert tiled_changepoint(y[i], int(n[i]), 5, 2, tw, seed=i) == \
            (int(t[i]), bool(has[i])), i


def test_cpu_wrapper_takes_the_plain_version_at_any_tile():
    y, n, _ = tile_edge_rows(10243, 5)
    y, n = torch.from_numpy(y), torch.from_numpy(n)
    want = ops.binseg_l2_device(y, n)
    for tw in (0, 32, 2048):
        t, has = cuda_kernels.binseg_l2(y, n, tile_windows=tw)
        assert torch.equal(t, want[0]) and torch.equal(has, want[1])
