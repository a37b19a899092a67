"""The fused entries' changepoint on a thread-block cluster, held here on
the CPU.

csrc/binseg.cuh::slice_changepoint runs on C = gridDim.y blocks of a read
(C = 1: one block), block r holding the windows of its window block
(geometry.window_block: r * WB .. r * WB + n_win - 1) at tile_slot
positions of its own shared memory.  It is mirrored here step by step in
Python integers: each block's scan (V = ceil(n_win / threads) values a
thread, 256 threads in the fused entries and in binseg_l2's tiles, 1,024
here too, a shuffle scan a warp, one scan over the warp sums, the partial
sum up to index n - 1 by the thread that holds it), the cluster's
offsets and S_n from the blocks' sums, each block's candidates by stride
(clamped to min_size <= t <= n - min_size before the loop) and its best,
and rank 0's reduction of the blocks' bests in rank order.  The pad words
of a slice hold a poison value that no step may read.  The mirror is held
against the port's plain changepoint (ops.binseg_l2_device), the JAX
package's (topsicle_tpu/ops/changepoint.py::binseg_l2_device) on the same
numpy inputs, and binseg_l2's tile mirror at tiles of WB windows.  The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py).  Integer outputs: tolerance 0.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_binseg_tiles import _beats, tiled_changepoint
from topsicle_tpu.ops import binseg_l2_device

jax_binseg = jax.jit(binseg_l2_device, static_argnames=("jump", "min_size"))
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.ops import geometry

CP_THREADS = 256             # the fused entries' changepoint threads (csrc kCpThreads)
POISON = -(1 << 40)                          # in a slice's pad words


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def slot(p):
    return p + (p >> 5)


def slice_scan(ys, cnt, lim, threads):
    """binseg.cuh::slice_scan on a slice `ys` (numpy int64 at tile_slot
    positions): (the threads' (lo, hi), their exclusive prefixes, the
    slice's prefix sums, its total, its sum through `lim` or None)."""
    vals = ys[slot(np.arange(cnt))]
    assert (vals != POISON).all()
    P = np.concatenate([[0], np.cumsum(vals)])
    V = -(-cnt // threads)
    lo = np.minimum(np.arange(threads) * V, cnt)
    hi = np.minimum(lo + V, cnt)
    local = (P[hi] - P[lo]).reshape(-1, 32)
    incl = np.cumsum(local, axis=1)             # a shuffle scan inside each warp
    before = np.concatenate([[0], np.cumsum(incl[:, 31])[:-1]])    # over the warp sums
    excl = (before[:, None] + incl - local).ravel()
    upto = None
    holder = np.flatnonzero((lo <= lim) & (lim < hi))
    if len(holder):
        i = int(holder[0])
        upto = int(excl[i] + P[lim + 1] - P[lo[i]])
    return list(zip(lo.tolist(), hi.tolist())), excl.tolist(), P, int(P[-1]), upto


def slice_best(chunks, excl, P, t0, offset, s_n, n, jump, min_size, rng):
    """binseg.cuh::slice_best: the block's best (|A|, D, t), or None.  A
    thread's running sum at candidate t is its prefix plus its values
    through t - 1 (the slice's prefix sums P)."""
    bests = []
    for (lo, hi), e in zip(chunks, excl):
        t = max(t0 + lo + 1, min_size)
        t = -(-t // jump) * jump
        best = None
        while t <= min(t0 + hi, n - min_size):
            run = offset + e + int(P[t - t0] - P[lo])
            cand = (abs(n * run - t * s_n), t * (n - t), t)
            if _beats(cand, best):
                best = cand
            t += jump
        bests.append(best)
    rng.shuffle(bests)                          # shuffles and warps: any order
    best = None
    for cand in bests:
        if _beats(cand, best):
            best = cand
    return best


def cluster_changepoint(y, n, jump, min_size, C, threads, seed=0):
    """slice_changepoint over C blocks of a row y [W] (C = 1: one block):
    (t, has).  The blocks are the launcher's window blocks of WB = ceil(W /
    C) windows (a read at slide 1, window 100)."""
    W = len(y)
    if W // jump < 1:
        return 0, False
    y = np.asarray(y, np.int64)
    WB = -(-W // C) if C > 1 else W
    L = W - 1 + 100
    blocks = [geometry.window_block(r, WB, W, L, 100, 1) for r in range(-(-W // WB))]
    assert len(blocks) == C and [b.w0 for b in blocks] == [r * WB for r in range(C)]
    assert sum(b.n_win for b in blocks) == W
    slices = []
    for b in blocks:
        ys = np.full(slot(b.n_win) + 1, POISON, np.int64)
        ys[slot(np.arange(b.n_win))] = y[b.w0:b.w0 + b.n_win]
        slices.append(ys)
    idx_n = max(0, min(n - 1, W - 1))
    scans = [slice_scan(ys, b.n_win, idx_n - b.w0, threads) for ys, b in zip(slices, blocks)]
    totals = [s[3] for s in scans]
    rank_n = idx_n // WB
    s_n = sum(totals[:rank_n]) + scans[rank_n][4]
    rng = random.Random(seed)
    bests = [slice_best(s[0], s[1], s[2], b.w0, sum(totals[:r]), s_n, n, jump, min_size, rng)
             for r, (b, s) in enumerate(zip(blocks, scans))]
    best = None
    for cand in bests:                          # rank 0, in rank order
        if _beats(cand, best):
            best = cand
    return (jump, False) if best is None else (best[2], True)


def cluster_rows(W, C, jump, seed=0):
    """y [R, W] int32, n [R] int32 built against the window-block edges of
    C blocks, and {row: t} where the answer is known: an exact tie across
    a block edge (a symmetric signal over n windows, t1 - 1 in one block
    and n - t1 - 1 in another: the smaller t1 must win); a step just
    before and just after each edge; n - 1 on a block's last and first
    window; n = 0, 1, 3, W - 1, W; a large step past n; y up to 2**30; a
    constant row."""
    rng = np.random.default_rng(seed)
    WB = -(-W // C) if C > 1 else W
    edges = [r * WB for r in range(1, C)] or [W // 2]
    rows, ns, known = [], [], {}
    n_all = (W // jump) * jump
    t1 = ((min(edges[0], n_all // 2) - 1) // jump) * jump
    if t1 >= jump and (C == 1 or (t1 - 1) // WB != (n_all - t1 - 1) // WB):
        y = np.full(W, 10)
        y[:t1] = y[n_all - t1:n_all] = 50
        y[n_all:] = rng.integers(0, 1000, W - n_all)
        known[len(rows)] = t1
        rows.append(y)
        ns.append(n_all)
    for e in edges:
        for t in ((e // jump) * jump, -(-e // jump) * jump):
            if jump <= t <= W - 2:
                y = rng.integers(0, 20, W)
                y[t:] += 30
                known[len(rows)] = t
                rows.append(y)
                ns.append(W)
    for n in sorted({*(e + d for e in edges for d in (0, 1)), 0, 1, 3, W - 1, W}):
        if 0 <= n <= W:
            y = rng.integers(1, 60, W)
            y[: rng.integers(1, max(2, n))] += 25
            rows.append(y)
            ns.append(n)
    y = rng.integers(1, 60, W)
    y[: W // 3] += 40
    y[W - W // 4:] = 1 << 20
    rows.append(y)
    ns.append(W - W // 4)
    rows.append(rng.integers(0, 1 << 30, W))
    ns.append(W)
    if W // jump >= 1 and W >= 2 + jump:
        known[len(rows)] = jump
    rows.append(np.full(W, 7))
    ns.append(W)
    return np.stack(rows).astype(np.int32), np.array(ns, np.int32), known


CLUSTERS = (1, 2, 3, 8)
WIDTHS = ((3313, 5), (20001, 5), (999, 4))


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("threads", [CP_THREADS, 1024])
@pytest.mark.parametrize("W,jump", WIDTHS)
def test_cluster_changepoint_matches_plain(W, jump, threads, C):
    """Odd W, cut at C window-block edges: the cluster's (t, has) equal
    the port's plain changepoint's and binseg_l2's tile mirror at tiles of
    WB windows, row by row; the known rows (a tie across an edge, steps at
    the edges, a constant row) give their t."""
    y, n, known = cluster_rows(W, C, jump, seed=W + C)
    t, has = ops.binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n), jump=jump)
    WB = -(-W // C) if C > 1 else W
    for i in range(len(n)):
        got = cluster_changepoint(y[i], int(n[i]), jump, 2, C, threads, seed=i)
        assert got == (int(t[i]), bool(has[i])), (i, int(n[i]))
        if threads == CP_THREADS and W < 10000:
            assert got == tiled_changepoint(y[i], int(n[i]), jump, 2, WB, seed=i), i
    for i, want in known.items():
        assert bool(has[i]) and int(t[i]) == want, i


@pytest.mark.parametrize("W,jump", WIDTHS[::2])
def test_cluster_inputs_match_jax(W, jump):
    """The same rows, for every C at once, through the JAX package's
    changepoint on the CPU: the port's plain version, which the cluster
    mirror and the card are held to, equals it row by row."""
    rows = [cluster_rows(W, C, jump, seed=W + C) for C in CLUSTERS]
    y = np.concatenate([r[0] for r in rows])
    n = np.concatenate([r[1] for r in rows])
    t, has = ops.binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n), jump=jump)
    tj, hj = jax_binseg(jnp.asarray(y), jnp.asarray(n), jump=jump)
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(has.numpy(), np.asarray(hj))


@pytest.mark.parametrize("C", CLUSTERS)
def test_cluster_changepoint_short_rows(C):
    """W < jump gives (0, False) on every block; rows of a few windows a
    block (C blocks of one or two windows) and n of 0, 3 and W."""
    jump = 5
    for W in (3, 4, 9, 17):
        if -(-W // max(1, -(-W // C))) != C and C > 1:
            continue                          # no cut of W into exactly C blocks
        rng = np.random.default_rng(W)
        y = rng.integers(0, 50, (4, W)).astype(np.int32)
        y[:, : W // 2] += 30
        n = np.array([W, 0, min(3, W), max(W - 1, 0)], np.int32)
        t, has = ops.binseg_l2_device(torch.from_numpy(y), torch.from_numpy(n))
        for i in range(len(n)):
            assert cluster_changepoint(y[i], int(n[i]), jump, 2, C, CP_THREADS, seed=i) == \
                (int(t[i]), bool(has[i])), (W, i)
        if W < jump:
            assert t.tolist() == [0] * 4 and not has.any()
        if C == 1 and W in (4, 17):
            tj, hj = jax_binseg(jnp.asarray(y), jnp.asarray(n), jump=jump)
            np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
            np.testing.assert_array_equal(has.numpy(), np.asarray(hj))


def test_tie_across_blocks_is_a_real_tie():
    """The symmetric row of cluster_rows is an exact tie of g between t1
    and n - t1, with t1 - 1 and n - t1 - 1 in different blocks."""
    W, C, jump = 3313, 2, 5
    y, n, known = cluster_rows(W, C, jump)
    WB = -(-W // C)
    S = np.concatenate([[0], np.cumsum(y[0].astype(np.int64))]).tolist()
    nn, t1 = int(n[0]), known[0]
    (a1, d1), (a2, d2) = [(nn * S[t] - t * S[nn], t * (nn - t)) for t in (t1, nn - t1)]
    assert a1 * a1 * d2 == a2 * a2 * d1 and t1 < nn - t1
    assert (t1 - 1) // WB != (nn - t1 - 1) // WB


def test_slice_layout_matches_the_launchers():
    """A slice's pad word falls after every 32 windows (tile_slot), and
    its bytes are what the launchers' layouts reserve for it."""
    for w in (1, 31, 32, 33, 3312, 29903, 33328):
        assert geometry.slice_bytes(w) == geometry.round16(4 * slot(w))
        assert geometry.slice_bytes(w) >= 4 * (slot(w - 1) + 1)
    assert [slot(p) for p in (0, 31, 32, 63, 64)] == [0, 31, 33, 64, 66]
