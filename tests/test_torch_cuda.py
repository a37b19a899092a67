"""The port on a CUDA card: the hand-written kernels against their plain
versions, and the model and engine on the card against the same code on
the CPU.  Every test needs a card and skips without one.

This file imports nothing of jax or of the JAX package (the port needs
neither), so it runs on the card's machine without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import gzip
import os

import numpy as np
import pytest
import torch

from topsicle_tpu_torch import ops
from topsicle_tpu_torch.config import TopsicleConfig
from topsicle_tpu_torch.io import batch as batching
from topsicle_tpu_torch.kmers import pack_kmer_table, telophrase_kmers
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.models.telomere import HostResult
from topsicle_tpu_torch.ops import cuda_kernels, geometry
from topsicle_tpu_torch.parallel import ShardedScanModel
from topsicle_tpu_torch.pipeline import TorchEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _batch(seed, B, L, lean, pattern="CCCTAAA"):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 4, L + 1, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rep = np.array(["ACGT".index(c) for c in pattern], np.uint8)
    codes[:, :L // 3] = np.resize(rep, L // 3)
    if not lean:
        codes[rng.random((B, L)) < 0.02] = 4
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


def _wire(codes, lens, lean, dev):
    a, b = (batching.pack_codes(codes), lens) if lean else batching.pack_batch(codes)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("k,w,slide,lean", [(5, 100, 6, True), (5, 100, 6, False),
                                            (7, 20, 1, True), (13, 100, 6, False)])
def test_kernel_matches_plain(dev, k, w, slide, lean):
    codes, lens = _batch(k + slide, 64, 4096, lean)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", k))).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    kw = dict(k=k, window_size=w, slide=slide, L=a.shape[1] * 4, lean=lean)
    n0 = cuda_kernels.LAUNCHES["sum_signal"]
    y = cuda_kernels.sum_signal(a, b, table, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["sum_signal"] == n0 + 1
    assert torch.equal(y, cuda_kernels.sum_signal_plain(a, b, table, **kw))
    assert torch.equal(y.cpu(), cuda_kernels.sum_signal(a.cpu(), b.cpu(), table.cpu(), **kw))


@pytest.mark.parametrize("B,L,k,w,slide,lean", [
    (64, 4096, 5, 100, 6, True), (64, 4096, 5, 100, 6, False), (128, 19968, 5, 100, 6, True),
    (16, 4096, 7, 20, 1, True), (16, 4096, 13, 100, 6, False), (5, 1003, 5, 100, 6, False),
    (4, 104, 5, 100, 6, True)])
def test_sum_boundary_matches_plain(dev, B, L, k, w, slide, lean):
    """The fused kernel's (t, has) against plain signal + plain
    changepoint, with window counts of 0, 3 and W among the reads' own;
    L = 1003 gives rows that are not 16-byte aligned (byte loads)."""
    codes, lens = _batch(B + k, B, L, lean)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAACCCTAAA"[:max(7, k)],
                                                               k))).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    kw = dict(k=k, window_size=w, slide=slide, L=a.shape[1] * 4, lean=lean)
    W = ops.num_windows(a.shape[1] * 4, w, slide)
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = np.minimum((0, 3, W), W)
    nw = torch.from_numpy(nw).to(dev)
    n0 = dict(cuda_kernels.LAUNCHES)
    t, has = cuda_kernels.sum_boundary(a, b, table, nw, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["sum_boundary"] == n0["sum_boundary"] + 1
    tp, hp = cuda_kernels.sum_boundary_plain(a, b, table, nw, **kw)
    assert t.dtype == torch.int64 and has.dtype == torch.bool
    assert torch.equal(t, tp) and torch.equal(has, hp)
    tc, hc = cuda_kernels.sum_boundary(a.cpu(), b.cpu(), table.cpu(), nw.cpu(), **kw)
    assert torch.equal(t.cpu(), tc) and torch.equal(has.cpu(), hc)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("body,k", [("sum", 5), ("greedy", 7)])
@pytest.mark.parametrize("lean", [True, False])
def test_fused_entries_on_forced_clusters(dev, C, body, k, lean):
    """sum_boundary and greedy_boundary with each read on a cluster of C
    blocks (C = 1: one block), forced, against their plain versions: odd W
    (667 windows), window counts of 0, 3 and W, n - 1 on a block's last
    and first window, a read of one base throughout (a constant y: every
    candidate ties across the blocks, the smallest t wins), and W < jump."""
    codes, lens = _batch(C + k + lean, 24, 4096, lean)
    codes[5, :lens[5]] = 0
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", k))).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    L = a.shape[1] * 4
    kw = dict(k=k, window_size=100, slide=6, L=L, lean=lean)
    W = ops.num_windows(L, 100, 6)
    cw = -(-W // C) if C > 1 else W
    assert W % 2 == 1 and -(-W // cw) == C
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    nw[:5] = (0, 3, W, cw, min(cw + 1, W))
    nw[5] = W
    nw = torch.from_numpy(nw).to(dev)
    fused = getattr(cuda_kernels, body + "_boundary")
    plain = getattr(cuda_kernels, body + "_boundary_plain")
    n0 = cuda_kernels.LAUNCHES[body + "_boundary"]
    t, has = fused(a, b, table, nw, cluster_windows=cw, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES[body + "_boundary"] == n0 + 1
    tp, hp = plain(a, b, table, nw, **kw)
    assert t.dtype == torch.int64 and has.dtype == torch.bool
    assert torch.equal(t, tp) and torch.equal(has, hp) and has.any()
    assert int(t[5]) == 5 and bool(has[5])          # a constant y: the smallest t
    # a read too short for a candidate, and 3 windows a block
    short = _wire(np.ascontiguousarray(codes[:4, :112]), np.full(4, 112, np.int32), True, dev)
    nws = torch.full((4,), 3, dtype=torch.int32, device=dev)
    skw = dict(kw, L=112, lean=True)
    assert ops.num_windows(112, 100, 6) == 3
    for c in (1, 3):
        got = fused(*short, table, nws, cluster_windows=c, **skw)
        want = plain(*short, table, nws, **skw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0].tolist() == [0] * 4 and not got[1].any()


def test_cluster_route_is_placeable(dev):
    """No fallback: every cluster the picker can return (a sweep of
    geometries, and every C at the largest block) is one the card keeps
    resident (cudaOccupancyMaxActiveClusters > 0); a launch past 8 blocks a
    read is refused, not rerouted."""
    seen = set()
    for L, slide, w, k, K in _sweep():
        W = ops.num_windows(L, w, slide)
        for body in ("sum", "greedy"):
            if W == 0 or (body == "sum" and K > cuda_kernels.MAX_ENTRIES):
                continue
            for dense in (False, True):
                route = geometry.find_route(body, L=L, W=W, K=K, k=k, window_size=w,
                                            slide=slide, dense=dense)
                if route is None or route.kind != "cluster":
                    continue
                plan = geometry._plan(body, L, W, K, k, w - k, slide, dense, True,
                                      route.block_windows)
                key = (body, plan.n_blocks, plan.smem_bytes)
                if key in seen:
                    continue
                seen.add(key)
                assert 2 <= plan.n_blocks <= geometry.MAX_CLUSTER
                assert cuda_kernels.max_active_clusters(
                    body, L=L, W=W, K=K, k=k, J=w - k, slide=slide, dense=dense,
                    block_windows=route.block_windows) > 0, key
    assert len(seen) > 10, seen
    # C = 2 .. 8 at close to a block's whole shared memory (a read of L
    # bases at slide 1 whose blocks hold ~28,000 windows each)
    for C in range(2, geometry.MAX_CLUSTER + 1):
        L = 28_000 * C + 99
        W = ops.num_windows(L, 100, 1)
        plan = geometry.sum_plan(L, W, 5, 95, 1, False, True, -(-W // C))
        assert plan is not None and plan.n_blocks == C and plan.smem_bytes > 200_000, plan
        assert cuda_kernels.max_active_clusters("sum", L=L, W=W, K=14, k=5, J=95, slide=1,
                                                dense=False, block_windows=-(-W // C)) > 0
    codes, lens = _batch(9, 2, 8192, True)
    a, b = _wire(codes, lens, True, dev)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5))).to(dev)
    nw = torch.from_numpy(batching.window_counts_for_lengths(lens, 100, 6)).to(dev)
    W = ops.num_windows(8192, 100, 6)
    n0 = dict(cuda_kernels.LAUNCHES)
    for fn in (cuda_kernels.sum_boundary, cuda_kernels.greedy_boundary):
        with pytest.raises(RuntimeError, match="shared memory"):
            fn(a, b, table, nw, k=5, window_size=100, slide=6, L=8192, lean=True,
               cluster_windows=-(-W // 9))
    assert cuda_kernels.LAUNCHES == n0


def _binseg_case(case, dev):
    """(y [B, W] int32, n [B] int32, jump) on the card for binseg_l2: the
    step-2 shape, all ties, the two-limb range, y up to 2**30, W < jump,
    the rows built against tile edges (odd W, so rows start at every
    residue of 16 bytes), a y whose buffer starts 4 bytes past a 16-byte
    boundary, and enough tiles for thousands of blocks."""
    from tests.test_torch_binseg_tiles import tile_edge_rows

    rng = np.random.default_rng(5)
    jump = 5
    if case.startswith("tile-edges"):
        jump = int(case[-1])
        y, n, _ = tile_edge_rows(10243 if jump == 5 else 8193, jump)
    elif case == "misaligned":
        y, n, _ = tile_edge_rows(8192, 5)
        flat = torch.zeros(y.size + 1, dtype=torch.int32, device=dev)
        flat[1:] = torch.from_numpy(y.ravel()).to(dev)
        y_d = flat[1:].view(y.shape)
        assert y_d.data_ptr() % 16 == 4
        return y_d, torch.from_numpy(n).to(dev), jump
    else:
        y, n = {
            "random": lambda: (rng.integers(1, 120, (64, 3312)), rng.integers(0, 3313, 64)),
            "constant": lambda: (np.full((8, 3312), 7),
                                 np.array([3312, 0, 3, 4, 7, 100, 3311, 9])),
            "two-limb": lambda: (rng.integers(0, 40, (4, 131080))
                                 + 3 * (np.arange(131080)[None, :] < 60000),
                                 np.array([131080, 131079, 70000, 12])),
            "big-y": lambda: (rng.integers(0, 1 << 30, (8, 3000)),
                              np.array([3000, 2999, 17, 4, 0, 1500, 3, 9])),
            "short": lambda: (np.ones((3, 4)), np.array([4, 2, 0])),
            "many-blocks": lambda: (rng.integers(1, 120, (1024, 3312))
                                    + 40 * (np.arange(3312)[None, :] < 1700),
                                    rng.integers(0, 3313, 1024)),
        }[case]()
    return (torch.from_numpy(y.astype(np.int32)).to(dev),
            torch.from_numpy(n.astype(np.int32)).to(dev), jump)


def _binseg_agrees(y, n, jump, **kw):
    """One binseg_l2 call: one launch counted, (t, has) bit for bit the
    plain version's.  Returns (t, has)."""
    n0 = cuda_kernels.LAUNCHES["binseg_l2"]
    t, has = cuda_kernels.binseg_l2(y, n, jump=jump, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["binseg_l2"] == n0 + 1
    tp, hp = ops.binseg_l2_device(y, n, jump=jump)
    assert t.dtype == torch.int64 and has.dtype == torch.bool
    assert torch.equal(t, tp) and torch.equal(has, hp), kw
    return t, has


BINSEG_CASES = ["random", "constant", "two-limb", "big-y", "short", "tile-edges-5",
                "tile-edges-4", "misaligned", "many-blocks"]


@pytest.mark.parametrize("case", BINSEG_CASES)
def test_binseg_l2_matches_plain(dev, case):
    y, n, jump = _binseg_case(case, dev)
    t, has = _binseg_agrees(y, n, jump)
    if case == "constant":
        assert t.tolist() == [5] * 8 and has.tolist() == [True, False, False, False, True,
                                                          True, True, True]
    if case.startswith("tile-edges"):
        from tests.test_torch_binseg_tiles import tile_edge_rows

        _, _, known = tile_edge_rows(y.shape[1], jump)
        assert all(bool(has[i]) and int(t[i]) == w for i, w in known.items())


@pytest.mark.parametrize("tile_windows", [0, 32, 100, 2048])
def test_binseg_l2_forced_tiles(dev, tile_windows):
    """Every case at a forced tile (32 and 100 windows: thousands of
    blocks, tiles that end anywhere; 2,048: the long scans' tile at the
    default shape) and at the plan's own; then the same inputs twice and a
    smaller batch, so a row's ticket left behind by a launch would show."""
    for case in BINSEG_CASES:
        y, n, jump = _binseg_case(case, dev)
        _binseg_agrees(y, n, jump, tile_windows=tile_windows)
    y, n, jump = _binseg_case("tile-edges-5", dev)
    for rows in (len(n), len(n), 3):
        _binseg_agrees(y[:rows], n[:rows], jump, tile_windows=tile_windows)


def test_boundary_wrappers_reject_bad_inputs(dev):
    y = torch.ones((2, 50), dtype=torch.int32, device=dev)
    n = torch.tensor([50, 20], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        cuda_kernels.binseg_l2(y.to(torch.int64), n)
    with pytest.raises(ValueError, match="dtype"):
        cuda_kernels.binseg_l2(y, n.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.binseg_l2(y.t().contiguous().t(), n)
    with pytest.raises(ValueError, match="does not match"):
        cuda_kernels.binseg_l2(y, n[:1])
    with pytest.raises(ValueError, match="jump >= 1"):
        cuda_kernels.binseg_l2(y, n, jump=0)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_kernels.binseg_l2(y, n.cpu())
    t, has = cuda_kernels.binseg_l2(y[:0], n[:0])
    assert t.shape == (0,) and has.shape == (0,)
    codes, lens = _batch(1, 4, 1024, True)
    a, b = _wire(codes, lens, True, dev)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5))).to(dev)
    kw = dict(k=5, window_size=100, slide=6, L=1024, lean=True)
    with pytest.raises(ValueError, match="does not match"):
        cuda_kernels.sum_boundary(a, b, table, n, **kw)
    with pytest.raises(ValueError, match="min_size >= 1"):
        cuda_kernels.sum_boundary(a, b, table, torch.zeros(4, dtype=torch.int32, device=dev),
                                  min_size=0, **kw)
    # a read too long for a block's shared memory is not refused: the model
    # asks the picker first and takes sum_signal on the window-block grid,
    # then binseg_l2, bit-identical to the plain versions
    codes, lens = _batch(2, 2, 1_200_000, True)
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device=dev, window_size=100,
                           slide=6)
    assert model.route("sum", 1_200_000, True, fused=True) == \
        ("sum", ("grid", geometry.BLOCK_WINDOWS))
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    n0 = dict(cuda_kernels.LAUNCHES)
    t, has = model.step2_boundary(codes, nw, lens)
    assert {m: c - n0[m] for m, c in cuda_kernels.LAUNCHES.items() if c != n0[m]} == \
        {"sum_signal": 1, "binseg_l2": 1}
    a, b = _wire(codes, lens, True, dev)
    tp, hp = cuda_kernels.sum_boundary_plain(a, b, table, torch.from_numpy(nw).to(dev),
                                             **dict(kw, L=1_200_000))
    assert np.array_equal(t, tp.cpu().numpy()) and np.array_equal(has, hp.cpu().numpy())
    assert has.all()
    # the fused entry itself, handed what the picker would not hand it: the
    # launcher's refusal is a fault of the caller, not another route
    with pytest.raises(RuntimeError, match="shared memory"):
        cuda_kernels.sum_boundary(a, b, table, torch.from_numpy(nw).to(dev),
                                  **dict(kw, L=1_200_000))


@pytest.mark.parametrize("phrase,kernel,launched", [
    (5, None, ["sum_boundary"]), (5, "sum", ["sum_signal", "binseg_l2"]),
    (5, "greedy", ["greedy_signal", "binseg_l2"]),
    (7, None, ["greedy_boundary"]), (7, "greedy", ["greedy_signal", "binseg_l2"])])
def test_model_routes_on_card(dev, phrase, kernel, launched):
    """Each route launches its kernels and no other, never the plain
    changepoint or the plain step 1, and gives the CPU's (t, has) and
    step-1 counts; step 1 is one launch of step1_counts for every table."""
    from topsicle_tpu_torch.ops import changepoint

    kmers = telophrase_kmers("CCCTAAA", phrase)
    model = TorchScanModel(kmers, device=dev, window_size=100, slide=6, kernel=kernel)
    cpu = TorchScanModel(kmers, device="cpu", window_size=100, slide=6, kernel=kernel)
    codes, lens = _batch(31, 32, 8192, True)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    cuda_kernels.reset_launch_counts()
    plain0 = changepoint.PLAIN_CALLS["cuda"], cuda_kernels.STEP1_PLAIN_CALLS["cuda"]
    t, has = model.step2_boundary(codes, nw, lens)
    assert {n: c for n, c in cuda_kernels.LAUNCHES.items() if c} == dict.fromkeys(launched, 1)
    ends = codes[:, :2000].reshape(32, 2, 1000)
    ends_len = np.minimum(lens, 1000).astype(np.int32)
    counts = model.step1_counts(ends, ends_len)
    assert {n: c for n, c in cuda_kernels.LAUNCHES.items() if c} == \
        dict.fromkeys(launched + ["step1_counts"], 1)
    assert (changepoint.PLAIN_CALLS["cuda"], cuda_kernels.STEP1_PLAIN_CALLS["cuda"]) == plain0
    tc, hc = cpu.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, tc) and np.array_equal(has, hc) and has.any()
    assert np.array_equal(counts, cpu.step1_counts(ends, ends_len)) and counts.max() > 10


# K = 40: two mixed tables, a table whose entries repeat the first two
# (TTAGGG is CCCTAA's reverse complement) and two periodic 7-mers
_K40 = (telophrase_kmers("CCCTAAA", 7) + telophrase_kmers("CCCTAA", 7)
        + telophrase_kmers("TTAGGG", 7) + ["AAAAAAA", "CACACAC"])


@pytest.mark.parametrize("pattern,kmers,w,slide", [
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 7), 100, 6),   # 8 of 14 periodic
    ("CCCTAA", telophrase_kmers("CCCTAA", 5), 100, 6),     # human, 2 of 12
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 3), 100, 6),
    ("ATAT", telophrase_kmers("ATAT", 4), 100, 6),         # periodic duplicates
    ("CCCTAA", _K40, 100, 6),
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 7), 20, 1),
    ("A", ["AAAAAAA", "CCCTAAA"], 100, 6),                 # period 1 on a run of A's
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 7), 200, 6),   # J = 193 > 96: seven plane words
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 7), 72, 31),   # J = 65: bits straddle three words
    ("CCCTAA", _K40 * 3, 100, 6),                          # K = 120: the table in two groups
])
@pytest.mark.parametrize("lean", [True, False])
def test_greedy_kernels_match_plain(dev, pattern, kmers, w, slide, lean):
    """The three entries of the greedy body against their plain versions,
    with window counts of 0, 3 and W among the reads' own."""
    k = len(kmers[0])
    B, L = (16, 19968) if len(kmers) > 100 else (64, 4096)
    codes, lens = _batch(len(kmers) + w, B, L, lean, pattern)
    table = torch.from_numpy(pack_kmer_table(kmers)).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    L = a.shape[1] * 4
    W = (L - w) // slide + 1
    skw = dict(k=k, window_size=w, slide=slide, L=L, lean=lean)
    ckw = dict(k=k, J=w - k, W=W, slide=slide, L=L, lean=lean)
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = np.minimum((0, 3, W), W)
    nw = torch.from_numpy(nw).to(dev)
    n0 = dict(cuda_kernels.LAUNCHES)
    y = cuda_kernels.greedy_signal(a, b, table, **skw)
    c = cuda_kernels.greedy_counts(a, b, table, **ckw)
    t, has = cuda_kernels.greedy_boundary(a, b, table, nw, **skw)
    torch.cuda.synchronize()
    for name in ("greedy_signal", "greedy_counts", "greedy_boundary"):
        assert cuda_kernels.LAUNCHES[name] == n0[name] + 1
    assert torch.equal(y, cuda_kernels.greedy_signal_plain(a, b, table, **skw))
    assert torch.equal(c, cuda_kernels.greedy_counts_plain(a, b, table, **ckw))
    assert torch.equal(y, c.clamp_min(1).sum(dim=1, dtype=torch.int32))
    assert int(c.max()) > 1
    tp, hp = cuda_kernels.greedy_boundary_plain(a, b, table, nw, **skw)
    assert t.dtype == torch.int64 and has.dtype == torch.bool
    assert torch.equal(t, tp) and torch.equal(has, hp) and has.any()


# Launches whose dynamic shared memory stays under 48 KB but passes it with the
# kernel's static part (a TileScratch of 1,344 B; the sum body's 1,472 B):
# (entry, pattern, k, entries, L, lean).  The human sweep (CCCTAA,
# --telophrase 4 5 6) runs the first two at every k=5 and k=6 batch.
BAND = {
    "greedy-k5-lean": ("greedy_boundary", "CCCTAA", 5, 12, 19968, True),    # 48,768 B
    "greedy-k6-lean": ("greedy_boundary", "CCCTAA", 6, 12, 19968, True),    # 48,768 B
    "greedy-K11-dense": ("greedy_boundary", "CCCTAA", 5, 11, 19968, False),  # 48,780 B
    "sum-lean": ("sum_boundary", "CCCTAAA", 5, 14, 9088, True),             # 48,960 B
    "sum-dense": ("sum_boundary", "CCCTAAA", 5, 14, 8832, False),           # 48,784 B
}


def _band_plan(case):
    entry, _, k, K, L, lean = BAND[case]
    W = ops.num_windows(L, 100, 6)
    if entry == "greedy_boundary":
        return geometry.greedy_plan(L, W, K, k, 100 - k, 6, not lean, True)
    return geometry.sum_plan(L, W, k, 100 - k, 6, not lean, True)


def _band_launch(case):
    """One case of BAND on the card against its plain version; prints
    "band launch ok".  Run alone in a fresh process by the test below."""
    entry, pattern, k, K, L, lean = BAND[case]
    dev = torch.device("cuda", 0)
    w, slide, B = 100, 6, 128
    codes, lens = _batch(L + K, B, L, lean, "CCCTAA")
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers(pattern, k)[:K])).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    W = ops.num_windows(L, w, slide)
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = (0, 3, W)
    nw = torch.from_numpy(nw).to(dev)
    kw = dict(k=k, window_size=w, slide=slide, L=L, lean=lean)
    n0 = cuda_kernels.LAUNCHES[entry]
    t, has = getattr(cuda_kernels, entry)(a, b, table, nw, **kw)
    torch.cuda.synchronize()
    tp, hp = getattr(cuda_kernels, entry + "_plain")(a, b, table, nw, **kw)
    assert torch.equal(t, tp) and torch.equal(has, hp) and has.any()
    assert cuda_kernels.LAUNCHES[entry] == n0 + 1
    print("band launch ok")


@pytest.mark.parametrize("case", list(BAND))
def test_launch_under_48k_dynamic_over_it_with_static(dev, case):
    """A fused launch of the band opts in to more shared memory and matches
    its plain version.  Each case runs in a fresh process: CUDA keeps a
    kernel's opt-in for the rest of the process, so an earlier launch that
    opted the same kernel in to as many bytes would hide a missing opt-in
    (the band fails only where it is a kernel's first large launch)."""
    import subprocess
    import sys

    plan = _band_plan(case)
    assert plan.n_blocks == 1 and 48 * 1024 - 1344 < plan.smem_bytes <= 48 * 1024
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c",
                        f"from tests.test_torch_cuda import _band_launch; _band_launch({case!r})"],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and "band launch ok" in p.stdout, p.stderr[-3000:]


def test_greedy_counts_windows_past_the_read(dev):
    """greedy_counts' general form: windows may reach past L - k, where
    nothing matches, and one window may cover every offset."""
    kmers = telophrase_kmers("CCCTAAA", 7)
    codes, lens = _batch(3, 8, 1000, True)
    table = torch.from_numpy(pack_kmer_table(kmers)).to(dev)
    a, b = _wire(codes, lens, True, dev)
    for kw in (dict(J=93, W=200, slide=6), dict(J=994, W=1, slide=1), dict(J=1200, W=2, slide=50)):
        kw = dict(kw, k=7, L=1000, lean=True)
        assert torch.equal(cuda_kernels.greedy_counts(a, b, table, **kw),
                           cuda_kernels.greedy_counts_plain(a, b, table, **kw)), kw


# 33 entries: a second round of 32 for the step-1 kernel
_K33 = (telophrase_kmers("CCCTAAA", 5) + telophrase_kmers("CCCTAA", 5)
        + ["AAAAA", "CACAC", "ACACA", "TTTTT", "GGGGG", "ATATA", "CCCTA"])


@pytest.mark.parametrize("kmers", [telophrase_kmers("CCCTAAA", 7), telophrase_kmers("CCCTAAA", 5),
                                   ["AAAAAAA", "CCCTAAA"], _K33, _K40],
                         ids=["k7", "k5", "homopolymer", "K33", "K40"])
@pytest.mark.parametrize("L", [1000, 1024])     # rows not 16-byte aligned, and aligned
@pytest.mark.parametrize("lean", [True, False])
def test_greedy_step1_counts_match_plain(dev, kmers, L, lean):
    """Step 1's shape, [256, L] ends, through step1_counts: rows of 0 and
    3 bases, a run of A's, one launch, never the plain version's call."""
    k = len(kmers[0])
    codes, lens = _batch(7, 256, L, lean)
    codes[0, :300] = 0
    lens[:4] = (L, 0, 3, k)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    table = torch.from_numpy(pack_kmer_table(kmers)).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    n0 = cuda_kernels.LAUNCHES["step1_counts"], cuda_kernels.STEP1_PLAIN_CALLS["cuda"]
    c = cuda_kernels.step1_counts(a, b, table, k=k, L=L, lean=lean)
    torch.cuda.synchronize()
    assert (cuda_kernels.LAUNCHES["step1_counts"], cuda_kernels.STEP1_PLAIN_CALLS["cuda"]) == \
        (n0[0] + 1, n0[1])
    assert c.shape == (256, len(kmers)) and c.dtype == torch.int32
    assert torch.equal(c, cuda_kernels.step1_counts_plain(a, b, table, k=k, L=L, lean=lean))
    assert int(c.max()) > 10 and not c[1:3].any()


def test_greedy_wrapper_rejects_bad_inputs(dev):
    codes, lens = _batch(1, 4, 1024, True)
    a, b = _wire(codes, lens, True, dev)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 7))).to(dev)
    kw = dict(k=7, window_size=100, slide=6, L=1024, lean=True)
    with pytest.raises(ValueError, match="dtype"):
        cuda_kernels.greedy_signal(a, b.to(torch.int64), table, **kw)
    with pytest.raises(ValueError, match="cpu"):
        cuda_kernels.greedy_counts(a, b, table.cpu(), k=7, J=93, W=155, slide=6, L=1024,
                                   lean=True)
    with pytest.raises(ValueError, match="fewer"):
        cuda_kernels.greedy_signal(a, b, table, **dict(kw, L=2048))
    nw = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="does not match"):
        cuda_kernels.greedy_boundary(a, b, table, nw[:2], **kw)
    with pytest.raises(ValueError, match="dtype"):
        cuda_kernels.greedy_boundary(a, b, table, nw.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.step1_counts(a.t().contiguous().t(), b, table, k=7, L=1024, lean=True)
    with pytest.raises(ValueError, match="cpu"):
        cuda_kernels.step1_counts(a, b.cpu(), table, k=7, L=1024, lean=True)
    # a read whose wire and one match plane pass a block's shared memory is
    # served on the window-block grid, bit-identical to the plain version;
    # so are windows far past the read (they count 0)
    codes, lens = _batch(3, 1, 1_200_000, True)
    la, lb = _wire(codes, lens, True, dev)
    lkw = dict(kw, L=1_200_000)
    assert torch.equal(cuda_kernels.greedy_signal(la, lb, table, **lkw),
                       cuda_kernels.greedy_signal_plain(la, lb, table, **lkw))
    ckw = dict(k=7, J=93, W=400_000, slide=6, L=1024, lean=True)
    assert torch.equal(cuda_kernels.greedy_counts(a, b, table, **ckw),
                       cuda_kernels.greedy_counts_plain(a, b, table, **ckw))
    # what is still refused: the fused entry handed a read the picker would
    # not hand it (one block a read, or a cluster past 8 blocks: the
    # launcher's refusal, a fault of the caller), and a step-1 row that
    # passes a block
    n1 = torch.tensor([1_200_000], dtype=torch.int32, device=dev)
    n0 = dict(cuda_kernels.LAUNCHES)
    W1 = ops.num_windows(1_200_000, 100, 6)
    for cw in (W1, -(-W1 // 9)):
        with pytest.raises(RuntimeError, match="shared memory"):
            cuda_kernels.greedy_boundary(la, lb, table, n1, cluster_windows=cw, **lkw)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_kernels.step1_counts(la, lb, table, k=7, L=1_200_000, lean=True)
    assert cuda_kernels.LAUNCHES == n0          # a refused launch is not counted


def test_wrapper_rejects_bad_inputs(dev):
    codes, lens = _batch(1, 4, 1024, True)
    a, b = _wire(codes, lens, True, dev)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5))).to(dev)
    kw = dict(k=5, window_size=100, slide=6, L=1024, lean=True)
    with pytest.raises(ValueError, match="dtype"):
        cuda_kernels.sum_signal(a, b.to(torch.int64), table, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.sum_signal(a.t().contiguous().t(), b, table, **kw)
    with pytest.raises(ValueError, match="cpu"):
        cuda_kernels.sum_signal(a, b, table.cpu(), **kw)
    with pytest.raises(ValueError, match="fewer"):
        cuda_kernels.sum_signal(a, b, table, **dict(kw, L=2048))


def test_model_on_card_matches_cpu(dev):
    kmers = telophrase_kmers("CCCTAAA", 5)
    gpu = TorchScanModel(kmers, device=dev, window_size=100, slide=6)
    cpu = TorchScanModel(kmers, device="cpu", window_size=100, slide=6)
    for lean in (True, False):
        codes, lens = _batch(3, 37, 19968, lean)
        nw = batching.window_counts_for_lengths(lens, 100, 6)
        for x, y in zip(gpu.step2_boundary(codes, nw, lens), cpu.step2_boundary(codes, nw, lens)):
            np.testing.assert_array_equal(x, y)
        ends = codes[:, :2000].reshape(37, 2, 1000)
        np.testing.assert_array_equal(gpu.step1_counts(ends, np.full(37, 1000, np.int32)),
                                      cpu.step1_counts(ends, np.full(37, 1000, np.int32)))


def test_greedy_model_on_card_matches_cpu(dev):
    """A mixed table: step 1, step 2 and rawcounts on the greedy kernel."""
    kmers = telophrase_kmers("CCCTAA", 5)
    gpu = TorchScanModel(kmers, device=dev, window_size=100, slide=6)
    cpu = TorchScanModel(kmers, device="cpu", window_size=100, slide=6)
    assert gpu.kernel == "greedy"
    for lean in (True, False):
        codes, lens = _batch(4, 37, 19968, lean, "CCCTAA")
        nw = batching.window_counts_for_lengths(lens, 100, 6)
        for x, y in zip(gpu.step2_boundary(codes, nw, lens), cpu.step2_boundary(codes, nw, lens)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(gpu.rawcounts(codes, lens), cpu.rawcounts(codes, lens))
        ends = codes[:, :2000].reshape(37, 2, 1000)
        np.testing.assert_array_equal(gpu.step1_counts(ends, np.full(37, 1000, np.int32)),
                                      cpu.step1_counts(ends, np.full(37, 1000, np.int32)))


def test_engine_on_card_matches_cpu(dev, tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "r.fastq.gz"
    pat = np.resize(np.frombuffer(b"CCCTAAA", np.uint8), 4000)
    with gzip.open(path, "wb") as fh:
        for i in range(48):
            seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 12000)]
            if i % 2 == 0:                     # a telomeric start
                n = int(rng.integers(800, 4000))
                seq[:n] = pat[:n]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), b"I" * len(seq)))
    outs = {}
    for d in ("cuda", "cpu"):
        cfg = TopsicleConfig(input_dir=str(path), output_dir=str(tmp_path / d),
                             pattern="CCCTAAA", slide=6, batch_size=16)
        TorchEngine(cfg, device=d).run()
        outs[d] = (tmp_path / d / "telolengths_all.csv").read_bytes()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"].count(b"\n") > 10
    assert os.path.exists(tmp_path / "cuda" / "r.fastq_trc_over_0.7.fastq")


def test_engine_mixed_table_and_rawcounts_on_card_match_cpu(dev, tmp_path):
    """--telophrase 7 (a mixed table) with --rawcountpattern: the CSV and
    every rawcount CSV from the card equal the CPU's."""
    pytest.importorskip("pandas")
    rng = np.random.default_rng(6)
    path = tmp_path / "r.fastq.gz"
    pat = np.resize(np.frombuffer(b"CCCTAAA", np.uint8), 4000)
    with gzip.open(path, "wb") as fh:
        for i in range(24):
            seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 12000)]
            if i % 2 == 0:
                n = int(rng.integers(800, 4000))
                seq[:n] = pat[:n]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), b"I" * len(seq)))
    outs = {}
    for d in ("cuda", "cpu"):
        cfg = TopsicleConfig(input_dir=str(path), output_dir=str(tmp_path / d),
                             pattern="CCCTAAA", slide=6, batch_size=8, telophrase=[7],
                             rawcountpattern=True)
        TorchEngine(cfg, device=d).run()
        outs[d] = {p.name: p.read_bytes() for p in sorted((tmp_path / d).glob("*.csv"))}
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) > 3


def test_host_result_syncs_on_its_own_card(dev):
    """A handle of a result on cuda:1 made while cuda:0 is current waits
    on cuda:1's stream: the copy has landed when np.asarray returns."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    d1 = torch.device("cuda", 1)
    a = torch.randn(4096, 4096, device=d1)
    for _ in range(8):                   # queue work ahead of the result on cuda:1
        a = torch.tanh(a @ a)
    t = (a[:1024, :1024] > 0).to(torch.int32) + torch.arange(1024, device=d1,
                                                             dtype=torch.int32)
    with torch.cuda.device(0):
        h = HostResult(t)
    np.testing.assert_array_equal(np.asarray(h), t.cpu().numpy())


@pytest.mark.parametrize("phrase", [5, 7])
def test_two_shards_on_one_card_match_single(dev, phrase):
    """ShardedScanModel over [cuda:0, cuda:0]: the same (t, has), step-1
    counts and rawcounts as one model, and each shard launches."""
    kmers = telophrase_kmers("CCCTAAA", phrase)
    single = TorchScanModel(kmers, device=dev, window_size=100, slide=6)
    sharded = ShardedScanModel(single, [dev, dev])
    codes, lens = _batch(phrase, 64, 19968, False)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    name = "sum_boundary" if phrase == 5 else "greedy_boundary"
    n0 = cuda_kernels.LAUNCHES[name]
    got = sharded.step2_boundary(codes, nw, lens)
    assert cuda_kernels.LAUNCHES[name] == n0 + 2
    for x, y in zip(got, single.step2_boundary(codes, nw, lens)):
        np.testing.assert_array_equal(x, y)
    ends = codes[:, :2000].reshape(64, 2, 1000)
    n0 = cuda_kernels.LAUNCHES["step1_counts"]
    np.testing.assert_array_equal(sharded.step1_counts(ends), single.step1_counts(ends))
    assert cuda_kernels.LAUNCHES["step1_counts"] == n0 + 3      # two shards, one model
    packed = sharded.pack_scan_batch(codes, lens)
    np.testing.assert_array_equal(np.asarray(sharded.rawcounts_launch_packed(packed)),
                                  single.rawcounts(codes, lens))


# ---- the window-block grid and the picker ------------------------------------

def _ragged_windows(lens, w, slide, W):
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = np.minimum((0, 3, W), W)[:len(nw)]
    return nw


@pytest.mark.parametrize("k,w,slide,block_windows", [
    (5, 100, 6, 1000),      # does not divide W
    (5, 100, 7, 333),       # block starts at odd bases: no multiple of 4 or 8
    (7, 20, 1, 2048),       # slide 1 / window 20
    (5, 30, 1, 500),        # slide 1 on the aperiodic table, R = 0
    (7, 100, 6, 37),        # many small blocks, a halo longer than a block's stride
    (13, 100, 6, 512),      # no presence table (k > 7)
    (5, 100, 6, 100_000),   # more windows a block than the read has: one block a read
])
@pytest.mark.parametrize("lean", [True, False])
def test_grid_matches_plain(dev, k, w, slide, block_windows, lean):
    """sum_signal, greedy_signal and greedy_counts forced onto the
    window-block grid at a small L against their plain versions and
    against one block a read, bit for bit; binseg_l2 follows with ragged
    window counts (0, 3 and W among them)."""
    B, L = 6, 16384 + 4 * 5     # rows of 4,101 bytes: byte loads on the odd rows
    codes, lens = _batch(k + slide + block_windows, B, L, lean)
    lens[3] = 700                # a read that ends inside its first blocks
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    kmers = telophrase_kmers("CCCTAAACCCTAAA"[:max(7, k)], k)
    table = torch.from_numpy(pack_kmer_table(kmers)).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    Lw = a.shape[1] * 4
    W = ops.num_windows(Lw, w, slide)
    skw = dict(k=k, window_size=w, slide=slide, L=Lw, lean=lean)
    ckw = dict(k=k, J=w - k, W=W, slide=slide, L=Lw, lean=lean)
    nw = torch.from_numpy(_ragged_windows(lens, w, slide, W)).to(dev)
    for name, kw, plain in (("sum_signal", skw, cuda_kernels.sum_signal_plain),
                            ("greedy_signal", skw, cuda_kernels.greedy_signal_plain),
                            ("greedy_counts", ckw, cuda_kernels.greedy_counts_plain)):
        fn = getattr(cuda_kernels, name)
        n0 = cuda_kernels.LAUNCHES[name]
        got = fn(a, b, table, block_windows=block_windows, **kw)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES[name] == n0 + 1
        want = plain(a, b, table, **kw)
        assert torch.equal(got, want), name
        assert torch.equal(fn(a, b, table, block_windows=0, **kw), want), name
        if got.dim() == 2:
            t, has = cuda_kernels.binseg_l2(got, nw)
            tp, hp = ops.binseg_l2_device(want, nw)
            assert torch.equal(t, tp) and torch.equal(has, hp) and has.any()


@pytest.mark.parametrize("body,k,slide,w,lean", [
    ("sum", 5, 6, 100, True), ("sum", 5, 6, 100, False), ("greedy", 7, 6, 100, True),
    ("greedy", 7, 6, 100, False), ("sum", 7, 1, 20, True), ("greedy", 7, 1, 20, False)])
def test_long_read_takes_the_grid(dev, body, k, slide, w, lean):
    """L = 1,048,576 is past every whole-read layout: the wrappers take the
    window-block grid by themselves (no argument), bit-identical to the
    plain versions; the greedy body's counts too."""
    B, L = 2, 1_048_576
    codes, lens = _batch(k + slide, B, L, lean)
    lens[1] = L
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", k))).to(dev)
    a, b = _wire(codes, lens, lean, dev)
    W = ops.num_windows(L, w, slide)
    route = geometry.pick_route(body, L=L, W=W, K=int(table.shape[0]), k=k, window_size=w,
                                slide=slide, dense=not lean, fused=False)
    assert route.kind == "grid" and route.block_windows == geometry.BLOCK_WINDOWS
    skw = dict(k=k, window_size=w, slide=slide, L=L, lean=lean)
    signal = getattr(cuda_kernels, body + "_signal")
    y = signal(a, b, table, **skw)
    y_p = getattr(cuda_kernels, body + "_signal_plain")(a, b, table, **skw)
    assert torch.equal(y, y_p)
    nw = torch.from_numpy(_ragged_windows(lens, w, slide, W)).to(dev)
    t, has = cuda_kernels.binseg_l2(y, nw)
    tp, hp = ops.binseg_l2_device(y_p, nw)
    assert torch.equal(t, tp) and torch.equal(has, hp)
    del y_p
    if body == "greedy":
        ckw = dict(k=k, J=w - k, W=W, slide=slide, L=L, lean=lean)
        c = cuda_kernels.greedy_counts(a[:1], b[:1], table, **ckw)
        assert torch.equal(c, cuda_kernels.greedy_counts_plain(a[:1], b[:1], table, **ckw))
        assert torch.equal(c.clamp_min(1).sum(dim=1, dtype=torch.int32), y[:1])


def _sweep():
    """Geometries around every threshold of the layouts: scan lengths from
    the default to a megabase and more, slides 1 to 1,000, windows 20 to
    20,000, k 3 to 15, K 1 to 120, both wires."""
    rng = np.random.default_rng(6)
    fixed = [(L, slide, w, k, K)
             for L in (512, 19968, 49664, 59904, 215040, 229888, 460288, 1048576, 4194304)
             for slide, w, k, K in ((6, 100, 5, 14), (1, 100, 5, 14), (1, 20, 7, 14),
                                    (6, 100, 7, 31), (7, 100, 13, 31), (6, 100, 7, 120),
                                    (1000, 2000, 5, 14), (3, 20000, 15, 2))]
    drawn = [(int(rng.integers(1, 2 ** rng.integers(9, 23))), int(rng.integers(1, 40)),
              int(rng.integers(16, 400)), int(rng.integers(3, 16)), int(rng.integers(1, 60)))
             for _ in range(400)]
    return [g for g in fixed + drawn if g[3] < g[2]]


def test_picker_agrees_with_launchers(dev):
    """ops.geometry is the launchers' mirror: over a sweep of geometries
    its plans equal what the built library's launchers would do (shared
    memory, windows a block, tiles, groups, clusters of 2 to 9 blocks), it
    never picks a launch that a launcher refuses, and never leaves one
    fused block, the fewest blocks of a fused cluster (where one block a
    read fits), or one block a read, while the launcher would have taken
    it."""
    n = {"fused": 0, "cluster": 0, "read": 0, "grid": 0}
    for L, slide, w, k, K in _sweep():
        W = ops.num_windows(L, w, slide)
        if W == 0:
            continue
        for entry in ("sum", "greedy", "counts"):
            if entry == "sum" and K > cuda_kernels.MAX_ENTRIES:
                continue
            body = "sum" if entry == "sum" else "greedy"
            for dense in (False, True):
                g = dict(L=L, W=W, K=K, k=k, J=w - k, slide=slide, dense=dense)
                where = f"{entry} {g}"
                cluster_wb = [-(-W // C) for C in range(2, geometry.MAX_CLUSTER + 2)]
                for boundary in (True, False):
                    for wb in (0, geometry.BLOCK_WINDOWS, 64, 1, *cluster_wb):
                        mine = geometry._plan(body, L, W, K, k, w - k, slide, dense, boundary, wb)
                        theirs = cuda_kernels.launcher_plan(body, boundary=boundary,
                                                            block_windows=wb, **g)
                        assert mine == theirs, f"{where} boundary={boundary} wb={wb}"
                route = geometry.pick_route(entry, L=L, W=W, K=K, k=k, window_size=w,
                                            slide=slide, dense=dense)
                n[route.kind] += 1
                one_fits = entry != "counts" and \
                    cuda_kernels.launcher_plan(body, boundary=True, **g) is not None
                # the fewest blocks a read on which the launcher takes the fused entry
                clusters = [] if entry == "counts" else [
                    C for C, wb in zip(range(2, geometry.MAX_CLUSTER + 1), cluster_wb)
                    if wb < W and cuda_kernels.launcher_plan(body, boundary=True,
                                                             block_windows=wb, **g)]
                read_fits = cuda_kernels.launcher_plan(body, boundary=False, **g) is not None
                assert (route.kind == "fused") == one_fits, where
                assert (route.kind == "cluster") == \
                    (not one_fits and read_fits and bool(clusters)), where
                if route.kind == "cluster":
                    assert route.block_windows == -(-W // clusters[0]), where
                assert (route.kind == "read") == (read_fits and not route.fused), where
                if route.kind == "grid":
                    taken = cuda_kernels.launcher_plan(body, boundary=False,
                                                       block_windows=route.block_windows, **g)
                    assert taken is not None and taken.n_blocks > 1, where
    assert min(n.values()) > 20, n


@pytest.mark.parametrize("phrase,kernel,slide,L,launched", [
    (5, None, 1, 59904, ["sum_boundary"]),       # y [W] alone passes a block: a cluster of 2
    (7, None, 1, 59904, ["greedy_boundary"]),
    (5, None, 6, 59904, ["sum_boundary"]),                   # slide 6: one block
    (5, "sum", 6, 999936, ["sum_signal", "binseg_l2"]),      # the grid
    (7, "greedy", 1, 59904, ["greedy_signal", "binseg_l2"]),  # by name: one block a read
    (7, None, 6, 999936, ["greedy_signal", "binseg_l2"])])   # the grid, not a cluster
def test_model_routes_long_scans_on_card(dev, phrase, kernel, slide, L, launched):
    """The model asks the picker before it launches: a scan past one fused
    block runs the fused entry on a cluster of its blocks where one block a
    read would fit, else its signal kernel and binseg_l2, names the route
    once in its log, and gives the CPU model's (t, has) and rawcounts."""
    kmers = telophrase_kmers("CCCTAAA", phrase)
    lines = []
    model = TorchScanModel(kmers, device=dev, window_size=100, slide=slide, kernel=kernel,
                           log=lines.append)
    cpu = TorchScanModel(kmers, device="cpu", window_size=100, slide=slide, kernel=kernel)
    codes, lens = _batch(phrase + slide, 3, L, True)
    nw = batching.window_counts_for_lengths(lens, 100, slide)
    cuda_kernels.reset_launch_counts()
    for _ in range(2):
        t, has = model.step2_boundary(codes, nw, lens)
    assert {n: c for n, c in cuda_kernels.LAUNCHES.items() if c} == dict.fromkeys(launched, 2)
    tc, hc = cpu.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, tc) and np.array_equal(has, hc) and has.any()
    W = ops.num_windows(L, 100, slide)
    route = model.route(model.kernel, L, True, fused=model.fused)[1]
    logged = route.kind != "fused" and (model.fused or route.kind == "grid")
    assert len(lines) == int(logged), lines
    if lines:
        assert f"INFO: scan length {L}" in lines[0] and launched[0] in lines[0]
        assert ("window-block grid" in lines[0]) == (route.kind == "grid")
        assert (f"on a cluster of {route.blocks(W)} blocks a read" in lines[0]) == \
            (route.kind == "cluster")
    if slide == 6:
        raw = model.rawcounts(codes[:1], lens[:1])
        assert np.array_equal(raw, cpu.rawcounts(codes[:1], lens[:1])) and raw.max() > 1


def test_window_past_the_sum_body_on_card(dev):
    """A window of 12,000 bases at slide 1: the sum body cannot hold one
    window's groups, so the model takes the greedy body, fused; (t, has)
    equal the CPU model's (the plain sum signal)."""
    kmers = telophrase_kmers("CCCTAAA", 5)
    lines = []
    model = TorchScanModel(kmers, device=dev, window_size=12000, slide=1, log=lines.append)
    cpu = TorchScanModel(kmers, device="cpu", window_size=12000, slide=1)
    assert model.kernel == "sum"
    codes, lens = _batch(12, 4, 19968, True)
    lens[0] = 19968
    nw = batching.window_counts_for_lengths(lens, 12000, 1)
    cuda_kernels.reset_launch_counts()
    t, has = model.step2_boundary(codes, nw, lens)
    assert {n: c for n, c in cuda_kernels.LAUNCHES.items() if c} == {"greedy_boundary": 1}
    tc, hc = cpu.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, tc) and np.array_equal(has, hc) and has[0]
    assert len(lines) == 1 and "past the sum kernel's shared memory: greedy_boundary" in lines[0]


@pytest.mark.parametrize("body", ["sum", "greedy"])
def test_failed_fused_launch_clears_the_last_error(dev, body):
    """A fused launch that fails (a grid of no reads: an invalid
    configuration) returns its error and leaves CUDA's last error clear,
    so the next launch in the process succeeds and reports nothing of it."""
    k, w, slide, B = 5, 100, 6, 16
    codes, lens = _batch(31, B, 4096, True)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", k))).to(dev)
    a, b = _wire(codes, lens, True, dev)
    L = a.shape[1] * 4
    W = ops.num_windows(L, w, slide)
    nw = torch.from_numpy(batching.window_counts_for_lengths(lens, w, slide)).to(dev)
    t = torch.empty(B, dtype=torch.int64, device=dev)
    has = torch.empty(B, dtype=torch.uint8, device=dev)
    args = cuda_kernels._wire_args(a, b, table, k=k, slide=slide, J=w - k, W=W, L=L,
                                   lean=True)
    args[-1] = 0                                      # B = 0: a grid of no block
    rc = getattr(cuda_kernels.load_library(), f"topsicle_{body}_boundary")(
        *args, 0, nw.data_ptr(), 5, 2, t.data_ptr(), has.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    assert rc not in (0, -2)
    fused = cuda_kernels.sum_boundary if body == "sum" else cuda_kernels.greedy_boundary
    plain = cuda_kernels.sum_boundary_plain if body == "sum" \
        else cuda_kernels.greedy_boundary_plain
    kw = dict(k=k, window_size=w, slide=slide, L=L, lean=True)
    got = fused(a, b, table, nw, **kw)
    torch.cuda.synchronize()
    want = plain(a, b, table, nw, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
