"""The greedy counts of the port (topsicle_tpu_torch.ops.match and the
greedy kernel's wrappers in ops.cuda_kernels) vs the JAX package: step 1's
greedy_count_chunked / greedy_count_full and the oracle's re.finditer
count, window_nonoverlap_counts in every exact strategy, the Pallas
greedy kernel it replaces (step2_signal_pallas(_lean), run in interpret
mode on its phase-planar wire, as tests/test_pallas.py runs it), and, for
the fused entry greedy_boundary, the JAX boundary programs
_step2_boundary(_lean) and that Pallas kernel followed by
binseg_l2_device.

On the CPU the wrappers take the plain versions; the CUDA kernel itself is
compiled and compared only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsicle_tpu import ops as jops
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import aperiodic_mask, encode_ascii, pack_kmer_table, telophrase_kmers
from topsicle_tpu.models.telomere import _step2_boundary, _step2_boundary_lean
from topsicle_tpu.ops.pallas_kernels import step2_signal_pallas, step2_signal_pallas_lean
from topsicle_tpu.oracle import count_nonoverlapping
from topsicle_tpu_torch import ops as tops
from topsicle_tpu_torch.ops import cuda_kernels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(pattern, seed, B, L, lean):
    """[B, L] tails: a noisy repeat of `pattern` over a random prefix,
    random bases after it, ragged suffix padding; dense batches also
    carry ~3% invalid bases inside the reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rep = np.resize(np.array(["ACGT".index(c) for c in pattern], np.uint8), L)
    telo = rng.integers(L // 8, L, B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) > 0.05)
    codes = np.where(keep, rep[None, :], codes).astype(np.uint8)
    if not lean:
        codes[rng.random((B, L)) < 0.03] = 4
    lens = rng.integers(L // 4, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


def _wire(codes, lens, lean):
    a, b = (batching.pack_codes(codes), lens) if lean else batching.pack_batch(codes)
    return torch.from_numpy(a), torch.from_numpy(b)


def _pallas(codes, lens, table, k, w, slide, lean):
    L = codes.shape[1]
    kw = dict(k=k, K=len(table), window_size=w, slide=slide, L=L, interpret=True)
    if lean:
        p = batching.pack_tails_phase_planar_lean(codes, k, w, slide)
        return np.asarray(step2_signal_pallas_lean(
            jnp.asarray(p), jnp.asarray(lens.reshape(-1, 1)), jnp.asarray(table), **kw))
    p, m = batching.pack_tails_phase_planar(codes, k, w, slide)
    return np.asarray(step2_signal_pallas(jnp.asarray(p), jnp.asarray(m),
                                          jnp.asarray(table), **kw))


def _jax_counts(codes, table, k, w, slide, strategy):
    c = jnp.asarray(np.minimum(codes, 4))
    match = jops.match_positions(c, jnp.asarray(table), k)
    W = (codes.shape[1] - w) // slide + 1
    return np.asarray(jops.window_nonoverlap_counts(match, k, w, slide, W, strategy=strategy))


# ---- step 1: greedy count over the whole end --------------------------------

@pytest.mark.parametrize("pattern,k", [("CCCTAAA", 3), ("CCCTAAA", 6), ("CCCTAAA", 7),
                                       ("CCCTAA", 5)])
def test_greedy_count_matches_jax_and_oracle(pattern, k):
    """Periodic and mixed tables with N's: the port's greedy count (and
    the greedy_counts wrapper with one window over every offset) ==
    JAX greedy_count_chunked == greedy_count_full == re.finditer."""
    kmers = telophrase_kmers(pattern, k)
    assert not all(aperiodic_mask(kmers))
    table = pack_kmer_table(kmers)
    rng = np.random.default_rng(k)
    rep = np.frombuffer(pattern.encode(), np.uint8)
    seqs = []
    for _ in range(6):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1000)
        n = int(rng.integers(100, 900))
        s[:n] = np.resize(rep, n)
        s[rng.random(1000) < 0.05] = ord("N")
        seqs.append(s.tobytes())
    codes = np.stack([encode_ascii(s) for s in seqs])
    m_t = tops.match_positions(torch.from_numpy(codes), torch.from_numpy(table), k)
    got = tops.greedy_count(m_t, k).numpy()
    assert got.dtype == np.int32 and got.shape == (6, len(kmers))
    m_j = jops.match_positions(jnp.asarray(codes), jnp.asarray(table), k)
    np.testing.assert_array_equal(got, np.asarray(jops.greedy_count_chunked(m_j, k)))
    np.testing.assert_array_equal(got, np.asarray(jops.greedy_count_full(m_j, k)))
    for i, s in enumerate(seqs):
        for j, km in enumerate(kmers):
            assert got[i, j] == count_nonoverlapping(s.decode(), km)
    a, b = _wire(codes, None, False)
    wrapped = cuda_kernels.greedy_counts(a, b, torch.from_numpy(table), k=k, J=1000 - k + 1,
                                         W=1, slide=1, L=1000, lean=False)
    np.testing.assert_array_equal(wrapped[..., 0].numpy(), got)


# ---- step 2: per-window counts ---------------------------------------------

@pytest.mark.parametrize("k,w,slide", [
    (4, 64, 3),     # small window, slide < k
    (5, 100, 1),    # slide 1
    (6, 80, 7),     # slide > k
    (7, 120, 7),    # k = 7
    (7, 20, 1),     # slide 1, window 20, k 7
])
def test_window_counts_match_jax_strategies(k, w, slide):
    """tests/test_pallas.py's geometry sweep on a table of random k-mers
    plus the periodic CCCTAAA entries on a dirty batch: window_counts (and
    greedy_counts' plain version on the dense wire) == JAX offset, phase
    and bitmask."""
    rng = np.random.default_rng(k * 100 + slide)
    kmers = {"".join(rng.choice(list("ACGT"), k)) for _ in range(6)}
    kmers = sorted(kmers) + telophrase_kmers("CCCTAAA", k)
    table = pack_kmer_table(kmers)
    codes, lens = _batch("CCCTAAA", k + w, 4, 1536, lean=False)
    W = (1536 - w) // slide + 1
    m_t = tops.match_positions(torch.from_numpy(np.minimum(codes, 4)),
                               torch.from_numpy(table), k)
    got = tops.window_counts(m_t, k, w - k, W, slide).numpy()
    assert got.shape == (4, len(kmers), W) and got.max() > 1
    for strategy in ("offset", "phase", "bitmask"):
        np.testing.assert_array_equal(got, _jax_counts(codes, table, k, w, slide, strategy))
    a, b = _wire(codes, lens, False)
    kw = dict(k=k, J=w - k, W=W, slide=slide, L=1536, lean=False)
    np.testing.assert_array_equal(
        cuda_kernels.greedy_counts_plain(a, b, torch.from_numpy(table), **kw).numpy(), got)


def test_window_counts_any_K_duplicates_and_invalid_entries():
    """K = 53 with duplicate periodic entries and a -1 entry (a non-ACGT
    k-mer, which never matches): each duplicate counts on its own, and
    overlapping ATAT occurrences are taken greedily, fewer than occur."""
    kmers = telophrase_kmers("ATAT", 4) + telophrase_kmers("CCCTAAA", 4) * 2
    kmers += ["ACGT", "TTTT", "GGGG", "CACA", "ACAC"] * 4
    table = np.concatenate([pack_kmer_table(kmers), [-1]]).astype(np.int32)
    assert len(table) == 53
    codes, lens = _batch("ATATCCCTAAATTTT", 3, 4, 1024, lean=True)
    want = _jax_counts(codes, table, 4, 40, 3, "offset")
    a, b = _wire(codes, lens, True)
    got = cuda_kernels.greedy_counts(a, b, torch.from_numpy(table), k=4, J=36,
                                     W=(1024 - 40) // 3 + 1, slide=3, L=1024, lean=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), got[:, 3].numpy())   # ATAT twice
    assert (got[:, -1] == 0).all() and got.max() > 1
    assert (got.numpy() < _jax_counts(codes, table, 4, 40, 3, "sum")).any()


def test_window_signal():
    c = torch.tensor([[[0, 2, 1], [3, 0, 0]]], dtype=torch.int32)
    assert tops.window_signal(c).tolist() == [[4, 3, 2]]


# ---- the greedy kernel's plain version vs the Pallas kernel -----------------

@pytest.mark.parametrize("pattern,k,seed,L,lean", [
    ("CCCTAAA", 7, 0, 2048, True),
    ("CCCTAAA", 7, 1, 4096, False),
    ("CCCTAA", 5, 2, 2048, False),
    ("CCCTAA", 5, 3, 4096, True),
])
def test_greedy_signal_matches_pallas(pattern, k, seed, L, lean):
    """Mixed tables at the demo geometry (window 100, slide 6), ragged
    lengths: greedy_signal on the plain wire == the floored sum of
    greedy_counts == the Pallas greedy kernel on its phase-planar wire."""
    kmers = telophrase_kmers(pattern, k)
    table = pack_kmer_table(kmers)
    codes, lens = _batch(pattern, seed, 8, L, lean)
    a, b = _wire(codes, lens, lean)
    tab = torch.from_numpy(table)
    got = cuda_kernels.greedy_signal(a, b, tab, k=k, window_size=100, slide=6, L=L, lean=lean)
    W = (L - 100) // 6 + 1
    assert got.dtype == torch.int32 and got.shape == (8, W)
    np.testing.assert_array_equal(got.numpy(), _pallas(codes, lens, table, k, 100, 6, lean))
    counts = cuda_kernels.greedy_counts(a, b, tab, k=k, J=100 - k, W=W, slide=6, L=L,
                                        lean=lean)
    assert torch.equal(got, tops.window_signal(counts))
    assert (got > len(kmers)).any()


@pytest.mark.parametrize("k,w,slide", [(4, 64, 3), (5, 100, 1), (6, 80, 7), (7, 120, 7)])
def test_greedy_signal_geometry_sweep_matches_pallas(k, w, slide):
    """The geometry sweep on the mixed CCCTAAA tables and dirty batches."""
    table = pack_kmer_table(telophrase_kmers("CCCTAAA", k))
    codes, lens = _batch("CCCTAAA", k * 10 + slide, 8, 1536, lean=False)
    a, b = _wire(codes, lens, False)
    got = cuda_kernels.greedy_signal(a, b, torch.from_numpy(table), k=k, window_size=w,
                                     slide=slide, L=1536, lean=False)
    np.testing.assert_array_equal(got.numpy(), _pallas(codes, lens, table, k, w, slide, False))


@pytest.mark.parametrize("lean", [True, False])
def test_greedy_signal_equals_sum_signal_on_aperiodic_table(lean):
    """On the aperiodic k=5 table both kernels' plain versions agree."""
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5)))
    codes, lens = _batch("CCCTAAA", 5, 6, 2048, lean)
    a, b = _wire(codes, lens, lean)
    kw = dict(k=5, window_size=100, slide=6, L=2048, lean=lean)
    assert torch.equal(cuda_kernels.greedy_signal(a, b, table, **kw),
                       cuda_kernels.sum_signal(a, b, table, **kw))


def test_greedy_empty_geometry_and_envelope():
    """No offsets per window: every count is 0 and the signal is K per
    window, as the Pallas launcher returns.  k > 15 raises."""
    wire = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    tab = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5)))
    y = cuda_kernels.greedy_signal(wire, lens, tab, k=5, window_size=5, slide=6, L=256,
                                   lean=True)
    assert y.shape == (2, 42) and (y == 14).all()
    c = cuda_kernels.greedy_counts(wire, lens, tab, k=5, J=0, W=3, slide=6, L=256, lean=True)
    assert c.shape == (2, 14, 3) and not c.any()
    for fn, kw in ((cuda_kernels.greedy_signal, dict(window_size=100)),
                   (cuda_kernels.greedy_counts, dict(J=84, W=3))):
        with pytest.raises(ValueError, match="15"):
            fn(wire, lens, tab, k=16, slide=6, L=256, lean=True, **kw)


# ---- greedy_boundary: the signal with the changepoint behind it --------------

@pytest.mark.parametrize("pattern,k,w,slide,L,lean", [
    ("CCCTAAA", 7, 100, 6, 2048, True),     # 8 of 14 entries periodic
    ("CCCTAAA", 7, 100, 6, 2560, False),
    ("CCCTAA", 5, 100, 6, 2048, False),     # human: 2 of 12
    ("ATAT", 4, 64, 3, 1536, True),         # periodic, each entry twice
    ("CCCTAAA", 7, 20, 1, 1003, True),      # slide 1, window 20
    ("CCCTAAA", 5, 100, 6, 104, True),      # W = 1 < jump: no candidate
])
def test_greedy_boundary_matches_jax(pattern, k, w, slide, L, lean):
    """Same wire, same table, ragged window counts (0, 3 and W among
    them): greedy_boundary == its plain version == the JAX boundary
    program with the exact offset scan == the Pallas greedy kernel
    (interpret mode) followed by binseg_l2_device."""
    table = pack_kmer_table(telophrase_kmers(pattern, k))
    codes, lens = _batch(pattern, k + L, 8, L, lean)     # the Pallas kernel takes 8 rows
    a, b = (batching.pack_codes(codes), lens) if lean else batching.pack_batch(codes)
    Lw = a.shape[1] * 4
    W = tops.num_windows(Lw, w, slide)
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = np.minimum((0, 3, W), W)
    kw = dict(k=k, window_size=w, slide=slide)
    args = [torch.from_numpy(x) for x in (a, b, table, nw)]
    n0 = dict(cuda_kernels.LAUNCHES)
    t, has = cuda_kernels.greedy_boundary(*args, L=Lw, lean=lean, **kw)
    assert cuda_kernels.LAUNCHES == n0          # the CPU launches no kernel
    assert t.dtype == torch.int64 and has.dtype == torch.bool and t.shape == (8,)
    tp, hp = cuda_kernels.greedy_boundary_plain(*args, L=Lw, lean=lean, **kw)
    assert torch.equal(t, tp) and torch.equal(has, hp)
    jax_fn = _step2_boundary_lean if lean else _step2_boundary
    tj, hj = jax_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(nw), jnp.asarray(table),
                    jump=5, min_size=2, strategy="offset", **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(has.numpy(), np.asarray(hj))
    if Lw == L and W >= 5:      # the phase-planar wire packs whole codes rows
        y = _pallas(codes, lens, table, k, w, slide, lean)
        tk, hk = jops.binseg_l2_device(jnp.asarray(y), jnp.asarray(nw), jump=5, min_size=2)
        np.testing.assert_array_equal(t.numpy(), np.asarray(tk))
        np.testing.assert_array_equal(has.numpy(), np.asarray(hk))
    assert not has[:2].any() and (W < 10 or has[2:].any())


@pytest.mark.parametrize("case", ["n_windows", "jump", "min_size", "k", "device"])
def test_greedy_boundary_refusals(case):
    """What the wrapper refuses before any launch, whatever the device.
    (What only the kernel's launcher can refuse, a read whose wire, y and
    one match plane pass a block's shared memory, is a card-only case of
    tests/test_torch_cuda.py.)"""
    wire = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    tab = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 7)))
    nw = torch.full((2,), 27, dtype=torch.int32)
    kw = dict(k=7, window_size=100, slide=6, L=256, lean=True)
    bad, match = {
        "n_windows": (lambda: cuda_kernels.greedy_boundary(wire, lens, tab, nw[:1], **kw),
                      "does not match"),
        "jump": (lambda: cuda_kernels.greedy_boundary(wire, lens, tab, nw, jump=0, **kw),
                 "jump >= 1"),
        "min_size": (lambda: cuda_kernels.greedy_boundary(wire, lens, tab, nw, min_size=0,
                                                          **kw), "min_size >= 1"),
        "k": (lambda: cuda_kernels.greedy_boundary(wire, lens, tab, nw, **dict(kw, k=16)),
              "15"),
        "device": (lambda: cuda_kernels.greedy_boundary(
            wire.to("meta"), lens.to("meta"), tab.to("meta"), nw.to("meta"), **kw),
            "cuda or cpu"),
    }[case]
    with pytest.raises(ValueError, match=match):
        bad()
    t, has = cuda_kernels.greedy_boundary(wire, lens, tab, nw, **kw)
    assert t.shape == (2,) and has.shape == (2,)


def test_greedy_boundary_empty_geometry():
    """No offsets per window: the signal is K everywhere, every candidate
    ties and the smallest t wins, as after greedy_signal."""
    wire = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    tab = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5)))
    nw = torch.tensor([42, 3], dtype=torch.int32)
    kw = dict(k=5, window_size=5, slide=6, L=256, lean=True)
    t, has = cuda_kernels.greedy_boundary(wire, lens, tab, nw, **kw)
    want = tops.binseg_l2(cuda_kernels.greedy_signal(wire, lens, tab, **kw), nw)
    assert torch.equal(t, want[0]) and torch.equal(has, want[1])
    assert t.tolist() == [5, 5] and has.tolist() == [True, False]
