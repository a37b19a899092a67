"""TorchScanModel vs TelomereScanModel, both built from one state
(models.state.state_from_jax): step-1 counts and step-2 (t, has) on the
lean and dense wires, batches not a multiple of 8, engine-style padding,
and the tables the port refuses.  Integer outputs: exact equality."""

import itertools

import numpy as np
import pytest
import torch

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu_torch.models import TorchScanModel, state_from_jax
from topsicle_tpu_torch.models.telomere import HostResult, _batch_is_clean


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jm = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6)
    return jm, TorchScanModel(**state_from_jax(jm), device="cpu")


def _reads(seed, B, L, n_frac=0.0):
    """Telomere-like [B, L] codes: a noisy CCCTAAA repeat, then random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    pat = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), L)
    telo = rng.integers(50, L, B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) > 0.05)
    codes = np.where(keep, pat[None, :], codes).astype(np.uint8)
    if n_frac:
        codes[rng.random((B, L)) < n_frac] = 4
    return codes


def test_state_from_jax(models):
    jm, tm = models
    st = state_from_jax(jm)
    assert set(st) == {"kmers", "table", "k", "window_size", "slide", "jump", "min_size",
                       "kernel"}
    assert st["kernel"] is None and tm.kernel == "sum"
    assert st["table"].dtype == np.int32
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    assert (tm.k, tm.K, tm.window_size, tm.slide, tm.jump, tm.min_size) == \
        (jm.k, jm.K, jm.window_size, jm.slide, jm.jump, jm.min_size)
    assert tm.kmers == jm.kmers and tm.device == torch.device("cpu")
    assert tm.num_windows(5000) == jm.num_windows(5000) and tm.num_windows(99) == 0


@pytest.mark.parametrize("B,lean,n_frac", [(5, True, 0.0), (7, False, 0.0),
                                           (13, False, 0.02)])
def test_step1_counts_match_jax(models, B, lean, n_frac):
    """[B, 2, 1000] ends -> [B, 2, K]; short reads (ends_len < 1000) and
    engine pad rows (0xFF, length 0) included."""
    jm, tm = models
    ends = _reads(B, B * 2, 1000, n_frac).reshape(B, 2, 1000)
    ends_len = np.full(B, 1000, np.int32)
    ends_len[1] = 300
    ends[1, :, 300:] = 0xFF
    ends[-1] = 0xFF                        # a pad row, as _step1_stream makes
    ends_len[-1] = 0
    lens = ends_len if lean else None
    got = tm.step1_counts(ends, lens)
    assert got.dtype == np.int32 and got.shape == (B, 2, tm.K)
    np.testing.assert_array_equal(got, jm.step1_counts(ends, lens))
    assert (got[-1] == 0).all() and got.sum() > 0


@pytest.mark.parametrize("B,L,lean", [(5, 2048, True), (6, 2560, False),
                                      (9, 2048, True)])
def test_step2_boundary_matches_jax(models, B, L, lean):
    """Ragged lengths, N bases on the dense wire, and pad rows (lens 0,
    n_windows 0) whose has must be False."""
    jm, tm = models
    codes = _reads(B + L, B, L, 0.0 if lean else 0.01)
    lens = np.random.default_rng(B).integers(150, L + 1, B).astype(np.int32)
    lens[-1] = 0                           # a pad row, as _step2_batches makes
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    assert tm.pack_scan_batch(codes, lens)[0] == ("lean" if lean else "dense")
    t, has = tm.step2_boundary(codes, nw, lens)
    tj, hj = jm.step2_boundary(codes, nw, lens)
    assert t.dtype == np.int64 and has.dtype == np.bool_
    np.testing.assert_array_equal(t, np.asarray(tj))
    np.testing.assert_array_equal(has, np.asarray(hj))
    assert not has[-1] and has[:-1].any()


def test_step2_lean_and_dense_agree(models):
    """A clean batch gives the same (t, has) whether it ships lean
    (lengths given) or dense (no lengths)."""
    _, tm = models
    codes = _reads(3, 6, 2048)
    lens = np.full(6, 2048, np.int32)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t1, h1 = tm.step2_boundary(codes, nw, lens)
    t2, h2 = tm.step2_boundary(codes, nw, None)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(h1, h2)


def test_batch_is_clean():
    clean = np.full((2, 40), 0xFF, np.uint8)
    clean[0, :30] = 1
    clean[1, :20] = 2
    assert _batch_is_clean(clean, np.array([30, 20]))
    clean[1, 5] = 4
    assert not _batch_is_clean(clean, np.array([30, 20]))


def test_host_result():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    h = HostResult(t)
    a = np.asarray(h)
    assert a.dtype == np.int32 and a.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert np.asarray(h, dtype=np.int64).dtype == np.int64
    assert np.array(h, copy=True) is not a


@pytest.mark.parametrize("kmers,match", [
    (telophrase_kmers("CCCTAAACC", 16), "k>15"),
])
def test_refused_tables(kmers, match):
    """A device model refuses k past the rolling-code capacity; the
    engine computes such phrases on the host (models.oracle_model)."""
    with pytest.raises(ValueError, match=match) as e:
        TorchScanModel(kmers, device="cpu", window_size=100, slide=6)
    assert "oracle_model" in str(e.value)


def _reads_of(pattern, seed, B, L, n_frac=0.0):
    """[B, L] codes: a noisy repeat of `pattern` over a random prefix of
    each read, random bases after it, N's at `n_frac`."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    pat = np.resize(np.array(["ACGT".index(c) for c in pattern], np.uint8), L)
    telo = rng.integers(L // 8, L, B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) > 0.05)
    codes = np.where(keep, pat[None, :], codes).astype(np.uint8)
    if n_frac:
        codes[rng.random((B, L)) < n_frac] = 4
    return codes


# 32 aperiodic 5-mers (a first base seen only once cannot recur) and two
# periodic ones: K = 34 is past the sum kernel's 31-bit presence word
_K34 = ["G" + "".join(p) for p in itertools.product("ACT", repeat=4)][:32] + \
    ["AAAAA", "CACAC"]


@pytest.mark.parametrize("pattern,kmers", [
    ("CCCTAA", telophrase_kmers("CCCTAA", 5)),      # mixed: 2 of 12 periodic
    ("CCCTAAA", telophrase_kmers("CCCTAAA", 7)),    # mixed: 8 of 14 periodic
    ("ATAT", telophrase_kmers("ATAT", 4)),          # periodic, each entry twice
    ("CACAC", _K34),                                # K = 34
])
@pytest.mark.parametrize("lean", [True, False])
def test_greedy_tables_match_jax(pattern, kmers, lean):
    """Tables the sum kernel cannot serve take the greedy kernel: step-1
    counts, step-2 (t, has) and rawcounts equal the JAX model's (its
    split/phase/chunked strategies), on both wires."""
    jm = TelomereScanModel(kmers, window_size=100, slide=6)
    tm = TorchScanModel(**state_from_jax(jm), device="cpu")
    assert tm.kernel == "greedy" and not tm.aperiodic
    B, L = 6, 2048
    codes = _reads_of(pattern, len(kmers) + lean, B, L, 0.0 if lean else 0.02)
    lens = np.random.default_rng(B).integers(300, L + 1, B).astype(np.int32)
    lens[-1] = 0                           # a pad row, as _step2_batches makes
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    assert tm.pack_scan_batch(codes, lens)[0] == ("lean" if lean else "dense")

    ends = _reads_of(pattern, B, B * 2, 1000, 0.0 if lean else 0.02).reshape(B, 2, 1000)
    ends_len = np.full(B, 1000, np.int32)
    ends_len[1] = 300                      # a short read
    ends[1, :, 300:] = 0xFF
    ends_len[-1] = 0                       # a pad row, as _step1_stream makes
    ends[-1] = 0xFF
    got = tm.step1_counts(ends, ends_len if lean else None)
    np.testing.assert_array_equal(got, jm.step1_counts(ends, ends_len if lean else None))
    assert got.sum() > 0 and (got[-1] == 0).all()

    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = tm.step2_boundary(codes, nw, lens)
    tj, hj = jm.step2_boundary(codes, nw, lens)
    np.testing.assert_array_equal(t, np.asarray(tj))
    np.testing.assert_array_equal(has, np.asarray(hj))
    assert not has[-1]

    raw = tm.rawcounts(codes, lens)
    assert raw.dtype == np.int32 and raw.shape == (B, len(kmers), tm.num_windows(L))
    np.testing.assert_array_equal(raw, jm.rawcounts(codes, lens))
    assert raw.max() > 1


def test_rawcounts_aperiodic_match_jax(models):
    """The aperiodic demo table's rawcounts also come from the greedy
    kernel (no floor), equal to the JAX sum strategy's, on both wires."""
    jm, tm = models
    codes = _reads(21, 5, 2048)
    lens = np.full(5, 2048, np.int32)
    for ln in (lens, None):
        np.testing.assert_array_equal(tm.rawcounts(codes, ln), jm.rawcounts(codes, ln))


def test_kernel_greedy_on_aperiodic_table(models):
    """kernel='greedy' on the aperiodic k=5 table: (t, has) equal to the
    sum path's and to the JAX model's greedy Pallas kernel (interpret
    mode), carried over by state_from_jax."""
    jm_sum, tm_sum = models
    jm = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6,
                           use_pallas="greedy")
    tm = TorchScanModel(**state_from_jax(jm), device="cpu")
    assert tm.kernel == "greedy" and tm_sum.kernel == "sum"
    B, L = 8, 2048
    codes = _reads(17, B, L, 0.01)
    lens = np.random.default_rng(17).integers(150, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = tm.step2_boundary(codes, nw, lens)
    for other in (tm_sum.step2_boundary(codes, nw, lens), jm.step2_boundary(codes, nw, lens)):
        np.testing.assert_array_equal(t, np.asarray(other[0]))
        np.testing.assert_array_equal(has, np.asarray(other[1]))
    assert has.any()


def test_kernel_sum_outside_envelope_warns_and_takes_greedy():
    """As the JAX model: 'sum' on a table with periodic entries or more
    than 31 entries warns and takes the greedy kernel."""
    for kmers in (telophrase_kmers("CCCTAA", 5), _K34):
        with pytest.warns(UserWarning, match="falling back to 'greedy'"):
            tm = TorchScanModel(kmers, device="cpu", window_size=100, slide=6,
                                kernel="sum")
        assert tm.kernel == "greedy"
    with pytest.warns(UserWarning, match="falling back to 'greedy'"):
        jm = TelomereScanModel(telophrase_kmers("CCCTAA", 5), window_size=100, slide=6,
                               use_pallas="sum")
    assert jm.pallas_kind == "greedy"


@pytest.mark.parametrize("requested,want", [(None, "sum"), ("sum", "sum"),
                                            ("greedy", "greedy"), (True, "greedy"),
                                            (False, "sum")])
def test_resolve_kernel(requested, want):
    """False is TopsicleConfig's spelling of --kernel xla: the auto route."""
    tm = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", kernel=requested)
    assert tm.kernel == want
    assert tm.fused == (requested is None or requested is False)


@pytest.mark.parametrize("requested", [0, "xla", "bogus"])
def test_unknown_kernel_raises(requested):
    with pytest.raises(ValueError, match="unknown kernel"):
        TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", kernel=requested)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cuda")


def test_mismatched_state_raises():
    kmers = telophrase_kmers("CCCTAAA", 5)
    with pytest.raises(ValueError):
        TorchScanModel(kmers, device="cpu", k=4)
    with pytest.raises(ValueError):
        TorchScanModel(kmers, device="cpu", table=np.zeros(3, np.int32))
