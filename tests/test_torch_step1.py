"""Step 1 of the port (ops.step1_counts and its plain version; the model's
step1_counts_launch) vs the JAX package's step-1 programs
_step1_counts_lean / _step1_counts (greedy="chunked", and "sum" for an
aperiodic table) and the oracle's re.finditer count, and the model's
routes to the kernels' wrappers.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
compiled and compared only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import aperiodic_mask, pack_kmer_table, telophrase_kmers
from topsicle_tpu.models.telomere import _step1_counts, _step1_counts_lean
from topsicle_tpu.oracle import count_nonoverlapping
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.ops import changepoint, cuda_kernels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


NO_BP = 400

# 33 entries: a second round of 32 for the kernel; mixed, with duplicates
# (CCCTA, CCTAA .. are in both tables) and five periods (1, 2, 2, 1, 1)
_K33 = (telophrase_kmers("CCCTAAA", 5) + telophrase_kmers("CCCTAA", 5)
        + ["AAAAA", "CACAC", "ACACA", "TTTTT", "GGGGG", "ATATA", "CCCTA"])

TABLES = {
    "CCCTAAA k=5": telophrase_kmers("CCCTAAA", 5),          # aperiodic
    "CCCTAAA k=7": telophrase_kmers("CCCTAAA", 7),          # 8 of 14 periodic
    "CCCTAA k=5": telophrase_kmers("CCCTAA", 5),            # 2 of 12 periodic
    "homopolymer": ["AAAAAAA", "CCCTAAA", "TTTTTTT"],       # period 1: the longest chains
    "K=33": _K33,
    "duplicates": telophrase_kmers("ATAT", 4),              # each entry twice, period 2
}


def _ends(pattern, seed, B, dirty):
    """[B, 2, NO_BP] end codes and their [B] lengths: noisy repeats of
    `pattern`, a run of A's, a short read, reads shorter than any k (3 and
    0 bases, the second an engine pad row), suffix padding 0xFF; dirty
    ends also carry ~3% invalid bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, 2, NO_BP)).astype(np.uint8)
    rep = np.resize(np.array(["ACGT".index(c) for c in pattern], np.uint8), NO_BP)
    telo = rng.integers(NO_BP // 8, NO_BP, (B, 2))
    keep = (np.arange(NO_BP) < telo[..., None]) & (rng.random(codes.shape) > 0.05)
    codes = np.where(keep, rep, codes).astype(np.uint8)
    codes[0, 0, :150] = 0                      # one long A run
    if dirty:
        codes[rng.random(codes.shape) < 0.03] = 4
    lens = np.full(B, NO_BP, np.int32)
    lens[1], lens[2], lens[-1] = 130, 3, 0
    codes[np.broadcast_to(np.arange(NO_BP) >= lens[:, None, None], codes.shape)] = 0xFF
    return codes, lens


def _wire(codes, lens, lean):
    """The flat [2B, NO_BP/4] wire of the ends and its aux, as the model
    ships them."""
    flat = codes.reshape(-1, NO_BP)
    if lean:
        return batching.pack_codes(flat), np.repeat(lens, 2).astype(np.int32)
    return batching.pack_batch(flat)


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_step1_counts_match_jax(name, lean):
    """Same wire, same table through the JAX step-1 program (the exact
    chunked scan; plain sums too where the table is aperiodic) and
    ops.step1_counts; the dense wire carries dirty rows."""
    kmers = TABLES[name]
    k = len(kmers[0])
    table = pack_kmer_table(kmers)
    B = 6
    codes, lens = _ends(kmers[1], len(kmers) + lean, B, dirty=not lean)
    a, b = _wire(codes, lens, lean)
    jax_fn = _step1_counts_lean if lean else _step1_counts
    aux = jnp.asarray(lens) if lean else jnp.asarray(b.reshape(B, 2, -1))
    want = np.asarray(jax_fn(jnp.asarray(a.reshape(B, 2, -1)), aux, jnp.asarray(table), k=k,
                             greedy="chunked"))
    n0 = dict(cuda_kernels.LAUNCHES)
    got = ops.step1_counts(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(table),
                           k=k, L=NO_BP, lean=lean)
    assert cuda_kernels.LAUNCHES == n0          # the CPU launches no kernel
    assert got.dtype == torch.int32 and got.shape == (2 * B, len(kmers))
    np.testing.assert_array_equal(got.numpy().reshape(B, 2, -1), want)
    if all(aperiodic_mask(kmers)):
        np.testing.assert_array_equal(want, np.asarray(jax_fn(
            jnp.asarray(a.reshape(B, 2, -1)), aux, jnp.asarray(table), k=k, greedy="sum")))
    assert got.max() > 3 and not got[4:6].any() and not got[-2:].any()   # 3 and 0 bases


def test_step1_counts_are_finditer_counts():
    """The homopolymer entry on a run of A's: floor(run / k) taken of
    run - k + 1 occurrences, as re.finditer counts."""
    kmers = TABLES["homopolymer"]
    codes, lens = _ends("CCCTAAA", 1, 4, dirty=False)
    a, b = _wire(codes, lens, True)
    got = ops.step1_counts(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(pack_kmer_table(kmers)), k=7, L=NO_BP,
                           lean=True).numpy()
    for r, row in enumerate(codes.reshape(-1, NO_BP)):
        seq = "".join("ACGTN"[min(c, 4)] for c in row[:lens[r // 2]])
        for e, km in enumerate(kmers):
            assert got[r, e] == count_nonoverlapping(seq, km), (r, km)
    assert got[0, 0] >= 150 // 7


def test_step1_counts_negative_entry_matches_nothing():
    """A -1 entry (a non-ACGT k-mer) counts 0 and leaves the rest alone."""
    kmers = TABLES["CCCTAAA k=7"]
    table = np.concatenate([[-1], pack_kmer_table(kmers), [-1]]).astype(np.int32)
    codes, lens = _ends("CCCTAAA", 2, 4, dirty=True)
    a, b = _wire(codes, lens, False)
    args = (torch.from_numpy(a), torch.from_numpy(b))
    got = ops.step1_counts(*args, torch.from_numpy(table), k=7, L=NO_BP, lean=False)
    want = ops.step1_counts(*args, torch.from_numpy(table[1:-1].copy()), k=7, L=NO_BP,
                            lean=False)
    assert not got[:, 0].any() and not got[:, -1].any() and want.max() > 3
    assert torch.equal(got[:, 1:-1], want)


def test_step1_counts_envelope():
    """A row shorter than k, no rows and no entries give zeros; k > 15
    raises; the plain version counts its calls by device type."""
    wire = torch.zeros((2, 1), dtype=torch.uint8)
    lens = torch.full((2,), 4, dtype=torch.int32)
    tab = torch.from_numpy(pack_kmer_table(TABLES["CCCTAAA k=5"]))
    n0 = dict(cuda_kernels.STEP1_PLAIN_CALLS)
    got = ops.step1_counts(wire, lens, tab, k=5, L=4, lean=True)
    assert got.shape == (2, 14) and got.dtype == torch.int32 and not got.any()
    assert cuda_kernels.STEP1_PLAIN_CALLS == {"cpu": n0["cpu"] + 1, "cuda": n0["cuda"]}
    assert ops.step1_counts(wire[:0], lens[:0], tab, k=5, L=4, lean=True).shape == (0, 14)
    assert ops.step1_counts(wire, lens, tab[:0], k=5, L=4, lean=True).shape == (2, 0)
    with pytest.raises(ValueError, match="15"):
        ops.step1_counts(wire, lens, tab, k=16, L=4, lean=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.step1_counts(wire.to("meta"), lens.to("meta"), tab.to("meta"), k=5, L=4, lean=True)


# ---- the model's routes -------------------------------------------------------

def _recording(monkeypatch):
    """Wrap every kernel wrapper of `ops` so that a call appends its name."""
    called = []
    for name in cuda_kernels.LAUNCHES:
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **k: (called.append(_n),
                                                                        _f(*a, **k))[1])
    return called


@pytest.mark.parametrize("name", ["CCCTAAA k=5", "CCCTAAA k=7"])
def test_model_step1_takes_step1_counts_for_every_table(name, monkeypatch):
    """Aperiodic and mixed tables alike: one call of ops.step1_counts."""
    model = TorchScanModel(TABLES[name], device="cpu", window_size=100, slide=6)
    called = _recording(monkeypatch)
    codes, lens = _ends("CCCTAAA", 3, 5, dirty=False)
    got = model.step1_counts(codes, lens)
    assert called == ["step1_counts"]
    a, b = _wire(codes, lens, True)
    want = cuda_kernels.step1_counts_plain(torch.from_numpy(a), torch.from_numpy(b),
                                           model.table, k=model.k, L=NO_BP, lean=True)
    np.testing.assert_array_equal(got, want.numpy().reshape(5, 2, -1))


@pytest.mark.parametrize("kernel,route", [
    (None, ["greedy_boundary"]), ("greedy", ["greedy_signal", "binseg_l2"]),
    ("sum", ["greedy_signal", "binseg_l2"])])
def test_model_step2_routes_of_a_mixed_table(kernel, route, monkeypatch):
    """Outside the sum kernel's envelope: auto takes the fused greedy
    kernel, a kernel asked for by name the greedy signal and then
    binseg_l2 ("sum" after its warning).  The same (t, has) either way."""
    kmers = TABLES["CCCTAAA k=7"]
    if kernel == "sum":
        with pytest.warns(UserWarning, match="falling back to 'greedy'"):
            model = TorchScanModel(kmers, device="cpu", window_size=100, slide=6,
                                   kernel=kernel)
    else:
        model = TorchScanModel(kmers, device="cpu", window_size=100, slide=6, kernel=kernel)
    assert model.kernel == "greedy" and model.fused is (kernel is None)
    called = _recording(monkeypatch)
    rng = np.random.default_rng(11)
    L = 2048
    codes = rng.integers(0, 4, (6, L)).astype(np.uint8)
    codes[:, :700] = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), 700)
    lens = rng.integers(1000, L + 1, 6).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    plain0 = changepoint.PLAIN_CALLS["cpu"]
    t, has = model.step2_boundary(codes, nw, lens)
    assert called == route and changepoint.PLAIN_CALLS["cpu"] == plain0 + 1
    auto = TorchScanModel(kmers, device="cpu", window_size=100, slide=6)
    ta, ha = auto.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, ta) and np.array_equal(has, ha) and has.all()
