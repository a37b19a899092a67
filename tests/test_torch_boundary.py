"""Step 2 in one call: the plain versions of the port's fused sum kernel
(ops.sum_boundary) and of its changepoint kernel (ops.binseg_l2) against
the JAX package's _step2_boundary_lean / _step2_boundary with
strategy="sum" (plain XLA on the CPU, as tests/test_sum_strategy.py runs
them) and against an exact rational brute force.

On the CPU both wrappers take their plain versions; the CUDA kernels are
compiled and compared only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_ops import _exact_best_t
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import pack_kmer_table, telophrase_kmers
from topsicle_tpu.models.telomere import (TelomereScanModel, _step2_boundary,
                                          _step2_boundary_lean)
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.models import TorchScanModel, state_from_jax
from topsicle_tpu_torch.ops import changepoint, cuda_kernels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(seed, B, L, lean, pattern="CCCTAAA"):
    """[B, L] tails: a noisy repeat of ragged length, random bases after
    it, suffix padding; dense batches carry ~3% invalid bases too."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 3, L + 1, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rep = np.resize(np.array(["ACGT".index(c) for c in pattern], np.uint8), L)
    telo = rng.integers(0, L // 2, B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) > 0.06)
    codes = np.where(keep, rep[None, :], codes).astype(np.uint8)
    if not lean:
        codes[rng.random((B, L)) < 0.03] = 4
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


def _wire(codes, lens, lean):
    return (batching.pack_codes(codes), lens) if lean else batching.pack_batch(codes)


@pytest.mark.parametrize("B,L,k,w,slide,lean", [
    (8, 2000, 5, 100, 6, True), (8, 2000, 5, 100, 6, False),
    (5, 1003, 7, 20, 1, True), (4, 1500, 13, 100, 6, False),
    (3, 1200, 5, 100, 95, True), (2, 104, 5, 100, 6, True),     # W = 1 < jump
])
def test_sum_boundary_matches_jax(B, L, k, w, slide, lean):
    """Same wire, same table, same ragged window counts (0, 3 and W
    among them) through the JAX boundary program and ops.sum_boundary."""
    codes, lens = _batch(B + L + k, B, L, lean)
    table = pack_kmer_table(telophrase_kmers("CCCTAAACCCTAAA"[:max(7, k)], k))
    a, b = _wire(codes, lens, lean)
    Lw = a.shape[1] * 4
    W = ops.num_windows(Lw, w, slide)
    nw = batching.window_counts_for_lengths(lens, w, slide)
    nw[:3] = np.minimum((0, 3, W), W)[:B]
    kw = dict(k=k, window_size=w, slide=slide)
    jax_fn = _step2_boundary_lean if lean else _step2_boundary
    tj, hj = jax_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(nw), jnp.asarray(table),
                    jump=5, min_size=2, strategy="sum", **kw)
    n0 = dict(cuda_kernels.LAUNCHES)
    t, has = ops.sum_boundary(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(table), torch.from_numpy(nw), L=Lw,
                              lean=lean, **kw)
    assert t.dtype == torch.int64 and has.dtype == torch.bool
    assert np.array_equal(t.numpy(), np.asarray(tj))
    assert np.array_equal(has.numpy(), np.asarray(hj))
    assert cuda_kernels.LAUNCHES == n0          # the CPU launches no kernel
    tp, hp = ops.sum_boundary_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(table), torch.from_numpy(nw), L=Lw,
                                    lean=lean, **kw)
    assert torch.equal(t, tp) and torch.equal(has, hp)
    if W >= 10:
        assert has[2:].any()


def test_sum_boundary_vs_bruteforce():
    """The fused call's t is the exact rational argmax of the gain over
    the plain signal, ties to the smaller t."""
    codes, lens = _batch(3, 8, 2000, True)
    table = torch.from_numpy(pack_kmer_table(telophrase_kmers("CCCTAAA", 5)))
    a, b = (torch.from_numpy(x) for x in _wire(codes, lens, True))
    kw = dict(k=5, window_size=100, slide=6, L=a.shape[1] * 4, lean=True)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    y = ops.sum_signal_plain(a, b, table, **kw).numpy()
    t, has = ops.sum_boundary(a, b, table, torch.from_numpy(nw), **kw)
    for i in range(8):
        want = _exact_best_t(y[i].tolist(), int(nw[i]))
        assert (want is None and not has[i]) or (has[i] and int(t[i]) == want), i


@pytest.mark.parametrize("seed,W", [(0, 400), (1, 333), (2, 64)])
def test_binseg_l2_matches_bruteforce(seed, W):
    rng = np.random.default_rng(seed)
    y = rng.integers(1, 60, (8, W)).astype(np.int32)
    y[:, : W // 3] += 40
    n = rng.integers(0, W + 1, 8).astype(np.int32)
    n[:3] = (0, 3, W)
    t, has = ops.binseg_l2(torch.from_numpy(y), torch.from_numpy(n))
    for i in range(8):
        want = _exact_best_t(y[i].tolist(), int(n[i]))
        assert (want is None and not has[i]) or (has[i] and int(t[i]) == want), i


def test_no_candidate_rows_return_jump_and_false():
    """What the tournament's left-wins rule gives a row with no valid
    candidate, and what the CUDA changepoint reproduces: t = jump."""
    y = torch.ones((3, 50), dtype=torch.int32)
    y[:, :15] = 3
    n = torch.tensor([0, 3, 40], dtype=torch.int32)
    t, has = ops.binseg_l2(y, n)
    assert t.tolist() == [5, 5, 15] and has.tolist() == [False, False, True]
    t, has = ops.binseg_l2(y, n, jump=7)
    assert t.tolist() == [7, 7, 14] and has.tolist() == [False, False, True]


def test_all_ties_go_to_the_smallest_t():
    y = torch.full((2, 3312), 7, dtype=torch.int32)
    t, has = ops.binseg_l2(y, torch.tensor([3312, 2000], dtype=torch.int32))
    assert t.tolist() == [5, 5] and has.tolist() == [True, True]


def test_fewer_windows_than_jump_returns_zeros():
    t, has = ops.binseg_l2(torch.ones((2, 4), dtype=torch.int32),
                           torch.tensor([4, 2], dtype=torch.int32))
    assert t.tolist() == [0, 0] and has.tolist() == [False, False]


def test_squares_past_64_bits_stay_exact():
    """y up to 2**30: A**2 passes 2**64, and the answer is still the
    rational brute force's."""
    rng = np.random.default_rng(9)
    y = rng.integers(0, 1 << 30, (4, 300)).astype(np.int32)
    n = np.array([300, 299, 151, 12], np.int32)
    t, has = ops.binseg_l2(torch.from_numpy(y), torch.from_numpy(n))
    S = np.cumsum(y[0].astype(object))
    assert max(abs(300 * S[t_ - 1] - t_ * S[-1]) for t_ in range(5, 300, 5)) ** 2 > 1 << 64
    for i in range(4):
        assert has[i] and int(t[i]) == _exact_best_t(y[i].tolist(), int(n[i]))


def test_plain_changepoint_counts_its_calls_by_device():
    n0 = dict(changepoint.PLAIN_CALLS)
    ops.binseg_l2(torch.ones((1, 20), dtype=torch.int32), torch.tensor([20], dtype=torch.int32))
    assert changepoint.PLAIN_CALLS["cpu"] == n0["cpu"] + 1
    assert changepoint.PLAIN_CALLS["cuda"] == n0["cuda"]


@pytest.mark.parametrize("kernel,fused", [(None, True), ("sum", False), ("greedy", False)])
def test_model_routes(kernel, fused, monkeypatch):
    """Auto takes the fused kernel; "sum" by name and "greedy" take their
    signal kernel and then binseg_l2.  All three give the same (t, has),
    equal to the JAX model's."""
    kmers = telophrase_kmers("CCCTAAA", 5)
    model = TorchScanModel(kmers, device="cpu", window_size=100, slide=6, kernel=kernel)
    assert model.fused is fused and model.kernel == ("greedy" if kernel == "greedy" else "sum")
    called = []
    for name in ("sum_boundary", "sum_signal", "greedy_signal", "binseg_l2"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **k: (called.append(_n),
                                                                        _f(*a, **k))[1])
    codes, lens = _batch(21, 6, 2048, True)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = model.step2_boundary(codes, nw, lens)
    assert called == {None: ["sum_boundary"], "sum": ["sum_signal", "binseg_l2"],
                      "greedy": ["greedy_signal", "binseg_l2"]}[kernel]
    jm = TelomereScanModel(kmers, window_size=100, slide=6)
    tj, hj = jm.step2_boundary(codes, nw, lens)
    assert np.array_equal(t, np.asarray(tj)) and np.array_equal(has, np.asarray(hj))
    assert TorchScanModel(**state_from_jax(jm), device="cpu").jump == jm.jump


def test_empty_shard_rows_come_out_as_the_plain_versions():
    """Global mode feeds all-padding rows (n = 0) once a process runs
    dry: t = jump, has = False, on either route."""
    model = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", window_size=100,
                           slide=6)
    codes = np.full((4, 2048), 0xFF, np.uint8)
    lens = np.zeros(4, np.int32)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = model.step2_boundary(codes, nw, lens)
    assert t.tolist() == [5] * 4 and not has.any()


def test_wrappers_refuse_other_devices():
    """A wrapper serves CPU tensors (plain version) and CUDA tensors
    (kernel); anything else raises, it is not sent to the plain version."""
    y = torch.ones((1, 20), dtype=torch.int32, device="meta")
    n = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.binseg_l2(y, n)
    wire = torch.zeros((1, 64), dtype=torch.uint8, device="meta")
    table = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.sum_boundary(wire, n, table, n, k=5, window_size=100, slide=6, L=256, lean=True)
    with pytest.raises(ValueError, match="at most 31"):
        ops.sum_boundary(wire, n, torch.zeros(32, dtype=torch.int32), n, k=5,
                         window_size=100, slide=6, L=256, lean=True)
