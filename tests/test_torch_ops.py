"""Plain torch ops of the port vs their JAX counterparts (topsicle_tpu.ops).

Seeded numpy inputs go through both; every output is an integer array,
so the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsicle_tpu import ops as jops
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import encode_ascii, pack_kmer_table, telophrase_kmers
from topsicle_tpu.ops.match import _sliding_reduce as jax_sliding_reduce
from topsicle_tpu.oracle import count_nonoverlapping
from topsicle_tpu_torch import ops as tops
from topsicle_tpu_torch.ops.match import _sliding_reduce, popcount32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codes(seed, B, L, invalid_frac=0.05):
    """[B, L] uint8 codes with ACGT, invalid (4) and pad (0xFF) bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < invalid_frac] = 4
    lens = rng.integers(L // 3, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


@pytest.mark.parametrize("L", [64, 1000, 1003])
def test_unpack_codes_dense_matches_jax(L):
    codes, _ = _codes(L, 6, L)
    p, m = batching.pack_batch(codes)
    Lw = p.shape[1] * 4
    want = np.asarray(jops.unpack_codes(jnp.asarray(p), jnp.asarray(m), Lw))
    got = tops.unpack_codes(torch.from_numpy(p), torch.from_numpy(m), Lw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :L], np.minimum(codes, 4))


@pytest.mark.parametrize("L", [64, 1000, 1003])
def test_unpack_codes_len_matches_jax(L):
    codes, lens = _codes(L + 1, 6, L, invalid_frac=0.0)
    p = batching.pack_codes(codes)
    Lw = p.shape[1] * 4
    want = np.asarray(jops.unpack_codes_len(jnp.asarray(p), jnp.asarray(lens), Lw))
    got = tops.unpack_codes_len(torch.from_numpy(p), torch.from_numpy(lens), Lw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5, 7, 15])
def test_rolling_codes_and_match_match_jax(k):
    codes, _ = _codes(k, 4, 700)
    c4 = np.minimum(codes, 4)
    v_j, ok_j = jops.rolling_codes(jnp.asarray(c4), k)
    v_t, ok_t = tops.rolling_codes(torch.from_numpy(c4), k)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # a table taken from the data, so matches exist, plus a -1 entry
    table = np.asarray(v_j)[0, :40:4].astype(np.int32)
    table = np.concatenate([table, [-1]]).astype(np.int32)
    m_j = jops.match_positions(jnp.asarray(c4), jnp.asarray(table), k)
    m_t = tops.match_positions(torch.from_numpy(c4), torch.from_numpy(table), k)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t.numpy().any()


def test_rolling_codes_refuses_long_k():
    with pytest.raises(ValueError):
        tops.rolling_codes(torch.zeros((1, 40), dtype=torch.uint8), 16)
    with pytest.raises(ValueError):
        tops.rolling_codes(torch.zeros((1, 4), dtype=torch.uint8), 5)


def test_step1_sum_counts_match_oracle_and_greedy():
    """Aperiodic table: the port's greedy count == occurrence sums (the
    JAX package's greedy_count_sum) == the JAX greedy counter == the
    oracle's re.finditer count."""
    rng = np.random.default_rng(3)
    kmers = telophrase_kmers("CCCTAAA", 5)
    table = pack_kmer_table(kmers)
    pat = np.frombuffer(b"CCCTAAA", np.uint8)
    seqs = []
    for i in range(6):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1000)
        n = int(rng.integers(100, 900))
        s[:n] = np.resize(pat, n)
        s[rng.random(1000) < 0.05] = ord("N")
        seqs.append(s.tobytes())
    codes = np.stack([encode_ascii(s) for s in seqs])
    m_t = tops.match_positions(torch.from_numpy(codes), torch.from_numpy(table), 5)
    got = tops.greedy_count(m_t, 5).numpy()
    m_j = jops.match_positions(jnp.asarray(codes), jnp.asarray(table), 5)
    np.testing.assert_array_equal(got, np.asarray(jops.greedy_count_sum(m_j, 5)))
    np.testing.assert_array_equal(got, np.asarray(jops.greedy_count_chunked(m_j, 5)))
    for i, s in enumerate(seqs):
        for j, km in enumerate(kmers):
            assert got[i, j] == count_nonoverlapping(s.decode(), km)


@pytest.mark.parametrize("width", [1, 2, 7, 64, 95])
def test_sliding_reduce_matches_jax(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 1 << 14, (3, 300)).astype(np.int32)
    x[:, -width:] = 0          # the zero cushion callers guarantee
    for op_t, op_j in ((torch.add, jnp.add), (torch.bitwise_or, jnp.bitwise_or)):
        got = _sliding_reduce(torch.from_numpy(x), width, op_t).numpy()
        want = np.asarray(jax_sliding_reduce(jnp.asarray(x), width, op_j))
        np.testing.assert_array_equal(got, want)


def test_popcount32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 31, 1000, dtype=np.int64).astype(np.int32)
    x[:3] = [0, 1, (1 << 31) - 1]
    want = np.array([bin(int(v)).count("1") for v in x], np.int32)
    np.testing.assert_array_equal(popcount32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("k,w,slide", [(5, 100, 6), (4, 64, 3), (5, 100, 1),
                                       (6, 80, 7), (7, 120, 7)])
def test_boundary_sum_signal_matches_jax(k, w, slide):
    codes, _ = _codes(k * 10 + slide, 5, 1536)
    c4 = np.minimum(codes, 4)
    table = pack_kmer_table(telophrase_kmers("CCCTAAA", k))
    W = (1536 - w) // slide + 1
    want = np.asarray(jops.boundary_sum_signal(jnp.asarray(c4), jnp.asarray(table),
                                               k, w, slide, W))
    got = tops.boundary_sum_signal(torch.from_numpy(c4), torch.from_numpy(table),
                                   k, w, slide, W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_boundary_sum_signal_empty_geometry():
    c = torch.zeros((3, 50), dtype=torch.uint8)
    t = torch.tensor(pack_kmer_table(telophrase_kmers("CCCTAAA", 5)))
    assert tops.boundary_sum_signal(c, t, 5, 100, 6, 0).shape == (3, 0)
    with pytest.raises(ValueError):
        tops.boundary_sum_signal(c, torch.zeros(32, dtype=torch.int32), 5, 20, 6, 3)
