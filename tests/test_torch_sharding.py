"""ShardedScanModel, the port's sharded caller of both kernels: a batch
split by rows over several devices equals one device's result and JAX's
shard_map model on the conftest's 8-device CPU mesh, bit for bit (the
device path is integer-exact: tolerance 0).  On the CPU the shards run
the kernels' plain versions; four CPU "devices" stand for four cards."""

import random

import jax
import numpy as np
import pytest
import torch

from tests.test_multihost import _write_file
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu.parallel import ShardedScanModel as JaxShardedScanModel
from topsicle_tpu.parallel import data_mesh
from topsicle_tpu.pipeline import JaxEngine
from topsicle_tpu_torch import pipeline
from topsicle_tpu_torch.models import TorchScanModel, state_from_jax
from topsicle_tpu_torch.parallel import ShardedScanModel

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codes(pattern, seed, B, L, n_frac, ragged=True):
    """[B, L] codes: a noisy repeat of `pattern` over a random prefix,
    random bases after it, N's at `n_frac`, 0xFF past a ragged length
    (0 for the last row, a pad row as the engine makes); and the lengths."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    pat = np.resize(np.array(["ACGT".index(c) for c in pattern], np.uint8), L)
    telo = rng.integers(L // 8, L, B)
    keep = (np.arange(L)[None, :] < telo[:, None]) & (rng.random((B, L)) > 0.05)
    codes = np.where(keep, pat[None, :], codes).astype(np.uint8)
    if n_frac:
        codes[rng.random((B, L)) < n_frac] = 4
    lens = rng.integers(L // 4, L + 1, B).astype(np.int32) if ragged else \
        np.full(B, L, np.int32)
    lens[-1] = 0                              # a pad row, as the engine makes
    codes[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    return codes, lens


@pytest.mark.parametrize("pattern,k", [("CCCTAAA", 5),    # aperiodic: sum kernel
                                       ("CCCTAA", 5)])    # mixed: greedy kernel
@pytest.mark.parametrize("lean", [True, False])
def test_sharded_matches_single_and_jax(pattern, k, lean):
    """Step 1, step 2, the packed API and rawcounts over 4 CPU shards ==
    the single-device model == JAX's ShardedScanModel over 8 devices."""
    jm = TelomereScanModel(telophrase_kmers(pattern, k), window_size=100, slide=6)
    js = JaxShardedScanModel(jm, mesh=data_mesh(8))
    single = TorchScanModel(**state_from_jax(jm), device="cpu")
    sharded = ShardedScanModel(single, CPU4)
    assert len(sharded.models) == 4 and sharded.kmers == single.kmers
    assert {m.kernel for m in sharded.models} == {"sum" if k == 5 and pattern == "CCCTAAA"
                                                  else "greedy"}
    B, L = 16, 2048
    n_frac = 0.0 if lean else 0.02
    ends, _ = _codes(pattern, 3, 2 * B, 1000, n_frac, ragged=False)
    ends = ends.reshape(B, 2, 1000)
    ends_len = np.full(B, 1000, np.int32)
    ends_len[1], ends_len[-1] = 300, 0      # a short read and a pad row
    ends[1, :, 300:] = 0xFF
    ends[-1] = 0xFF
    assert sharded.pack_scan_batch(ends.reshape(2 * B, -1), np.repeat(ends_len, 2))[0] == \
        ("lean" if lean else "dense")
    got = sharded.step1_counts(ends, ends_len)
    np.testing.assert_array_equal(got, single.step1_counts(ends, ends_len))
    np.testing.assert_array_equal(got, np.asarray(js.step1_counts(ends, ends_len)))
    assert got.sum() > 0

    codes, lens = _codes(pattern, 4, B, L, n_frac)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    packed = sharded.pack_scan_batch(codes, lens)
    assert packed[0] == ("lean" if lean else "dense")
    t, has = sharded.step2_boundary(codes, nw, lens)
    for other in (single.step2_boundary(codes, nw, lens), js.step2_boundary(codes, nw, lens),
                  [np.asarray(x) for x in sharded.step2_boundary_launch_packed(packed, nw)],
                  [np.asarray(x) for x in js.step2_boundary_launch_packed(packed, nw)]):
        np.testing.assert_array_equal(t, np.asarray(other[0]))
        np.testing.assert_array_equal(has, np.asarray(other[1]))
    assert t.dtype == np.int64 and has.dtype == np.bool_ and has.any() and not has[-1]

    raw = np.asarray(sharded.rawcounts_launch_packed(packed))
    np.testing.assert_array_equal(raw, single.rawcounts(codes, lens))
    np.testing.assert_array_equal(raw, js.rawcounts(codes, lens))
    np.testing.assert_array_equal(sharded.rawcounts(codes, lens), raw)


def test_sharded_matches_jax_sharded_pallas_sum():
    """Against JAX's sharded caller of the Pallas sum kernel itself
    (`_pallas_prog`, interpret mode, per-shard batch 8), dense wire."""
    jm = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6,
                           use_pallas="sum")
    js = JaxShardedScanModel(jm, mesh=data_mesh(8))
    sharded = ShardedScanModel(TorchScanModel(**state_from_jax(jm), device="cpu"), CPU4)
    codes, lens = _codes("CCCTAAA", 6, 64, 1024, 0.01)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, has = sharded.step2_boundary(codes, nw, lens)
    tj, hj = js.step2_boundary(codes, nw, lens)
    np.testing.assert_array_equal(t, np.asarray(tj))
    np.testing.assert_array_equal(has, np.asarray(hj))
    assert has.sum() > 10


def test_every_shard_launches():
    """Each shard runs its own model on its own rows: shard i's result is
    the single model's on rows [4i, 4i+4)."""
    single = TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu", slide=6)
    sharded = ShardedScanModel(single, CPU4)
    codes, lens = _codes("CCCTAAA", 9, 16, 1024, 0.0)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t, _ = sharded.step2_boundary_launch(codes, nw, lens)
    parts = [np.asarray(p) for p in t._parts]
    assert [len(p) for p in parts] == [4, 4, 4, 4]
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(
            p, single.step2_boundary(codes[4 * i:4 * i + 4], nw[4 * i:4 * i + 4],
                                     lens[4 * i:4 * i + 4])[0])


@pytest.mark.parametrize("B", [0, 9])
def test_batch_must_be_a_positive_multiple(B):
    sharded = ShardedScanModel(TorchScanModel(telophrase_kmers("CCCTAAA", 5), device="cpu"),
                               CPU4)
    with pytest.raises(ValueError, match="multiple of the 4 devices"):
        sharded.step1_counts(np.zeros((B, 2, 1000), np.uint8))


def test_engine_over_three_devices_matches_jax(tmp_path, monkeypatch):
    """TorchEngine on 3 devices at batch 8: the device batch rounds up to
    9 (three shards of 3), and the CSV and subsets equal JaxEngine's."""
    monkeypatch.setattr(pipeline, "local_devices", lambda kind: [torch.device("cpu")] * 3)
    data = tmp_path / "s.fastq.gz"
    _write_file(str(data), random.Random(13), 28)        # 11 kbp reads
    kw = dict(input_dir=str(data), pattern="CCCTAAA", slide=6, batch_size=8,
              telophrase=[5, 7])
    eng = pipeline.TorchEngine(TopsicleConfig(output_dir=str(tmp_path / "t"), **kw),
                               device="cpu")
    eng.run()
    assert eng._B == 9
    assert all(isinstance(m, ShardedScanModel) and m.n == 3 for m in eng._models.values())
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), **kw)).run()
    got = (tmp_path / "t" / "telolengths_all.csv").read_bytes()
    assert got == (tmp_path / "j" / "telolengths_all.csv").read_bytes()
    assert got.count(b",5,") > 9 and b",7," in got
    name = "s.fastq_trc_over_0.7.fastq"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert len(jax.devices()) == 8       # JaxEngine sharded over the 8-device mesh


def test_local_devices(monkeypatch):
    """'cuda' names every visible card explicitly (cuda:0..n-1, whichever
    is current); 'cpu' stays one device; 'cuda' without a card raises."""
    from topsicle_tpu_torch.parallel import local_devices

    assert local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        local_devices("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
