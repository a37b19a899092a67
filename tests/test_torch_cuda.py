"""The port on a CUDA card: the hand-written kernel against its plain
version, and the model and engine on the card against the same code on
the CPU.  Every test needs a card and skips without one.

This file imports no jax (the machine with the card has none), so it
runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import gzip
import os

import numpy as np
import pytest
import torch

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import pack_kmer_table, telophrase_kmers
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.ops import cuda_kernels
from topsicle_tpu_torch.pipeline import TorchEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _batch(seed, B, L, lean):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 4, L + 1, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[:, :L // 3] = np.resize(np.array([1, 1, 1, 3, 0, 0, 0], np.uint8), L // 3)
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
