"""The reference against the port's plain torch versions
(TorchEngine(device="cpu") through the CLI) on the generator's output at a
tiny size, and its counting and changepoint against plain loops."""

import contextlib
import io
import json
import random

import numpy as np
import pytest
import torch

from portbench import check
from portbench.gen import fastq
from portbench.reference import topsicle_ref as R
from portbench.run import HERE, cli_argv

CELLS = [("athal_ont_k5", "telo_rich"), ("athal_ont_k5", "wgs"),
         ("human_ont_k456", "telo_rich"), ("human_ont_k456", "wgs")]


def load(config, mix):
    with open(HERE / "configs" / f"{config}.json") as fh:
        cfg = json.load(fh)
    with open(HERE / "mixes" / f"{mix}.json") as fh:
        return cfg, json.load(fh)


@pytest.mark.parametrize("config,mix", CELLS)
def test_reference_matches_the_port_on_cpu(tmp_path, config, mix):
    from topsicle_tpu_torch import cli, pipeline

    cfg, m = load(config, mix)
    files, n = fastq.sizes(m, smoke=True)
    fastq.write_job(str(tmp_path / "in"), 2**31 + 5, cfg, m, files, n)
    kept = []
    run = pipeline.TorchEngine.run

    def keep(self):
        kept.append(run(self))
        return kept[-1]
    pipeline.TorchEngine.run = keep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(cli_argv(cfg["cli"], str(tmp_path / "in"), str(tmp_path / "out"),
                                   "cpu"))
    finally:
        pipeline.TorchEngine.run = run
    assert rc == 0
    want = R.Job(cfg["cli"], str(tmp_path / "in")).run()
    got = check.job_outputs(str(tmp_path / "out"), kept[-1])
    assert want.rows, "no read passed: the tiny input must exercise step 2"
    assert check.compare(want, got) == {name: 0 for name in check.CHECKS}


def count_nonoverlapping(text, needle):
    count = i = 0
    while (j := text.find(needle, i)) >= 0:
        count, i = count + 1, j + len(needle)
    return count


@pytest.mark.parametrize("pattern,k", [("CCCTAA", 5), ("CCCTAA", 6), ("AAAAAA", 3),
                                       ("CCCTAAA", 5), ("ACACAC", 4)])
def test_greedy_counts_match_a_plain_loop(pattern, k):
    rng = random.Random(k)
    kmers = R.kmer_table(pattern, k)
    segs = []
    for _ in range(40):
        unit = rng.choice([pattern, "ACGT", "A", kmers[0]])
        s = "".join(rng.choice([unit, rng.choice("ACGTN")]) for _ in range(rng.randint(1, 60)))
        segs.append(s)
    flat = "".join(segs)
    codes = torch.from_numpy(R.CODES[np.frombuffer(flat.encode(), np.uint8)].copy())
    lens = torch.tensor([len(s) for s in segs])
    starts = torch.cumsum(lens, 0) - lens
    got = R.greedy_counts(codes, starts, lens, kmers).numpy()
    want = [[count_nonoverlapping(s, km) for km in kmers] for s in segs]
    assert got.tolist() == want


def plain_changepoint(y):
    """ruptures' Binseg(l2, jump 5, min_size 2) with one breakpoint, in
    exact rational arithmetic, first best wins."""
    from fractions import Fraction

    n = len(y)
    best_t, best_c = None, None
    for t in range(0, n, 5):
        if t < 2 or n - t < 2:
            continue
        c = Fraction(0)
        for seg in (y[:t], y[t:]):
            mu = Fraction(sum(seg), len(seg))
            c += sum((Fraction(v) - mu) ** 2 for v in seg)
        if best_c is None or c < best_c:
            best_t, best_c = t, c
    return best_t


@pytest.mark.parametrize("seed", range(12))
def test_changepoint_matches_the_least_l2_cost(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 60))
    y = rng.integers(12, 14 if seed % 3 == 0 else 300, n)     # ties where the signal is flat
    if seed % 4 == 1:
        y[: n // 2] += 150
    assert R.changepoint(y) == plain_changepoint(list(map(int, y)))
