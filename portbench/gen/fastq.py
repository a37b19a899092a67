"""Seeded ONT-like FASTQ inputs for one cell: a job's directory of gzipped
files, made from a traffic mix (`mixes/<name>.json`) and a configuration
(`configs/<name>.json`).

A copy of chip_smoke.py's `_write_fastq` (a telomeric repeat with
substitutions at the start of a forward read, its complement at the end
of a reverse one, random bases elsewhere), parametrised by the mix:
lognormal read lengths, a telomeric share or a share drawn from the
genome's chromosome ends, per-base Phred qualities, no N's.

Every seed gets the same work in another order: each file holds the same
set of read lengths (the lognormal's quantiles) and the same telomeric
reads (lengths, telomere lengths spread evenly over the configuration's
range, strands); the seed places them and draws every base, substitution
and quality.

Run as a child process while the parent imports torch:

    python portbench/gen/fastq.py --config C.json --mix M.json --seed N \
        [--out DIR [--only F]] [--warmup DIR] [--smoke]
"""

from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import statistics
import sys

import numpy as np

ALPHA = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """One generator per (seed, stream): any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream]))


def length_set(n: int, spec: dict) -> np.ndarray:
    """The n read lengths every file holds: the lognormal's quantiles at
    (i + 0.5) / n, clipped to [min_bp, max_bp]."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.exp(math.log(spec["median_bp"]) + spec["sigma"] * z)
    return np.clip(np.rint(out), spec["min_bp"], spec["max_bp"]).astype(np.int64)


def quality_table(q: dict) -> np.ndarray:
    """[65536] uint8 FASTQ quality characters: a normal's quantiles at
    (i + 0.5) / 65536, rounded and clipped to [phred_min, phred_max], so a
    uniform 16-bit draw gives a per-base Phred score."""
    nd = statistics.NormalDist(q["phred_mean"], q["phred_sd"])
    x = np.array([nd.inv_cdf((i + 0.5) / 65536) for i in range(65536)])
    return (np.clip(np.rint(x), q["phred_min"], q["phred_max"]) + 33).astype(np.uint8)


def telomeric_per_file(mix: dict, cfg: dict, files: int, reads_per_file: int,
                       share: float | None = None) -> list[int]:
    """Telomeric reads in each file of a job."""
    rule = mix["telomeric"]
    total_reads = files * reads_per_file
    if share is None and "share" in rule:
        share = rule["share"]
    if share is not None:
        per = [int(round(share * reads_per_file))] * files
    else:
        spec = mix["read_length"]
        mean_bp = spec["median_bp"] * math.exp(spec["sigma"] ** 2 / 2)
        g = cfg["genome"]
        t = math.ceil(g["chromosome_ends"] * mean_bp / g["size_bp"] * total_reads)
        t = max(rule["min_per_job"], t)
        per = [t // files + (i < t % files) for i in range(files)]
    return per


def plan(seed: int, cfg: dict, mix: dict, files: int, reads_per_file: int,
         share: float | None = None, stream: int = 0):
    """Per file: (lengths [n], telomere lengths [n] with 0 for a read
    without one, forward [n] bool).  The same set of (length, telomere,
    strand) for every seed, at places the seed draws."""
    min_len = cfg["cli"]["minSeqLength"]
    lo, hi = cfg["genome"]["telomere_bp"]
    per = telomeric_per_file(mix, cfg, files, reads_per_file, share)
    lengths_sorted = np.sort(length_set(reads_per_file, mix["read_length"]))
    eligible = np.nonzero(lengths_sorted > min_len)[0]
    sub_min = mix["subtelomere_min_bp"]
    out = []
    for f in range(files):
        rng = _rng(seed, stream, f, 1)
        t_f = per[f]
        # the telomeric reads take evenly spaced lengths from the eligible
        # part of the set, paired in order with telomeres at the midpoints
        # of t_f equal parts of the range, alternately forward and reverse
        pick = eligible[np.rint(np.linspace(0, len(eligible) - 1, t_f)).astype(np.int64)]
        telos = np.rint(lo + (hi - lo) * (np.arange(t_f) + 0.5) / max(t_f, 1)).astype(np.int64)
        rest = np.setdiff1d(np.arange(reads_per_file), pick)
        pos = rng.permutation(reads_per_file)
        tel_pos, other_pos = pos[:t_f], pos[t_f:]
        lengths = np.empty(reads_per_file, np.int64)
        lengths[tel_pos] = lengths_sorted[pick]
        lengths[other_pos] = lengths_sorted[rest][rng.permutation(len(rest))]
        telo = np.zeros(reads_per_file, np.int64)
        telo[tel_pos] = np.minimum(telos, lengths[tel_pos] - sub_min)
        fwd = np.ones(reads_per_file, bool)
        fwd[tel_pos] = np.arange(t_f) % 2 == 0
        out.append((lengths, telo, fwd))
    return out


def write_file(path: str, seed: int, file_idx: int, lengths: np.ndarray, telo: np.ndarray,
               fwd: np.ndarray, pattern: str, mix: dict, stream: int = 0) -> int:
    """One gzipped FASTQ (level 1).  Returns the bases written."""
    rng = _rng(seed, stream, file_idx, 2)
    total = int(lengths.sum())
    seq = ALPHA[rng.integers(0, 4, total, dtype=np.uint8)]
    qual = quality_table(mix["quality"])[rng.integers(0, 1 << 16, total, dtype=np.uint16)]
    fwd_rep = np.frombuffer(pattern.encode(), np.uint8)
    rev_rep = np.frombuffer(pattern[::-1].encode().translate(COMPLEMENT), np.uint8)
    sub = mix["repeat_substitution"]
    offs = np.concatenate([[0], np.cumsum(lengths)])
    for i in np.nonzero(telo)[0]:
        tl, n, a = int(telo[i]), int(lengths[i]), int(offs[i])
        rep = np.resize(fwd_rep if fwd[i] else rev_rep, tl)
        noisy = rng.random(tl) < sub
        rep[noisy] = ALPHA[rng.integers(0, 4, int(noisy.sum()))]
        if fwd[i]:
            seq[a:a + tl] = rep
        else:
            seq[a + n - tl:a + n] = rep
    sb, qb = seq.tobytes(), qual.tobytes()
    parts = []
    for i in range(len(lengths)):
        a, b = int(offs[i]), int(offs[i + 1])
        parts.append(b"@r%d.%d read=%d ch=%d\n%s\n+\n%s\n"
                     % (file_idx, i, i, 1 + (i * 37 + file_idx) % 512, sb[a:b], qb[a:b]))
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(parts))
    return total


def write_job(out_dir: str, seed: int, cfg: dict, mix: dict, files: int, reads_per_file: int,
              share: float | None = None, stream: int = 0, only: int | None = None) -> int:
    """A job's input directory: `files` files of `reads_per_file` reads
    (or file `only` of them).  Returns the bases written."""
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for f, (lengths, telo, fwd) in enumerate(
            plan(seed, cfg, mix, files, reads_per_file, share, stream)):
        if only is not None and f != only:
            continue
        total += write_file(os.path.join(out_dir, f"sample{f}.fastq.gz"), seed, f, lengths,
                            telo, fwd, cfg["cli"]["pattern"], mix, stream)
    return total


def sizes(mix: dict, smoke: bool) -> tuple[int, int]:
    """(files, reads a file) of the measured job."""
    n = mix["smoke"]["reads_per_file"] if smoke else mix["reads_per_file"]
    return mix["files"], n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--mix", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None, help="write the measured job's input here")
    p.add_argument("--warmup", default=None, help="also write the warm-up job's input here first")
    p.add_argument("--only", type=int, default=None, help="write only this file of the job")
    p.add_argument("--smoke", action="store_true")
    a = p.parse_args(argv)
    with open(a.config) as fh:
        cfg = json.load(fh)
    with open(a.mix) as fh:
        mix = json.load(fh)
    if a.warmup:
        w = mix["warmup"]
        n = mix["smoke"]["reads_per_file"] if a.smoke else w["reads_per_file"]
        write_job(a.warmup, a.seed, cfg, mix, w["files"], n, share=w["telomeric_share"],
                  stream=1)
    if a.out:
        files, n = sizes(mix, a.smoke)
        write_job(a.out, a.seed, cfg, mix, files, n, only=a.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
