"""Reference-semantics oracle (pure Python + numpy).

Every rule here is the verified contract of SURVEY.md §8, with citations
into the reference tool's sources.  This module is deliberately simple and
sequential — it is the ground truth the device path is property-tested
against, not the fast path.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from topsicle_tpu_torch import aggregate
from topsicle_tpu_torch.config import TopsicleConfig
from topsicle_tpu_torch.io import reader, writer
from topsicle_tpu_torch.kmers import patterns_to_search


def count_nonoverlapping(haystack: str, needle: str) -> int:
    """Number of non-overlapping occurrences, scanning left to right —
    exactly `len(list(re.finditer(needle, haystack)))` for a literal
    needle (allsteps.py:182-183,280-290)."""
    count = 0
    i = 0
    n = len(needle)
    if n == 0:
        return 0
    while True:
        j = haystack.find(needle, i)
        if j < 0:
            return count
        count += 1
        i = j + n


@dataclasses.dataclass
class Step1Hit:
    read_id: str
    kmer: str
    tail: str          # 'forward' | 'reverse'
    trc: float


def step1_trc(seq: str, kmers: Sequence[str], pattern_len: int,
              no_bp: int = 1000, cutoff: float = 0.7) -> Optional[Tuple[str, str, float]]:
    """Step-1 TRC on one read (allsteps.py:152-204).

    Scans seq[:no_bp] and seq[-no_bp:][::-1] (reversed, NOT complemented —
    the complement k-mers in the table cover the other strand), takes the
    best single k-mer count per end (first of equals in table order),
    prefers the forward end only on a strict '>' (allsteps.py:193), and
    keeps the read on a strict TRC > cutoff.  Returns (kmer, tail, trc)
    or None.  Length eligibility (len > minSeqLength) is the caller's job.
    """
    start = seq[:no_bp].upper()
    end = seq[-no_bp:][::-1].upper()
    ratio = no_bp / pattern_len
    best_s = max(range(len(kmers)), key=lambda i: count_nonoverlapping(start, kmers[i]) / ratio)
    best_e = max(range(len(kmers)), key=lambda i: count_nonoverlapping(end, kmers[i]) / ratio)
    trc_s = count_nonoverlapping(start, kmers[best_s]) / ratio
    trc_e = count_nonoverlapping(end, kmers[best_e]) / ratio
    if trc_s > trc_e:
        if trc_s > cutoff:
            return kmers[best_s], "forward", trc_s
    else:
        if trc_e > cutoff:
            return kmers[best_e], "reverse", trc_e
    return None


def window_signal(seq: str, tail: str, kmers: Sequence[str], window_size: int,
                  slide: int, trimfirst: int, maxlengthtelo: int) -> Tuple[List[int], List[float]]:
    """Step-2 per-window mean signal on the telomeric tail
    (allsteps.py:227-297).

    The scanned slice is seq[trimfirst:maxc] (forward) or
    seq[::-1][trimfirst:maxc] (reverse) with maxc = min(maxlengthtelo,
    len(seq)); each window covers windowSize-1 characters (the verified
    off-by-one, allsteps.py:221-224); each k-mer count has an `or 1`
    floor (allsteps.py:281,288).  Returns (window starts, mean values).
    """
    maxc = min(maxlengthtelo, len(seq))
    s = seq if tail == "forward" else seq[::-1]
    s = s[trimfirst:maxc].upper()
    starts: List[int] = []
    means: List[float] = []
    for st in range(0, len(s) - window_size + 1, slide):
        win = s[st : st + window_size - 1]
        counts = [count_nonoverlapping(win, km) or 1 for km in kmers]
        starts.append(st)
        means.append(sum(counts) / len(counts))
    return starts, means


def binseg_l2_single(y: Sequence[float], min_size: int = 2, jump: int = 5) -> Optional[int]:
    """Single-changepoint binary segmentation, L2 cost — the verified
    equivalent of ruptures 1.1.9 `Binseg(model="l2").fit(y).predict(
    n_bkps=1)` (allsteps.py:310-311; SURVEY.md §8 item 9).

    Candidates are t in {jump, 2*jump, ...} with min_size <= t <= n -
    min_size; cost(seg) = sum((y - mean)^2); the first strictly-best t
    wins.  Returns t (the left-segment length, in windows) or None when
    no candidate is admissible.
    """
    n = len(y)
    pre = [0.0] * (n + 1)
    pre2 = [0.0] * (n + 1)
    for i, v in enumerate(y):
        pre[i + 1] = pre[i] + v
        pre2[i + 1] = pre2[i] + v * v

    def cost(a: int, b: int) -> float:
        s = pre[b] - pre[a]
        s2 = pre2[b] - pre2[a]
        return s2 - s * s / (b - a)

    best_t: Optional[int] = None
    best_cost = math.inf
    for t in range(0, n, jump):
        if t < min_size or n - t < min_size:
            continue
        c = cost(0, t) + cost(t, n)
        if c < best_cost:
            best_cost = c
            best_t = t
    return best_t


def boundary_detect(seq: str, tail: str, kmers: Sequence[str], window_size: int,
                    slide: int, trimfirst: int, maxlengthtelo: int) -> int:
    """Step-2 boundary for one read: changepoint index -> base pairs
    (allsteps.py:300-333).  Returns telomere length in bp (0 when the
    boundary is degenerate or undetectable).

    Deviation (documented): when no window/candidate exists the reference
    crashes with an IndexError in its caller; we return 0.
    """
    starts, means = window_signal(seq, tail, kmers, window_size, slide, trimfirst, maxlengthtelo)
    if not means:
        return 0
    t = binseg_l2_single(means)
    if t is None:
        return 0
    maxc = min(maxlengthtelo, len(seq))
    boundary = starts[t] + trimfirst
    if boundary != 0 and boundary <= maxc:
        return int(boundary)
    return 0


@dataclasses.dataclass
class ReadResult:
    file_label: str
    phrase: int
    read_id: str
    trc: float
    telo_length: int
    kmer: str = ""
    tail: str = ""


class OracleEngine:
    """End-to-end CPU engine with the reference's observable outputs:
    telolengths_all.csv, subset FASTQ/FASTA per input file, run log, and
    per-k aggregate lines (main.py:156-309)."""

    def __init__(self, cfg: TopsicleConfig, log: Optional[writer.RunLog] = None):
        cfg.validate()
        self.cfg = cfg
        self.log = log or writer.RunLog(cfg.output_dir if cfg.output_dir else None, echo=False)

    # -- per-file step 1 + subset emission ---------------------------------
    def _step1_file(self, path: str, kmers: Sequence[str]) -> List[Step1Hit]:
        cfg = self.cfg
        cutoff = cfg.min_cutoff()
        hits: List[Step1Hit] = []
        for rec in reader.parse_records(path):
            if len(rec.seq) > cfg.min_seq_length:
                res = step1_trc(rec.seq, kmers, len(cfg.pattern), cfg.no_bp, cutoff)
                if res is not None:
                    km, tail, trc = res
                    hits.append(Step1Hit(rec.id, km, tail, trc))
        return hits

    def _write_subset(self, path: str, hit_ids: set) -> str:
        cfg = self.cfg
        out_path = writer.subset_path(cfg.output_dir, path, cfg.min_cutoff())
        if os.path.exists(out_path):
            self.log(f"Temporary fasta file already exists: {out_path}. Using existing file.")
            return out_path
        fmt = reader.extension_format(path)
        with open(out_path, "w") as fh:
            for rec in reader.parse_records(path):
                if rec.id in hit_ids:
                    writer.write_record(fh, rec, fmt)
        self.log(f"Temporary fasta file with TRC more than {cfg.min_cutoff()}:", out_path)
        return out_path

    # -- full run ----------------------------------------------------------
    def run(self) -> List[ReadResult]:
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        csv_path = os.path.join(cfg.output_dir, "telolengths_all.csv")
        if os.path.exists(csv_path) and os.path.getsize(csv_path) > 0 and not cfg.override:
            raise FileExistsError(
                f"Output file {csv_path} already exists and is not empty. "
                "Use override to force overwrite."
            )
        writer.write_csv_header(csv_path)

        results: List[ReadResult] = []
        phrase_to_telo: Dict[int, List[float]] = {}
        phrase_to_trc: Dict[int, List[float]] = {}
        slide = cfg.slide_value()

        for phrase in cfg.telophrases():
            kmers = patterns_to_search(cfg.pattern, phrase)
            self.log("patterns to search:", kmers)
            for path in cfg.input_paths():
                hits = self._step1_file(path, kmers)
                self._write_subset(path, {h.read_id for h in hits})
                tails = {h.read_id: h.tail for h in hits}
                seqs = {}
                for rec in reader.parse_records(path):
                    if rec.id in tails:
                        seqs[rec.id] = rec.seq
                if cfg.read_check is not None:
                    self.log("checking specific read:", cfg.read_check)
                    hits = [h for h in hits if h.read_id == cfg.read_check]
                    if not hits:
                        raise ValueError(
                            f"read {cfg.read_check!r} did not pass the step-1 TRC "
                            "filter (the reference crashes on this combination; "
                            "refusing clearly)"
                        )

                lbl = writer.file_label(path)
                for image_num, h in enumerate(hits, start=1):
                    telo = boundary_detect(
                        seqs[h.read_id], h.tail, kmers, cfg.window_size,
                        slide, cfg.trimfirst, cfg.maxlengthtelo,
                    )
                    writer.append_csv_row(csv_path, lbl, phrase, h.trc, h.read_id, telo)
                    rr = ReadResult(lbl, phrase, h.read_id, h.trc, telo, h.kmer, h.tail)
                    results.append(rr)
                    phrase_to_telo.setdefault(phrase, []).append(float(telo))
                    phrase_to_trc.setdefault(phrase, []).append(float(h.trc))
                    if cfg.rawcountpattern or cfg.plot:
                        self._per_read_extras(
                            seqs[h.read_id], h, kmers, phrase, slide, telo, image_num
                        )

        aggregate.summarize_all(phrase_to_trc, phrase_to_telo, cfg.input_trc(), log=self.log)
        self.log("All telomere found, have a nice day.")
        return results

    # -- per-read extras (--rawcountpattern / --plot) ----------------------
    def _per_read_extras(self, seq: str, hit: Step1Hit, kmers: Sequence[str],
                         phrase: int, slide: int, telo: int, image_num: int) -> None:
        cfg = self.cfg
        starts, means = window_signal(
            seq, hit.tail, kmers, cfg.window_size, slide,
            cfg.trimfirst, cfg.maxlengthtelo,
        )
        if cfg.rawcountpattern:
            # rawCountPattern's tidy rows (allsteps.py:359-464): positions
            # without the trimfirst offset, counts with the or-1 floor,
            # window-major, pandas-style unlabeled index column.
            import csv as _csv

            path = os.path.join(cfg.output_dir, f"rawcount_{phrase}_{image_num}.csv")
            maxc = min(cfg.maxlengthtelo, len(seq))
            s = (seq if hit.tail == "forward" else seq[::-1])[cfg.trimfirst:maxc].upper()
            # LF line endings: the reference writes this frame with
            # pandas (main.py:146-150), whose output is LF on Linux —
            # the committed demo artifact confirms (csv.writer's default
            # CRLF would diverge from both it and the jax engine's
            # pandas writer)
            with open(path, "w", newline="") as fh:
                w = _csv.writer(fh, lineterminator="\n")
                w.writerow(["", "tail", "position", "pattern", "count"])
                idx = 0
                for st in starts:
                    win = s[st : st + cfg.window_size - 1]
                    for km in kmers:
                        w.writerow([idx, hit.tail, st, km,
                                    count_nonoverlapping(win, km) or 1])
                        idx += 1
        if cfg.plot:
            try:
                from topsicle_tpu_torch.plots import changepoint_plot

                out = os.path.join(cfg.output_dir, f"plot_{phrase}_{image_num}.png")
                x = [st + cfg.trimfirst for st in starts]
                changepoint_plot(
                    x, means, telo, hit.read_id, out,
                    xlim=cfg.rangecp or min(cfg.maxlengthtelo, len(seq)),
                )
            except Exception as e:  # plotting must never kill a run
                self.log(f"plot failed: {e}")
