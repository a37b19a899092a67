"""Plain reference of what one Topsicle job writes, worked out from the input
files and the configuration alone.

Semantics of the upstream tool (github.com/jaeyoungchoilab/Topsicle,
Topsicle/allsteps.py and main.py), written anew here:

- k-mer table: the sorted distinct k-long substrings of the doubled,
  uppercased pattern, then each of them complemented (ACGT -> TGCA, not
  reversed); ties go to the first entry in this order.
- step 1, on reads longer than minSeqLength: for each entry, the number of
  leftmost non-overlapping occurrences (Python's `re.finditer`) in the
  read's first 1,000 bases and in its last 1,000 reversed (not
  complemented); per end the entry with the most (first of equals); TRC =
  count / (1000 / len(pattern)); the forward end only when its TRC is
  strictly the larger; the read passes on TRC strictly above the least
  cutoff.
- step 2, on each passing read: the tail (the read, or the read reversed,
  from trimfirst to min(maxlengthtelo, length)); windows every `slide`
  bases that fit windowSize bases, each counting over windowSize - 1
  bases; a window's signal is the mean over entries of max(count, 1); one
  changepoint by binary segmentation with the L2 cost (candidates every 5
  windows, at least 2 windows a side), taken exactly here: the least cost
  in exact arithmetic, ties to the smaller candidate; the telomere length
  is trimfirst + slide * t, or 0 when there is no candidate or it lies
  past min(maxlengthtelo, length).
- outputs: telolengths_all.csv rows (phrase, then file in os.walk order,
  then read order; TRC to 3 decimals; CRLF), the subset FASTQ of each file
  (the records that pass the first phrase, as read), and the aggregate
  lines of each phrase (median, the quadratic fit of telomere length on
  TRC and its clamps, the filtered median).

The counting runs in plain torch (on the card when there is one, after the
measured window; on the CPU in tests); the changepoint, TRC and aggregates
in NumPy float64, or float32 with `precision="float32"` (the control).
Nothing here imports the program under test.
"""

from __future__ import annotations

import csv
import dataclasses
import gzip
import hashlib
import io
import os
import warnings
from fractions import Fraction
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

COMPLEMENT = str.maketrans("ACGT", "TGCA")
NO_BP = 1000        # step 1's end width (the upstream main.py's no_bp)
JUMP, MIN_SIZE = 5, 2   # the changepoint's candidate step and least segment
CODES = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODES[_c] = CODES[_c + 32] = _i


@dataclasses.dataclass
class Record:
    header: bytes
    seq: bytes
    raw: bytes          # the record's four lines as in the file

    @property
    def id(self) -> str:
        return self.header.split(None, 1)[0].decode()


@dataclasses.dataclass
class Outputs:
    """What one job writes, in the form both sides are compared in."""
    rows: List[tuple]              # (phrase, label, read_id, trc, telo, kmer, tail)
    csv: bytes
    subsets: Dict[str, str]        # subset file name -> sha256
    aggregate: List[str]           # the run log's aggregate lines, no timestamps


def kmer_table(pattern: str, k: int) -> List[str]:
    doubled = (pattern + pattern).upper()
    origin = sorted({doubled[i:i + k] for i in range(len(doubled) - k + 1)})
    return origin + [s.translate(COMPLEMENT) for s in origin]


def self_overlapping(kmer: str) -> bool:
    """True when two occurrences of the k-mer can overlap (a period < k)."""
    return any(kmer[d:] == kmer[:-d] for d in range(1, len(kmer)))


def read_fastq(path: str) -> List[Record]:
    """Four-line FASTQ records, gzipped or not."""
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".gz"):
        data = gzip.decompress(data)
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise ValueError(f"{path}: not four-line FASTQ")
    out = []
    for i in range(0, len(lines), 4):
        h, s, plus, q = lines[i:i + 4]
        if not h.startswith(b"@") or not plus.startswith(b"+") or len(q) != len(s):
            raise ValueError(f"{path}: malformed record at line {i + 1}")
        out.append(Record(h[1:], s, b"\n".join((h, s, plus, q)) + b"\n"))
    return out


def input_paths(input_dir: str) -> List[str]:
    """The upstream tool's file discovery: os.walk order."""
    out = []
    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            out.append(os.path.join(root, name))
    return out


def file_label(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def greedy_counts(flat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                  kmers: Sequence[str]) -> torch.Tensor:
    """[segments, K] int32: leftmost non-overlapping occurrences of each
    k-mer lying wholly inside flat[start:start + len], for every segment.
    flat holds base codes (A0 C1 G2 T3, anything else 4)."""
    dev = flat.device
    k = len(kmers[0])
    N = flat.numel()
    P = N - k + 1                       # positions where a k-mer can start
    big = torch.iinfo(torch.int64).max // 2
    lim = starts + lens - k             # the last start that fits a segment
    out = torch.zeros((starts.numel(), len(kmers)), dtype=torch.int32, device=dev)
    if P <= 0:
        return out
    idx = torch.arange(P, dtype=torch.int64, device=dev)
    # each position's k-mer as a base-4 number, -1 where it holds a non-base
    code = torch.zeros(P, dtype=torch.int64, device=dev)
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    for i in range(k):
        c = flat[i:i + P].to(torch.int64)
        code = code * 4 + c.clamp(max=3)
        bad |= c > 3
    code[bad] = -1
    for j, km in enumerate(kmers):
        want = 0
        for c in CODES[np.frombuffer(km.encode(), np.uint8)]:
            want = want * 4 + int(c) if c < 4 and want >= 0 else -2
        hit = code == want
        nxt = torch.where(hit, idx, torch.full_like(idx, big))
        nxt = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
        nxt = torch.cat([nxt, torch.full((1,), big, dtype=torch.int64, device=dev)])
        p = nxt[starts.clamp(max=P)]
        cnt = torch.zeros(starts.numel(), dtype=torch.int32, device=dev)
        act = torch.nonzero(p <= lim).flatten()
        while act.numel():
            cnt[act] += 1
            q = nxt[(p[act] + k).clamp(max=P)]
            p[act] = q
            act = act[q <= lim[act]]
        out[:, j] = cnt
    return out


def changepoint(y: np.ndarray) -> Optional[int]:
    """The candidate t (left segment length, in windows) of least L2 cost,
    exactly; None when no candidate is admissible."""
    n = len(y)
    t = np.arange(0, n, JUMP, dtype=np.int64)
    t = t[(t >= MIN_SIZE) & (n - t >= MIN_SIZE)]
    if not len(t):
        return None
    S = np.cumsum(y.astype(np.int64))
    a = n * S[t - 1] - t * S[-1]
    d = t * (n - t)
    g = a.astype(np.float64) ** 2 / d
    near = np.nonzero(g >= g.max() * (1 - 1e-9))[0]
    best, best_key = None, None
    for i in near:      # settle the near-best exactly, first of equals
        key = Fraction(int(a[i]) ** 2, int(d[i]))
        if best_key is None or key > best_key:
            best, best_key = int(t[i]), key
    return best


def summarize(phrase: int, trc: Sequence[float], telo: Sequence[float], input_trc: float,
              dtype=np.float64) -> List[str]:
    """The upstream main.py's aggregate lines of one phrase."""
    lines = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        median_telo = float(np.median(np.asarray(telo, dtype=dtype)))
        median_trc = float(np.median(np.asarray(trc, dtype=dtype)))
    lines.append(f"k-mer: {phrase}, with TRC >= {input_trc}, median telomere length is "
                 f"{median_telo:.2f} bp")
    if len(telo) < 3:
        lines.append("Not enough data points to recommend TRC cutoff.")
        return lines
    max_trc = max(trc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, b, c = (float(v) for v in np.polyfit(np.asarray(trc, dtype=dtype),
                                                np.asarray(telo, dtype=dtype), 2))
    vx = -b / (2 * a)
    if vx > 1.0:
        vx = median_trc
    if vx < input_trc:
        vx = input_trc
    if vx > max_trc:
        lines.append(f"Asymptotic TRC {vx:.3f} is greater than max TRC, which is not "
                     "expected. See plot.")
        if median_trc < 1.0:
            lines.append(f"Using median TRC value ({median_trc:.3f}) as asymptotic TRC "
                         "instead.")
            vx = median_trc
        else:
            lines.append("Using 0.9 as asymptotic TRC instead, since asymptotic is greater "
                         "than 1.0.")
            vx = 0.9
    if vx < 0.4:
        lines.append("Quadratic fit suggests asymptotic TRC less than 0.4. See plot with fit "
                     "line")
        if max_trc < 0.4:
            lines.append(f"Maximum TRC value in data is {max_trc:.3f}, which is less than 0.4, "
                         "indicating low confidence in telomere detection.")
        if vx < input_trc:
            lines.append(f"Asymptotic TRC {vx:.3f} is less than input cutoff {input_trc:.3f}. "
                         f"Topsicle declares input TRC (={input_trc}) as asymptotic TRC.")
            vx = input_trc
    lines.append(f"asymptotic TRC, or recommended cutoff: {vx:.3f}")
    kept = [t for r, t in zip(trc, telo) if r >= vx]
    if kept:
        med = float(np.median(np.asarray(kept, dtype=dtype)))
        lines.append(f"Median telomere length for reads with TRC cutoff >= {vx:.3f}: "
                     f"{med:.2f} bp")
    else:
        lines.append(f"No read has TRC >= {vx:.3f}, please double check the data or submit "
                     "log to GitHub.")
    return lines


class Job:
    """The reference's run of one job: `cli` is a configuration's "cli"
    section.  `work` collects what the kernels' bounds are counted from
    (portbench/roofline.py)."""

    def __init__(self, cli: dict, input_dir: str, device: str = "cpu",
                 precision: str = "float64"):
        self.cli = cli
        self.input_dir = input_dir
        self.device = torch.device(device)
        self.dtype = {"float64": np.float64, "float32": np.float32}[precision]
        self.work: Dict[int, dict] = {}
        self.bases = 0      # every read's bases, the short ones too

    def phrases(self) -> List[int]:
        return list(self.cli["telophrase"]) or [len(self.cli["pattern"]) - 2]

    def _step1(self, reads: List[Record], kmers: List[str], pattern_len: int):
        """(pass [R] bool, kmer index [R], forward [R] bool, trc [R]) and
        the raw end counts, on the eligible reads."""
        R = len(reads)
        ends = np.full((R, 2, NO_BP), 4, np.uint8)
        for r, rec in enumerate(reads):
            c = CODES[np.frombuffer(rec.seq, np.uint8)]
            n = min(len(c), NO_BP)
            ends[r, 0, :n] = c[:n]
            ends[r, 1, :n] = c[len(c) - n:][::-1]
        lens = np.minimum([len(rec.seq) for rec in reads], NO_BP).repeat(2) if R else \
            np.zeros(0, np.int64)
        flat = torch.from_numpy(ends.reshape(-1)).to(self.device)
        starts = torch.arange(2 * R, dtype=torch.int64, device=self.device) * NO_BP
        counts = greedy_counts(flat, starts, torch.as_tensor(lens, dtype=torch.int64,
                                                             device=self.device), kmers)
        counts = counts.cpu().numpy().reshape(R, 2, len(kmers))
        ratio = self.dtype(NO_BP) / self.dtype(pattern_len)
        js, je = counts[:, 0].argmax(1), counts[:, 1].argmax(1)
        b = np.arange(R)
        trc_s = counts[b, 0, js].astype(self.dtype) / ratio
        trc_e = counts[b, 1, je].astype(self.dtype) / ratio
        fwd = trc_s > trc_e
        trc = np.where(fwd, trc_s, trc_e)
        return trc > min(self.cli["cutoff"]), np.where(fwd, js, je), fwd, trc, counts

    def _step2(self, tails: List[np.ndarray], kmers: List[str]):
        """Per tail: (telomere window t or None, windows n, raw counts
        of the self-overlapping entries summed)."""
        w, slide = self.cli["windowSize"], self.cli["slide"]
        nw = [max(0, (len(s) - w) // slide + 1) for s in tails]
        offs = np.concatenate([[0], np.cumsum([len(s) for s in tails])]).astype(np.int64)
        flat = torch.from_numpy(np.concatenate(tails) if tails else np.zeros(0, np.uint8))
        starts = np.concatenate([offs[i] + np.arange(n, dtype=np.int64) * slide
                                 for i, n in enumerate(nw)]) if tails else np.zeros(0, np.int64)
        dev = self.device
        starts_t = torch.from_numpy(starts).to(dev)
        counts = greedy_counts(flat.to(dev), starts_t,
                               torch.full_like(starts_t, w - 1), kmers).cpu().numpy()
        y = np.maximum(counts, 1).sum(axis=1)
        periodic = [j for j, km in enumerate(kmers) if self_overlapping(km)]
        takes = counts[:, periodic].sum(axis=1)
        out, a = [], 0
        for n in nw:
            out.append((changepoint(y[a:a + n]), n, int(takes[a:a + n].sum())))
            a += n
        return out

    def run(self) -> Outputs:
        cli = self.cli
        pattern = cli["pattern"]
        min_cut = min(cli["cutoff"])
        files = [(file_label(p), read_fastq(p)) for p in input_paths(self.input_dir)]
        self.bases = sum(len(r.seq) for _, recs in files for r in recs)
        # every file's eligible reads at once, in file and read order
        elig = [(label, r) for label, recs in files for r in recs
                if len(r.seq) > cli["minSeqLength"]]
        rows: List[tuple] = []
        subsets: Dict[str, str] = {}
        agg: List[str] = []
        for phrase in self.phrases():
            kmers = kmer_table(pattern, phrase)
            periodic = [j for j, km in enumerate(kmers) if self_overlapping(km)]
            keep, sel, fwd, trc, counts = self._step1([r for _, r in elig], kmers,
                                                      len(pattern))
            passing = np.nonzero(keep)[0]
            if phrase == self.phrases()[0]:
                for label, _ in files:
                    mine = b"".join(elig[i][1].raw for i in passing if elig[i][0] == label)
                    subsets[f"{label}_trc_over_{min_cut}.fastq"] = \
                        hashlib.sha256(mine).hexdigest()
            tails, maxc = [], []
            for i in passing:
                c = CODES[np.frombuffer(elig[i][1].seq, np.uint8)]
                maxc.append(min(cli["maxlengthtelo"], len(c)))
                tails.append((c if fwd[i] else c[::-1])[cli["trimfirst"]:maxc[-1]].copy())
            work = {"k": phrase, "K": len(kmers), "self_overlapping": len(periodic),
                    "step1_reads": len(elig), "step1_takes": int(counts[:, :, periodic].sum()),
                    "step2_reads": 0, "step2_windows": 0, "step2_candidates": 0,
                    "step2_positions": 0, "step2_groups": 0, "step2_takes": 0,
                    "step2_bases": 0}
            trcs, telos = [], []
            for i, s, m, (t, n, takes) in zip(passing, tails, maxc, self._step2(tails, kmers)):
                telo = 0 if t is None else cli["trimfirst"] + cli["slide"] * t
                if telo > m:
                    telo = 0
                label, rec = elig[i]
                rows.append((phrase, label, rec.id, float(trc[i]), int(telo),
                             kmers[int(sel[i])], "forward" if fwd[i] else "reverse"))
                trcs.append(float(trc[i]))
                telos.append(float(telo))
                inside = max(0, min(len(s) - phrase + 1,
                                    (n - 1) * cli["slide"] + cli["windowSize"] - phrase)) \
                    if n else 0
                work["step2_reads"] += 1
                work["step2_windows"] += n
                work["step2_candidates"] += len(range(JUMP, n - MIN_SIZE + 1, JUMP))
                work["step2_positions"] += inside
                work["step2_groups"] += -(-inside // cli["slide"])
                work["step2_takes"] += takes
                work["step2_bases"] += len(s)
            self.work[phrase] = work
            agg += summarize(phrase, trcs, telos, input_trc=cli["cutoff"][0], dtype=self.dtype)
        # the CSV lists each phrase's rows file by file
        order = {label: f for f, (label, _) in enumerate(files)}
        rows.sort(key=lambda r: (self.phrases().index(r[0]), order[r[1]]))
        buf = io.StringIO(newline="")
        wr = csv.writer(buf)
        wr.writerow(["file_number", "phrase", "trc", "readID", "telo_length"])
        for phrase, label, rid, trc, telo, _km, _tail in rows:
            wr.writerow([label, phrase, f"{trc:.3f}", rid, telo])
        return Outputs(rows, buf.getvalue().encode(), subsets, agg)
