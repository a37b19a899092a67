"""The comparison that decides `correct`: one job's outputs against the
reference's (portbench/reference/topsicle_ref.py), number by number, each
against its limit.

Every number counts disagreements, and the upstream tool's contract is
exact output (the same CSV, subset FASTQ and aggregate lines), so every
limit is 0.  PERF.md gives the readings of sound runs and of the control
that the limits stand between.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, List

from portbench.reference.topsicle_ref import Outputs

# name -> (what it counts, limit)
CHECKS = {
    "reads_differ": ("passing reads (phrase, file, read id) on one side only", 0),
    "step1_differ": ("reads on both sides whose end, k-mer or TRC (float64) differ", 0),
    "telo_differ": ("reads on both sides whose telomere length differs", 0),
    "csv_differ": ("jobs whose telolengths_all.csv bytes differ", 0),
    "subset_differ": ("subset FASTQ files missing or extra (every job), or whose bytes differ "
                      "(the jobs whose files were kept)", 0),
    "aggregate_differ": ("jobs whose aggregate lines differ", 0),
}

_STAMP = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")
# the aggregate messages of the upstream main.py, by their openings; other
# lines there (a plot that could not be drawn) are not aggregates
AGGREGATE = ("k-mer: ", "Not enough data points", "Asymptotic TRC", "Using ",
             "Quadratic fit suggests", "Maximum TRC value", "asymptotic TRC, or recommended",
             "Median telomere length for reads", "No read has TRC")
SUBSET = re.compile(r"_trc_over_.*\.fast[aq]$")


def aggregate_lines(run_log: str) -> List[str]:
    """The aggregate lines of every phrase, without their timestamps: the
    run log's lines after its `stages:` line and before the closing line
    that open as one of the upstream tool's aggregate messages."""
    with open(run_log) as fh:
        lines = [_STAMP.sub("", ln.rstrip("\n")) for ln in fh]
    start = max((i for i, ln in enumerate(lines) if ln.startswith("stages: ")), default=None)
    if start is None:
        return []
    out = []
    for ln in lines[start + 1:]:
        if ln == "All telomere found, have a nice day.":
            break
        if ln.startswith(AGGREGATE):
            out.append(ln)
    return out


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def subset_names(out_dir: str) -> List[str]:
    return [n for n in sorted(os.listdir(out_dir)) if SUBSET.search(n)]


def job_outputs(out_dir: str, results, deleted=None) -> Outputs:
    """A finished CLI job's outputs: `results` is what the engine's run
    returned (objects with file_label, phrase, read_id, trc, telo_length,
    kmer and tail).  `deleted` names the job's subset files that were
    deleted unread: each is there, its bytes None (not compared)."""
    rows = [(r.phrase, r.file_label, r.read_id, r.trc, r.telo_length, r.kmer, r.tail)
            for r in results]
    with open(os.path.join(out_dir, "telolengths_all.csv"), "rb") as fh:
        csv_bytes = fh.read()
    subsets = {n: sha256_file(os.path.join(out_dir, n)) for n in subset_names(out_dir)}
    subsets.update({n: None for n in deleted or ()})
    return Outputs(rows, csv_bytes, subsets,
                   aggregate_lines(os.path.join(out_dir, "topsicle_run.log")))


def subsets_differing(want: Outputs, got: Outputs) -> List[str]:
    """Subset files on one side only, or whose bytes differ where the
    program's were kept."""
    return [n for n in sorted(want.subsets.keys() | got.subsets.keys())
            if n not in want.subsets or n not in got.subsets
            or got.subsets[n] not in (None, want.subsets[n])]


def compare(want: Outputs, got: Outputs) -> Dict[str, int]:
    """Each check's count for one job."""
    wk = {r[:3]: r for r in want.rows}
    gk = {r[:3]: r for r in got.rows}
    both = wk.keys() & gk.keys()
    return {
        "reads_differ": len(wk.keys() ^ gk.keys()) + (len(got.rows) - len(gk)),
        "step1_differ": sum((wk[k][3], wk[k][5], wk[k][6]) != (gk[k][3], gk[k][5], gk[k][6])
                            for k in both),
        "telo_differ": sum(wk[k][4] != gk[k][4] for k in both),
        "csv_differ": int(want.csv != got.csv),
        "subset_differ": len(subsets_differing(want, got)),
        "aggregate_differ": int(want.aggregate != got.aggregate),
    }


def first_difference(want: Outputs, got: Outputs) -> str:
    """One line naming the first disagreement, for the run's error output."""
    wk = {r[:3]: r for r in want.rows}
    for r in got.rows:
        if wk.get(r[:3]) != r:
            return f"row: program {r}, reference {wk.get(r[:3])}"
    if len(want.rows) != len(got.rows):
        return f"rows: program {len(got.rows)}, reference {len(want.rows)}"
    for a, b in zip(want.aggregate + [None] * len(got.aggregate),
                    got.aggregate + [None] * len(want.aggregate)):
        if a != b:
            return f"aggregate line: program {b!r}, reference {a!r}"
    if want.csv != got.csv:
        return "csv bytes differ"
    if subsets_differing(want, got):
        return f"subsets: program {got.subsets}, reference {want.subsets}"
    return "none"


def total(per_job: List[Dict[str, int]]) -> Dict[str, int]:
    return {name: sum(j[name] for j in per_job) for name in CHECKS}


def verdict(counts: Dict[str, int]) -> bool:
    return all(counts[name] <= limit for name, (_, limit) in CHECKS.items())


def lines(counts: Dict[str, int]) -> List[str]:
    """One line a number: its name, reading and limit."""
    return [f"check {name} {counts[name]} limit {limit}"
            for name, (_, limit) in CHECKS.items()]
