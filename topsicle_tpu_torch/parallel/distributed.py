"""Multi-host run orchestration.

The reference scales across nodes by hand: split inputs into ~1 GB
files and submit one SLURM job each (README.md:261-270, col_0_test.sh).
Here the same sharding is automatic and deterministic:

- every process (host) runs the same CLI; the torch.distributed process
  group (or the explicit process_id/process_count overrides) tells it
  who it is;
- input files are dealt round-robin (files[pid::n]); each (phrase,
  file) unit's CSV rows and full-precision aggregates go to a part
  file under {outputDir}/.parts/;
- after a cross-host barrier, process 0 merges parts in (phrase,
  file-index) order, byte-identical to a single-host run's CSV, and
  computes the aggregate/quadfit lines from the full-precision
  sidecars.

Single-process runs never touch this path.
"""

from __future__ import annotations

import csv
import datetime
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

# The end-of-run barrier waits for the slowest process's whole share of
# the input, so it gets wait_all's day, not a collective's minutes.
BARRIER_TIMEOUT = datetime.timedelta(days=1)


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_identity(process_id: Optional[int], process_count: Optional[int]
                     ) -> Tuple[int, int]:
    """Explicit overrides win; else the process group's rank and size."""
    if process_count is not None:
        return int(process_id or 0), int(process_count)
    return world()


def my_files(files: List[str], pid: int, n: int) -> List[Tuple[int, str]]:
    """Round-robin deal, keeping the global file index for ordering."""
    return [(i, f) for i, f in enumerate(files) if i % n == pid]


def parts_dir(output_dir: str) -> str:
    d = os.path.join(output_dir, ".parts")
    os.makedirs(d, exist_ok=True)
    return d


def part_paths(output_dir: str, phrase: int, file_idx: int) -> Tuple[str, str]:
    base = os.path.join(parts_dir(output_dir), f"{phrase:04d}_{file_idx:06d}")
    return base + ".rows.csv", base + ".agg.json"


def write_part(output_dir: str, phrase: int, file_idx: int,
               rows: List[list], trc: List[float], telo: List[float]) -> None:
    rows_path, agg_path = part_paths(output_dir, phrase, file_idx)
    with open(rows_path, "w", newline="") as fh:
        w = csv.writer(fh)
        for r in rows:
            w.writerow(r)
    with open(agg_path, "w") as fh:
        json.dump({"phrase": phrase, "trc": trc, "telo": telo}, fh)


def barrier() -> None:
    """Wait for every process of the group; a no-op without one (explicit
    --processId runs use the file-based markers below, mark_done/wait_all,
    so plain concurrent processes need no shared runtime)."""
    if world()[1] > 1:
        dist.monitored_barrier(timeout=BARRIER_TIMEOUT)


def reset_mine(output_dir: str, pid: int, n: int) -> None:
    """Startup hygiene for explicitly-coordinated runs: each process
    removes ITS OWN stale done-marker and part files (file_idx % n ==
    pid) left by a crashed earlier run.  Ownership-scoped so concurrent
    fresh processes can never delete each other's new output; strays
    from runs with a different process count are excluded from the merge
    by the done-manifests and wiped by cleanup_parts."""
    d = parts_dir(output_dir)
    marker = os.path.join(d, f"done.{pid:04d}")
    if os.path.exists(marker):
        os.remove(marker)
    for rows_path in glob.glob(os.path.join(d, "*.rows.csv")):
        base = os.path.basename(rows_path)
        try:
            file_idx = int(base.split("_")[1].split(".")[0])
        except (IndexError, ValueError):
            continue
        if file_idx % n == pid:
            os.remove(rows_path)
            agg = rows_path.replace(".rows.csv", ".agg.json")
            if os.path.exists(agg):
                os.remove(agg)


def _owned_parts(d: str, pid: int, n: int) -> List[str]:
    out = []
    for rows_path in glob.glob(os.path.join(d, "*.rows.csv")):
        base = os.path.basename(rows_path)
        try:
            file_idx = int(base.split("_")[1].split(".")[0])
        except (IndexError, ValueError):
            continue
        if file_idx % n == pid:
            out.append(base)
    return sorted(out)


def mark_done(output_dir: str, pid: int, n: int) -> None:
    """Signal that this process has written all its part files.  The
    marker lists this process's OWN parts (a manifest), so the merge
    consumes exactly this run's parts and ignores strays from dead
    runs.  It lives in .parts/ so cleanup_parts removes it with the
    rest."""
    d = parts_dir(output_dir)
    with open(os.path.join(d, f"done.{pid:04d}"), "w") as fh:
        json.dump({"pid": pid, "parts": _owned_parts(d, pid, n)}, fh)


def wait_all(output_dir: str, n: int, timeout_s: float = 86400.0,
             poll_s: float = 0.2) -> List[str]:
    """Process 0 blocks until done-markers 0..n-1 all exist (the
    merge-safety barrier for plain-OS-process runs: without it, merge
    could race workers still writing parts).  Returns the union of the
    markers' part manifests."""
    import time

    deadline = time.monotonic() + timeout_s
    d = parts_dir(output_dir)
    while True:
        missing = [p for p in range(n)
                   if not os.path.exists(os.path.join(d, f"done.{p:04d}"))]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed merge: processes {missing} did not finish "
                f"within {timeout_s:.0f}s"
            )
        time.sleep(poll_s)
    parts: List[str] = []
    for p in range(n):
        with open(os.path.join(d, f"done.{p:04d}")) as fh:
            manifest = json.load(fh)
        parts.extend(manifest.get("parts", []))
    return sorted(parts)


def merge(output_dir: str, csv_path: str,
          parts: Optional[List[str]] = None
          ) -> Tuple[Dict[int, List[float]], Dict[int, List[float]]]:
    """Process-0 merge: concatenate part rows in (phrase, file-index)
    order onto the already-written CSV header; return the
    full-precision per-phrase aggregate lists.  `parts` (basenames from
    the done-manifests) restricts the merge to this run's files;
    without it every *.rows.csv in .parts/ is taken."""
    phrase_to_trc: Dict[int, List[float]] = {}
    phrase_to_telo: Dict[int, List[float]] = {}
    d = parts_dir(output_dir)
    if parts is None:
        paths = sorted(glob.glob(os.path.join(d, "*.rows.csv")))
    else:
        paths = [os.path.join(d, p) for p in sorted(set(parts))]
    with open(csv_path, "a", newline="") as out:
        w = csv.writer(out)
        for rows_path in paths:
            with open(rows_path, newline="") as fh:
                for row in csv.reader(fh):
                    w.writerow(row)
            agg_path = rows_path.replace(".rows.csv", ".agg.json")
            with open(agg_path) as fh:
                agg = json.load(fh)
            ph = int(agg["phrase"])
            phrase_to_trc.setdefault(ph, []).extend(agg["trc"])
            phrase_to_telo.setdefault(ph, []).extend(agg["telo"])
    return phrase_to_trc, phrase_to_telo


def cleanup_parts(output_dir: str) -> None:
    d = os.path.join(output_dir, ".parts")
    if os.path.isdir(d):
        for f in glob.glob(os.path.join(d, "*")):
            os.remove(f)
        os.rmdir(d)
