"""Peaks of one NVIDIA H100 SXM and the work the port's kernels need, frozen
from chip_smoke.py's `_bound` and its per-entry counts.

The work is counted from the reference's own results on the cell's inputs
(portbench/reference/topsicle_ref.py, `Job.work`): only the reads a step
scans, never a batch's padding rows.  Bytes: each input byte once at two
bits a base, each output once.  Operations: the 32-bit integer operations
the computation needs, whatever a kernel's body spends:

- step 1, per end of every read longer than minSeqLength: a position
  whose k-mer lies inside the end 4 + K (its code and validity, one match
  bit an entry); every count 2; every match a self-overlapping entry's
  chain takes 4;
- step 2 on a table with no self-overlapping entry and at most 31
  entries (the sum body): a position inside the scanned span 8, a group of
  `slide` positions 3, a window 4; on any other table (the greedy body): a
  position 4 + K, a (window, entry) 4, a window 1, a match a
  self-overlapping entry's chain takes 4;
- the changepoint behind step 2: a window 2, an admissible candidate 40.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# 132 SMs x 64 INT32 lanes x 1.98 GHz: a quarter of the data sheet's 67
# TFLOP/s of float32 (128 lanes, a fused multiply-add counted as two)
INT32_OPS_PER_S = 67e12 / 4
NO_BP = 1000
SUM_MAX_K = 31


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its INT32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def step1(w: dict) -> tuple[float, float]:
    """(bytes, operations) of step 1 for one phrase's work `w`."""
    k, K, reads = w["k"], w["K"], w["step1_reads"]
    positions = 2 * reads * (NO_BP - k + 1)
    counts = 2 * reads * K
    return (2 * reads * NO_BP / 4 + 4 * counts,
            (4 + K) * positions + 2 * counts + 4 * w["step1_takes"])


def step2(w: dict) -> tuple[float, float]:
    """(bytes, operations) of step 2 and its changepoint for one phrase."""
    K, pos, windows = w["K"], w["step2_positions"], w["step2_windows"]
    if w["self_overlapping"] == 0 and K <= SUM_MAX_K:
        ops = 8 * pos + 3 * w["step2_groups"] + 4 * windows
    else:
        ops = (4 + K) * pos + 4 * K * windows + windows + 4 * w["step2_takes"]
    ops += 2 * windows + 40 * w["step2_candidates"]
    return w["step2_bases"] / 4 + 13 * w["step2_reads"], ops


def bound_of_job(work: dict, step: str) -> float:
    """Seconds the card needs at least for one job's `step`, summed over
    its phrases (each phrase launches its own kernels)."""
    fn = {"step1": step1, "step2": step2}[step]
    return sum(bound_s(*fn(w)) for w in work.values())
