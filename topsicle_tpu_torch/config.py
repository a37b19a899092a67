"""Typed run configuration.

One dataclass holds every knob of the reference CLI (the 15 argparse flags
at the reference tool's main.py:319-334) plus the TPU-runtime section
(mesh shape, batch sizes, bucketing) that the reference has no analog for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


@dataclasses.dataclass
class TopsicleConfig:
    """Analysis parameters (reference-compatible) + TPU runtime section.

    Defaults mirror the reference tool's main.py:319-334.
    """

    # --- required ---
    input_dir: str = ""
    output_dir: str = ""
    pattern: str = ""

    # --- analysis flags (reference parity) ---
    min_seq_length: int = 9000           # --minSeqLength
    rawcountpattern: bool = False        # --rawcountpattern
    telophrase: Optional[Sequence[int]] = None   # --telophrase (list of k)
    cutoff: Union[float, Sequence[float]] = 0.7  # --cutoff (scalar or list)
    window_size: int = 100               # --windowSize
    slide: Optional[int] = None          # --slide (default: len(pattern))
    trimfirst: int = 100                 # --trimfirst
    maxlengthtelo: int = 20000           # --maxlengthtelo
    plot: bool = False                   # --plot
    rangecp: Optional[int] = None        # --rangecp
    read_check: Optional[str] = None     # --read_check
    override: bool = False               # --override
    threads: Optional[int] = None        # --threads (host-side workers)

    # Step-1 end-window width; hard-coded to 1000 by the reference
    # (main.py:57 `no_bp=1000`).
    no_bp: int = 1000

    # --- TPU runtime section (no reference analog) ---
    batch_size: int = 128        # reads per device step (global, pre-shard)
    length_bucket_quantum: int = 512   # scan lengths rounded up to this
    # Step-2 scan length: "static" compiles ONE device program with
    # L = maxlengthtelo - trimfirst (rounded to the quantum) and pads
    # every batch to it; "bucket" pads each batch to its own rounded max
    # length (smaller transfers, but one device-program compile per
    # bucket — remote TPU compile services charge seconds..minutes per
    # new program, which dominated end-to-end time in round 1).
    scan_length_mode: str = "static"
    engine: str = "jax"          # "jax" (device path) or "oracle" (pure CPU)
    # step-2 compute path: None => auto (the XLA kernels); True/"greedy"
    # => the fused greedy Pallas kernel; "sum" => the round-5 scan-free
    # sum-signal Pallas kernel (aperiodic tables; falls back to greedy
    # otherwise) — models.telomere.resolve_pallas_kind has the numbers
    use_pallas: Optional[object] = None
    native_io: Optional[bool] = None   # None => auto (C++ loader if built)
    resume: bool = False         # skip (file, phrase) units completed per manifest
    trace_dir: Optional[str] = None    # --traceDir: cli.main's torch.profiler trace
    # multi-host: None => from jax.distributed (1 process unless
    # initialized); explicit values shard input files round-robin
    process_id: Optional[int] = None
    process_count: Optional[int] = None
    # "files": each process computes its own files on its own chips and
    # process 0 merges part files (works with plain OS processes).
    # "global": one global batch sharded over EVERY chip of every host
    # via GSPMD (requires jax.distributed; balances compute when input
    # files are skewed across hosts).
    shard_mode: str = "files"

    # ------------------------------------------------------------------
    # Derived values — the defaulting rules of the reference orchestrator.
    # ------------------------------------------------------------------
    def telophrases(self) -> List[int]:
        """k values to sweep; default [len(pattern)-2] (main.py:189-193)."""
        ks = _as_list(self.telophrase)
        if not ks:
            return [len(self.pattern) - 2]
        return [int(k) for k in ks]

    def slide_value(self) -> int:
        """Window step; defaults to len(pattern) (main.py:212-215)."""
        # NB: the reference uses truthiness (`if args.slide:`), so slide=0
        # also falls back to len(pattern).  Replicated.
        return int(self.slide) if self.slide else len(self.pattern)

    def threads_value(self) -> int:
        """Host parse/encode worker count: up to this many input files
        are read/encoded concurrently (each on its own bounded reader
        thread), the current file plus N-1 ahead.  Default resolves like
        the reference's core count (sched_getaffinity -> cpu_count,
        main.py:168-177); 1 = fully serial, no cross-file read-ahead."""
        if self.threads:
            return max(1, int(self.threads))
        try:
            return max(1, len(os.sched_getaffinity(0)))
        except (AttributeError, OSError):
            return max(1, os.cpu_count() or 1)

    def min_cutoff(self) -> float:
        """Step-1 filter threshold: min of the cutoff list (main.py:56)."""
        cs = _as_list(self.cutoff)
        return float(min(cs)) if cs else 0.7

    def input_trc(self) -> float:
        """Quadratic-fit anchor: first element of cutoff (main.py:254-257)."""
        cs = _as_list(self.cutoff)
        return float(cs[0]) if cs else 0.7

    def static_scan_length(self) -> Optional[int]:
        """The single padded step-2 scan length in "static" mode (None in
        "bucket" mode).  Tail slices are seq[trimfirst:min(maxlengthtelo,
        len)], so maxlengthtelo - trimfirst always covers them."""
        if self.scan_length_mode != "static":
            return None
        q = self.length_bucket_quantum
        span = max(1, self.maxlengthtelo - self.trimfirst)
        return max(q, -(-span // q) * q)

    def input_paths(self) -> List[str]:
        """Input file discovery: os.walk order, or the single file
        (main.py:224-229)."""
        if os.path.isdir(self.input_dir):
            out: List[str] = []
            for root, _dirs, files in os.walk(self.input_dir):
                for name in files:
                    out.append(os.path.join(root, name))
            return out
        return [self.input_dir]

    def validate(self) -> None:
        if not self.pattern:
            raise ValueError("pattern is required")
        if self.scan_length_mode not in ("static", "bucket"):
            raise ValueError(
                f"scan_length_mode must be 'static' or 'bucket', "
                f"got {self.scan_length_mode!r}"
            )
        if "|" in self.pattern:
            # The reference's multi-pattern branch is broken (it returns a
            # single concatenated string whose *characters* are then used as
            # patterns — allsteps.py:90-102 vs 168).  We refuse clearly
            # instead of silently mis-computing (SURVEY.md §7.3).
            raise ValueError(
                "multi-pattern 'A|B' input is not supported: the reference "
                "implementation of this branch is broken; pass a single "
                "telomere repeat (e.g. CCCTAAA)"
            )
        for k in self.telophrases():
            # The reference cuts k-mers from the DOUBLED pattern
            # (allsteps.py:66-76), so k may exceed len(pattern) — up to
            # 2*len, beyond which no substrings exist and the reference
            # would crash on an empty table.
            if k > 2 * len(self.pattern):
                raise ValueError(
                    f"Cannot get {k}-bp cut from the doubled "
                    f"{len(self.pattern)}-bp pattern ({2 * len(self.pattern)} bp)"
                )
            if k < 1:
                raise ValueError(f"telophrase must be >= 1, got {k}")
            if self.engine == "jax" and k > 15 and self.shard_mode == "global":
                # device rolling codes are base-4 int32
                # (ops.match.MAX_ROLLING_K).  Files mode auto-falls back
                # to the host oracle path per phrase (pipeline._model);
                # global lockstep mode has no host fallback, so refuse.
                raise ValueError(
                    f"telophrase {k} exceeds the device engine's k-mer "
                    "capacity (15); shardMode=global cannot fall back to "
                    "the host path — use shardMode=files or --engine oracle"
                )
            if k >= self.window_size:
                raise ValueError(
                    f"telophrase {k} must be smaller than windowSize "
                    f"{self.window_size} (no match fits a window otherwise)"
                )
