"""Per-stage timers and throughput counters.

The reference's only instrumentation is a wall-clock line and timestamped
prints (main.py:316,340-342; SURVEY.md §5).  Here every engine stage is
timed, read/bp counters accumulate, and `torch.profiler` traces can wrap
a run for kernel-level analysis."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimers:
    """Accumulating wall-clock timers plus read/bp counters."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.reads = 0
        self.bases = 0
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t = time.time()
        try:
            yield
        finally:
            self.seconds[name] += time.time() - t
            self.calls[name] += 1

    def count(self, reads: int = 0, bases: int = 0) -> None:
        self.reads += reads
        self.bases += bases

    def summary(self) -> str:
        total = time.time() - self._t0
        parts = [
            f"{name}={self.seconds[name]:.2f}s/{self.calls[name]}x"
            for name in sorted(self.seconds)
        ]
        tp = ""
        if self.bases:
            tp = (f"; {self.reads} reads, {self.bases/1e6:.1f} Mbp, "
                  f"{self.bases/total/1e6:.1f} Mbp/s")
        return f"stages: {', '.join(parts)}; wall {total:.2f}s{tp}"


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str], cuda: bool = False) -> Iterator[None]:
    """Optional torch.profiler trace around a region (CPU and, with
    `cuda`, CUDA activity), written as <trace_dir>/trace.json; a no-op
    when dir is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
