"""The port's one span-and-counter recorder, and the optional trace of a run.

The reference's only instrumentation is a wall-clock line and timestamped
prints (main.py:316,340-342; SURVEY.md §5).  Here the run is cut into named
spans (a name, a start and an end on `time.perf_counter`, and the span open
around it) and counters, kept in one StageTimers a job:

  - per-name totals (seconds, calls) and counters are always kept; a span
    costs two clock reads and a dict update;
  - while a torch.profiler runs (`torch.autograd._profiler_enabled()`),
    each span also opens `record_function("stage.<name>")`, so the spans
    share the device trace's clock, and is kept as a Span record.  With no
    profiler running no `record_function` is entered.

Spans are opened on the thread that drives the device; counters may be
added from any thread (the readers count on theirs).  `trace_context` wraps
a region in a torch.profiler trace: the CLI's whole job (--traceDir)."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

# The stages of the `stages:` line (portbench's stage shares read it)
STAGES = ("step1", "step2", "subset")


class Span:
    """One span recorded while a profiler ran: name, start and end
    (`time.perf_counter` seconds), and the span open around it (None at
    the top)."""

    __slots__ = ("name", "start", "end", "parent")

    def __init__(self, name: str, start: float, parent: Optional["Span"]):
        self.name = name
        self.start = start
        self.end = start
        self.parent = parent


class StageTimers:
    """Span totals, counters and, under a profiler, span records."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, float] = defaultdict(int)
        self.records: List[Span] = []
        self._open: List[Span] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a region under `name`."""
        if not torch.autograd._profiler_enabled():
            t = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1
            return
        with torch.autograd.profiler.record_function(f"stage.{name}"):
            rec = Span(name, time.perf_counter(), self._open[-1] if self._open else None)
            self._open.append(rec)
            try:
                yield
            finally:
                rec.end = time.perf_counter()
                self._open.pop()
                self.records.append(rec)
                self.seconds[name] += rec.end - rec.start
                self.calls[name] += 1

    def stage(self, name: str):
        """One of the three stages of the `stages:` line (STAGES)."""
        return self.span(name)

    def add(self, name: str, value=1) -> None:
        with self._lock:
            self.counters[name] += value

    def summary(self) -> str:
        """The `stages:` line: the three stages, the wall since the
        recorder was made, and the input's reads and bases over it."""
        total = time.perf_counter() - self._t0
        parts = [
            f"{name}={self.seconds[name]:.2f}s/{self.calls[name]}x"
            for name in STAGES if name in self.calls
        ]
        reads, bases = self.counters.get("reads.in", 0), self.counters.get("bases.in", 0)
        tp = ""
        if bases:
            tp = (f"; {reads} reads, {bases/1e6:.1f} Mbp, "
                  f"{bases/total/1e6:.1f} Mbp/s")
        return f"stages: {', '.join(parts)}; wall {total:.2f}s{tp}"

    def spans_line(self) -> str:
        """`spans: <name>=<s>s/<n>x, ...`, every span by name."""
        return "spans: " + ", ".join(
            f"{name}={self.seconds[name]:.3f}s/{self.calls[name]}x"
            for name in sorted(self.calls))

    def counters_line(self) -> str:
        """`counters: <name>=<value>, ...`, seconds to 6 decimals (a block
        handed back from memory takes well under a millisecond)."""
        return "counters: " + ", ".join(
            f"{name}={v:.6f}" if isinstance(v, float) else f"{name}={v}"
            for name, v in sorted(self.counters.items()))


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
