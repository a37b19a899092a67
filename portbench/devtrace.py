"""Reduction of a torch.profiler trace (its Chrome-trace JSON) of the
measured window to device time: the union of kernel and copy intervals on
the card, kernel time by name and by step (portbench/kernels.json), and
the card's idle gaps named by the host span open during them.

The harness marks the window with a `portbench.window` annotation, each
job with `portbench.job`, and each of the program's stage timers with
`stage.<name>`, so every gap can be named by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW = "portbench.window"
# gaps shorter than this are counted, but not named one by one
NAMED_GAP_US = 20.0


def kernel_name(name: str) -> str:
    """A kernel's function name without return type, template arguments and
    parameters: "void (anonymous namespace)::sum_kernel<true>(unsigned char const*,
    ...)" -> "sum_kernel"."""
    name = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, 1)[0].split("::")[-1].strip()


class Trace:
    def __init__(self, path: str, step_of: Dict[str, str]):
        with open(path) as fh:
            events = json.load(fh)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        self.t0 = float(win[0]["ts"]) if win else None
        self.t1 = float(win[0]["ts"]) + float(win[0]["dur"]) if win else None
        self.device = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""), e["cat"])
             for e in xs if e.get("cat") in DEVICE_CATS), key=lambda x: x[0])
        if self.t0 is not None:
            self.device = [d for d in self.device if d[1] > self.t0 and d[0] < self.t1]
        self.host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                            for e in xs if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
                           key=lambda x: x[0])
        self.annotations = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in xs if e.get("cat") == "user_annotation" and e.get("name") != WINDOW),
            key=lambda x: x[0])
        self.step_of = step_of

    def has_device_time(self) -> bool:
        return bool(self.device)

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel or copy ran (union)."""
        total, end = 0.0, None
        for a, b, _, _ in self.device:
            if self.t0 is not None:
                a, b = max(a, self.t0), min(b, self.t1)
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e6

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation (kernels by function name)."""
        out: Dict[str, float] = defaultdict(float)
        for a, b, name, cat in self.device:
            out[kernel_name(name) if cat == "kernel" else name] += (b - a) / 1e6
        return dict(out)

    def step_s(self, step: str) -> float:
        """Device seconds of the kernels that do `step`'s work."""
        return sum(s for n, s in self.by_name().items() if self.step_of.get(n) == step)

    def _host_at(self, t: float) -> str:
        """The innermost host span open at time t (the latest-starting one
        that has not ended)."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for a, b, name in reversed(self.host[max(0, i - 256):i]):
            if b >= t:
                return name
        i = bisect.bisect_right(self.annotations, (t, float("inf"), ""))
        for a, b, name in reversed(self.annotations[:i]):
            if b >= t:
                return name
        return "host (no span)"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[[host span, idle seconds]]: the window's idle time on the card,
        by the host span open in the middle of each gap, largest first."""
        if self.t0 is None:
            return []
        out: Dict[str, float] = defaultdict(float)
        cur = self.t0
        for a, b, _, _ in self.device + [(self.t1, self.t1, "", "")]:
            if a > cur:
                gap = a - cur
                name = self._host_at((a + cur) / 2) if gap >= NAMED_GAP_US else \
                    f"gaps under {NAMED_GAP_US:g} us"
                out[name] += gap / 1e6
            cur = max(cur, b)
        return [[n, s] for n, s in sorted(out.items(), key=lambda x: -x[1])[:top]]

    def device_ops(self, top: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(self.by_name().items(), key=lambda x: -x[1])[:top]]


def load(path: str, kernels_json: str) -> Trace:
    with open(kernels_json) as fh:
        step_of = json.load(fh)["kernels"]
    return Trace(path, step_of)
