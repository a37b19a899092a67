"""The program's own spans and counters of each job: the `spans:` and
`counters:` lines that topsicle_tpu_torch.cli.main writes to the run log
after the closing line (topsicle_tpu_torch/utils/profiling.py).

A job's phases are disjoint and lie inside its `job` span; the per-layer
readers (metrics/span_share.*.py and the counter ratios) take them over
the harness's job walls, as the stage shares do.  A run log without the
two lines (a program that predates them) gives nothing, so the readers
report nothing."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

PHASES = ("setup", "model", "reader_wait", "step1", "step2", "rows", "subset", "emit",
          "aggregate")


def lines_of(run_log: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """({span: seconds}, {counter: value}) from a run log's last `spans:`
    and `counters:` lines; empty dicts where it has none."""
    spans: Dict[str, float] = {}
    counters: Dict[str, float] = {}
    if not os.path.exists(run_log):
        return spans, counters
    with open(run_log) as fh:
        for ln in fh:
            for tag, out in (("] spans: ", spans), ("] counters: ", counters)):
                if tag not in ln:
                    continue
                out.clear()
                for part in ln.split(tag, 1)[1].strip().split(", "):
                    name, _, value = part.partition("=")
                    if value:
                        out[name] = float(value.split("s/", 1)[0])
    return spans, counters


def jobs(ctx) -> Optional[List[tuple]]:
    """[(wall s, spans, counters)] of every finished job of the window, or
    None where a job's log lacks the lines."""
    out = []
    for j in ctx.jobs:
        spans, counters = lines_of(os.path.join(str(j["out"]), "topsicle_run.log"))
        if not spans or not counters:
            return None
        out.append((j["wall_s"], spans, counters))
    return out or None


def span_share(ctx, names: Sequence[str]) -> Optional[float]:
    """The seconds of the spans `names` over the jobs' walls, in %."""
    got = jobs(ctx)
    if got is None:
        return None
    walls = sum(w for w, _, _ in got)
    return 100.0 * sum(s.get(n, 0.0) for _, s, _ in got for n in names) / walls if walls \
        else None


def ratio(ctx, num: Tuple[str, str], den: Tuple[str, str],
          scale: float = 100.0) -> Optional[float]:
    """scale × the sum of one line's value over the sum of another's, over
    the jobs; a key is ("spans" or "counters", name)."""
    got = jobs(ctx)
    if got is None:
        return None

    def total(key):
        line, name = key
        return sum((s if line == "spans" else c).get(name, 0.0) for _, s, c in got)

    d = total(den)
    return scale * total(num) / d if d > 0 else None
