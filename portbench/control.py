"""The control of the comparison that decides `correct`: the reference put
in the program's place, computed one precision below what the
configuration states (TRC and the quadratic fit in float32 where the
configuration and the upstream tool use float64), judged by check.py
against the float64 reference on the cell's own inputs.  It has to come
out not correct; PERF.md keeps its readings, from which each limit's upper
end is taken.

    python portbench/control.py --workload <cell> --seeds 1 2 3 [--smoke]

Prints one JSON line a seed with every check's count.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import check  # noqa: E402
from portbench.gen import fastq  # noqa: E402
from portbench.reference.topsicle_ref import Job  # noqa: E402
from portbench.run import find_cell, load_json  # noqa: E402


def readings(workload: str, seed: int, smoke: bool = False, device: str | None = None) -> dict:
    """Every check's count for the float32 control against the float64
    reference, on the inputs of `workload` from `seed`."""
    import torch

    cell, cfg_path, mix_path, _, _ = find_cell(workload)
    cfg, mix = load_json(cfg_path), load_json(mix_path)
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    work = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        files, n = fastq.sizes(mix, smoke)
        fastq.write_job(str(work / "in"), seed, cfg, mix, files, n)
        want = Job(cfg["cli"], str(work / "in"), device=device).run()
        got = Job(cfg["cli"], str(work / "in"), device=device, precision="float32").run()
        return check.compare(want, got)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--smoke", action="store_true")
    a = p.parse_args(argv)
    for seed in a.seeds:
        counts = readings(a.workload, seed, a.smoke)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": "float32",
                          "counts": counts, "correct": check.verdict(counts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
