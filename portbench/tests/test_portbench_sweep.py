"""The human sweep's cell (human_ont_k456.wgs): its traced line in the CPU
--smoke mode, and the readers of the block cache and of the replay wait,
which give a number on a sweep's job and nothing on a one-phrase job (an
athal_ont_k5 job); on the card (marked cuda), a short traced run."""

import contextlib
import io
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "human_ont_k456.wgs"
SWEEP = ("span_share.replay_wait", "blockcache.write_share", "blockcache.mbp_per_busy_s")


def run(*args, timeout=600):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_smoke_line_has_the_sweep_metrics():
    p = run("--workload", CELL, "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "1",
            "--smoke")
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"] is True and res["failed"] == 0
    for name in SWEEP:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    assert res["metrics"]["blockcache.mbp_per_busy_s"]["value"] > 0


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One CPU job of each configuration on its --smoke wgs inputs, through
    topsicle_tpu_torch.cli.main as the harness runs it: {config: ctx}."""
    from portbench import run as bench
    from topsicle_tpu_torch import cli

    base = tmp_path_factory.mktemp("sweep")
    out = {}
    for name in ("athal_ont_k5", "human_ont_k456"):
        cfg_path = ROOT / "portbench" / "configs" / f"{name}.json"
        work = base / name
        bench.make_inputs(cfg_path, ROOT / "portbench" / "mixes" / "wgs.json", 2**33 + 7, work,
                          smoke=True)
        argv = bench.cli_argv(bench.load_json(cfg_path)["cli"], str(work / "inputs"),
                              str(work / "out"), "cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(argv) == 0

        class Ctx:
            jobs = [{"out": work / "out", "wall_s": 1.0}]
        out[name] = Ctx
    return out


@pytest.mark.parametrize("name", SWEEP)
def test_sweep_readers(jobs, name):
    from portbench import run as bench

    read = bench.load_reader(name)
    assert read(jobs["athal_ont_k5"]) is None
    v = read(jobs["human_ont_k456"])
    assert isinstance(v, float) and math.isfinite(v) and v >= 0


@pytest.mark.cuda
def test_a_short_sweep_on_the_card(cuda_card):
    p = run("--workload", CELL, "--seed", str(2**31 + 13), "--seconds", "2", "--trace", "1",
            timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
    assert all(res["metrics"][n]["value"] > 0 for n in SWEEP[1:])
    assert res["metrics"]["span_share.replay_wait"]["value"] >= 0
    assert 0 < res["metrics"]["step2_roofline"]["value"] <= 100
