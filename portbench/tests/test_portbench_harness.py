"""The harness end to end: the last line's schema in the CPU --smoke mode
(no device metric), set-up timed from the measured process's start after
the inputs are made, the measuring path's refusal without a card, its
refusal in a directory that holds only the benchmark, and a short run of
a cell on the card (marked cuda)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "athal_ont_k5.wgs"
E2E = {"mbp_per_s": "Mbp/s", "peak_rss_mb": "MB", "setup_s": "s"}
DEVICE_METRICS = {"step1_roofline", "step2_roofline", "device_idle_share"}


def run(*args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def tagged(out, tag):
    pre = f"[portbench] {tag} "
    return json.loads([ln for ln in out.splitlines() if ln.startswith(pre)][-1][len(pre):])


@pytest.fixture(scope="module")
def smoke_runs():
    """One --smoke run of the command a trace setting, made once."""
    return {trace: run("--workload", CELL, "--seed", str(2**33 + 1), "--seconds", "1",
                       "--trace", str(trace), "--smoke") for trace in (0, 1)}


@pytest.mark.parametrize("trace", [0, 1])
def test_smoke_line_schema(smoke_runs, trace):
    p = smoke_runs[trace]
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert c == {"value": 0, "limit": 0}, name
        assert f"check {name} 0 limit 0" in p.stderr
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    got = res["metrics"]
    if trace == 0:
        assert {n: m["unit"] for n, m in got.items()} == E2E
        assert all(m["value"] > 0 for m in got.values())
    else:
        assert not set(got) & DEVICE_METRICS
        assert {"start.import_s", "stage_share.subset", "host_cpu_per_wall"} <= set(got)
        assert "busy_s" not in res["device"]


def test_setup_s_counts_from_after_the_inputs(smoke_runs):
    """The measured process starts once the inputs are made, and setup_s
    is timed from its start: no input generator runs inside it."""
    out = smoke_runs[0].stdout
    inputs, split = tagged(out, "inputs"), tagged(out, "set-up split")
    assert inputs["made_s"] > 0
    # /proc/<pid>/stat's start time is in clock ticks (10 ms)
    assert split["started_at"] >= inputs["done_at"] - 0.02
    assert not {"input_wait_s", "warmup_input_wait_s", "inputs_ready_after_s"} & set(split)
    setup_s = json.loads(out.strip().splitlines()[-1])["metrics"]["setup_s"]["value"]
    assert setup_s == split["setup_s"] >= split["import_torch_s"] + split["warmup_job_s"]


def test_last_job_subsets_are_compared(smoke_runs):
    """The last job's subset files are kept and compared; the jobs line
    says which were, and what the deletes cost inside the window."""
    for p in smoke_runs.values():
        jobs = tagged(p.stdout, "jobs")
        assert jobs["n"] - 1 in jobs["subsets_compared"]
        assert jobs["subset_mb_deleted"] >= 0 and jobs["cleanup_s"] >= 0


def test_deleted_subsets_are_compared_by_name(tmp_path):
    """A job's subset files go, and nothing else of its outputs; the check
    then holds their names to the reference's and no bytes."""
    from portbench import check, run as harness
    from portbench.reference.topsicle_ref import Outputs

    names = ["sample0_trc_over_0.7.fastq", "sample1_trc_over_0.7.fastq"]
    for n in names + ["telolengths_all.csv", "topsicle_run.log"]:
        (tmp_path / n).write_bytes(b"x" * 10)
    assert harness.drop_subsets(tmp_path) == (names, 20)
    assert sorted(q.name for q in tmp_path.iterdir()) == ["telolengths_all.csv",
                                                          "topsicle_run.log"]
    want = Outputs([], b"", {names[0]: "a", names[1]: "b"}, [])

    def differ(subsets):
        return check.compare(want, Outputs([], b"", subsets, []))["subset_differ"]
    assert differ({names[0]: None, names[1]: None}) == 0
    assert differ({names[0]: None}) == 1
    assert differ({names[0]: None, names[1]: "c"}) == 1
    assert differ({names[0]: None, names[1]: None, "extra_trc_over_0.7.fastq": None}) == 1
    assert differ({names[0]: "a", names[1]: "b"}) == 0


def test_measuring_path_needs_a_card(cuda_card_absent):
    p = run("--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert not p.stdout.strip() or not p.stdout.strip().splitlines()[-1].startswith("{")
    assert "CUDA card" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = run("--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0", "--smoke",
            cwd=tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip() or not p.stdout.strip().splitlines()[-1].startswith("{")


@pytest.fixture
def cuda_card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card):
    p = run("--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1",
            timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert DEVICE_METRICS <= set(res["metrics"])
    assert all(0 < res["metrics"][n]["value"] <= 100 for n in DEVICE_METRICS)
