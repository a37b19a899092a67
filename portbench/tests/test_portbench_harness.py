"""The harness end to end: the last line's schema in the CPU --smoke mode
(no device metric), the measuring path's refusal without a card, its
refusal in a directory that holds only the benchmark, and a short run of a
cell on the card (marked cuda)."""

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


@pytest.mark.parametrize("trace", [0, 1])
def test_smoke_line_schema(trace):
    p = run("--workload", CELL, "--seed", str(2**33 + 1), "--seconds", "1", "--trace",
            str(trace), "--smoke")
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
