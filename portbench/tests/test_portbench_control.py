"""The comparison fails what it must: the control (the reference one
precision down, float32 for the configuration's float64) on every cell,
and a run of the harness with the timed path broken underneath (the
harness's look for a card skipped by --smoke): an answer altered where it
is produced, half of each step-2 batch left out, a step-1 answer altered."""

import contextlib
import io

import numpy as np
import pytest

from portbench import control, run as harness

CELLS = ["athal_ont_k5.telo_rich", "athal_ont_k5.wgs"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    counts = control.readings(workload, seed=2**32 + 3, smoke=True, device="cpu")
    assert counts["step1_differ"] > 0


def _telo_altered(pipeline):
    orig = pipeline.TorchEngine._step2_batches

    def step2(self, passers, model, timers=None):
        for group, bounds, extras in orig(self, passers, model, timers):
            yield group, [bounds[0] + self.cfg.slide_value()] + bounds[1:], extras
    return step2


def _half_left_out(pipeline):
    orig = pipeline.TorchEngine._step2_batches

    def step2(self, passers, model, timers=None):
        for group, bounds, extras in orig(self, passers, model, timers):
            h = max(1, len(group) // 2)
            yield group[:h], bounds[:h], extras
    return step2


def _trc_altered(pipeline):
    orig = pipeline.TorchEngine._select_hits

    def select(self, counts, cutoff):
        keep, sel, fwd, trc = orig(self, counts, cutoff)
        return keep, sel, fwd, np.where(keep, trc * (1 + 1e-12), trc)
    return select


FAULTS = {"telo_altered": ("_step2_batches", _telo_altered),
          "half_left_out": ("_step2_batches", _half_left_out),
          "trc_altered": ("_select_hits", _trc_altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, tmp_path, fault):
    """The measured process's part of a run, in this process (the inputs
    made first, as the command makes them)."""
    from topsicle_tpu_torch import pipeline

    attr, make = FAULTS[fault]
    monkeypatch.setattr(pipeline.TorchEngine, attr, make(pipeline))
    argv = ["--workload", "athal_ont_k5.telo_rich", "--seed", "9", "--seconds", "0",
            "--trace", "0", "--smoke"]
    _, cfg_path, mix_path, _, _ = harness.find_cell(argv[1])
    harness.make_inputs(cfg_path, mix_path, 9, tmp_path, smoke=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(argv + ["--inputs", str(tmp_path)])
    assert rc == 0
    assert '"correct": false' in out.getvalue().strip().splitlines()[-1]
