"""Pure-Python oracle: the reference semantics (SURVEY.md §8) with no
accelerator and no third-party algorithm deps (stdlib + numpy only).

Used as (a) the property-test oracle for the device path on arbitrary
inputs, and (b) a CPU-runnable engine in its own right (BASELINE.json
config 1)."""

from topsicle_tpu_torch.oracle.reference import (  # noqa: F401
    OracleEngine,
    binseg_l2_single,
    boundary_detect,
    count_nonoverlapping,
    step1_trc,
    window_signal,
)
