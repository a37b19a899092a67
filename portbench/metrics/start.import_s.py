"""start.import_s: seconds of a run's set-up spent in `import torch`, the
CUDA context and the port's import (host clock, each step timed by the
process itself, as chip_smoke.py's `[start]` lines).  Moves setup_s."""


def read(ctx):
    s = ctx.start
    return s["import_torch_s"] + s["context_s"] + s["port_import_s"]
