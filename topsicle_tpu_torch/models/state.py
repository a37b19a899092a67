"""Carry a JAX model's state into the torch port.

`TorchScanModel(**state_from_jax(jax_model), device=...)` scans with the
same k-mer table (as numpy), k, window geometry, changepoint candidates
and step-2 kernel choice (the JAX model's `pallas_kind`: None, "sum" or
"greedy") as the TelomereScanModel it came from, so tests can hold the
two against each other from one state.  Reads attributes only: nothing
here imports jax.
"""

from __future__ import annotations

import numpy as np


def state_from_jax(model) -> dict:
    """A topsicle_tpu TelomereScanModel -> TorchScanModel keyword args."""
    return {
        "kmers": list(model.kmers),
        "table": np.asarray(model.table, dtype=np.int32),
        "k": int(model.k),
        "window_size": int(model.window_size),
        "slide": int(model.slide),
        "jump": int(model.jump),
        "min_size": int(model.min_size),
        "kernel": model.pallas_kind,
    }
