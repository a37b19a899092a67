"""Load a framework-free module of topsicle_tpu by its file path.

`topsicle_tpu.models` and `topsicle_tpu.parallel` import jax in their
package `__init__`, so `import topsicle_tpu.models.oracle_model` would
pull jax in.  Two modules under them need none:

    models/oracle_model.py    the host model for k past the device
                              capacity (numpy + topsicle_tpu.oracle)
    parallel/distributed.py   files mode's part files, done markers and
                              merge (stdlib; jax only inside two functions
                              the port replaces)

`load` executes such a file on its own, under a private module name, so
the package `__init__` never runs.  Loading the JAX package's file rather
than a copy keeps the oracle semantics and the part-file format one code.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from types import ModuleType

import topsicle_tpu


def load(relpath: str) -> ModuleType:
    """topsicle_tpu/<relpath> as a module named
    topsicle_tpu_torch._host.<stem>, loaded once per process."""
    name = f"{__name__}.{os.path.splitext(os.path.basename(relpath))[0]}"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(topsicle_tpu.__file__), relpath)
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]
