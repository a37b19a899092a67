"""Where the port keeps what it compiles.

Counterpart of topsicle_tpu/utils/compile_cache.py, which points JAX's
persistent compilation cache at a directory.  The port compiles two
native libraries at first use: the CUDA kernels (ops/cuda_kernels.py,
named by a hash of their sources and flags) and the C++ reader
(native/loader.py).  Both go to one directory: TOPSICLE_COMPILE_CACHE
when it is set, else the package's own _build/.  On a read-only install
(a shared site-packages) set it to a writable volume and run
`topsicle-torch --precompile` there once; every later process loads both
libraries without building.  The directory is read when those modules
are imported.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "TOPSICLE_COMPILE_CACHE"
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


class CacheDirError(RuntimeError):
    """The compile cache cannot be written: nothing is built elsewhere."""


def default_cache_dir() -> Path:
    """TOPSICLE_COMPILE_CACHE when it is set, else the package's _build/."""
    env = os.environ.get(ENV)
    return Path(env) if env else PACKAGE_BUILD_DIR


def writable_dir(path: str | Path) -> Path:
    """`path`, created if missing; a CacheDirError naming it and
    TOPSICLE_COMPILE_CACHE when it cannot be created or written."""
    path = Path(path)
    try:
        path.mkdir(parents=True, exist_ok=True)
        probe = path / f".write-probe.{os.getpid()}"
        probe.touch()
        probe.unlink()
    except OSError as e:
        raise CacheDirError(
            f"cannot write the compile cache {path} ({e}); set {ENV} to a writable "
            "directory, or run `topsicle-torch --precompile` once where it is "
            "writable") from e
    return path
