"""The port's compile cache (topsicle_tpu_torch/utils/compile_cache.py),
the counterpart of topsicle_tpu/utils/compile_cache.py: with
TOPSICLE_COMPILE_CACHE set, the CUDA kernels' library and the C++ reader
are built into it, and `topsicle-torch --precompile` builds the reader
there (the kernels too, on a card); a cache that cannot be written raises
an error naming it, with no other place tried; with the variable unset
every path is the package's _build/ as before.  The paths are read when
the modules are imported, so each case runs in a child process, with jax
and the JAX package blocked."""

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from topsicle_tpu_torch.native import loader as t_loader
from topsicle_tpu_torch.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent
PKG_BUILD = REPO / "topsicle_tpu_torch" / "_build"
READER = Path(t_loader._SO).name      # _tsio-<hash of the source and flags>.so

_PATHS = (
    "import json, sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
    "from topsicle_tpu_torch.native import loader\n"
    "from topsicle_tpu_torch.ops import cuda_kernels\n"
    "from topsicle_tpu_torch.utils import compile_cache\n"
    "print(json.dumps(dict(default=str(compile_cache.default_cache_dir()),\n"
    "                      build_dir=str(cuda_kernels.BUILD_DIR),\n"
    "                      library=str(cuda_kernels.library_path()),\n"
    "                      reader_dir=loader._BUILD_DIR, reader=loader._SO)))\n")


def _child(code, cwd, cache=None, path=None):
    """Run `code` in a python child with TOPSICLE_COMPILE_CACHE set to
    `cache` (unset for None) and `path` in front of PATH; it must exit 0.
    Returns its last stdout line, parsed."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop(compile_cache.ENV, None)
    if cache is not None:
        env[compile_cache.ENV] = str(cache)
    if path is not None:
        env["PATH"] = str(path) + os.pathsep + env["PATH"]
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _fake_nvcc(tmp_path):
    """tests/test_torch_kernels.py's stand-in compiler: it notes each call
    in calls.txt and writes its output file empty."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {tmp_path / "calls.txt"}\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return nvcc.parent


def _reader_stamp():
    """The modification time of the package's own reader library (built
    first by this process where the toolchain allows), or None: a child
    that builds the reader into the package's _build/ changes it.  Other
    tests may build there at the same time, so only this file is held."""
    t_loader.native_available()
    so = PKG_BUILD / READER
    return so.stat().st_mtime_ns if so.exists() else None


def test_env_sends_both_libraries_to_the_cache(tmp_path):
    cache = tmp_path / "cache"
    got = _child(_PATHS, tmp_path, cache)
    assert got["default"] == got["build_dir"] == got["reader_dir"] == str(cache)
    assert Path(got["library"]).parent == cache
    assert Path(got["library"]).name.startswith("libtopsicle_kernels_")
    assert got["reader"] == str(cache / READER)


def test_unset_env_keeps_the_package_build_dir(tmp_path):
    got = _child(_PATHS, tmp_path)
    assert got["default"] == got["build_dir"] == got["reader_dir"] == str(PKG_BUILD)
    assert Path(got["library"]).parent == PKG_BUILD
    assert got["reader"] == str(PKG_BUILD / READER)


def test_kernel_build_lands_in_the_cache(tmp_path):
    """The fake-nvcc build of tests/test_torch_kernels.py, with the cache
    set: the library and its compiler log appear there, nothing new in
    the package's _build/; a second build finds the library."""
    cache = tmp_path / "cache"
    got = _child("import json\n"
                 "from topsicle_tpu_torch.ops import cuda_kernels\n"
                 "so = cuda_kernels.build_library()\n"
                 "again = cuda_kernels.build_library()\n"
                 "print(json.dumps(dict(so=str(so), same=so == again)))\n",
                 tmp_path, cache, _fake_nvcc(tmp_path))
    so = Path(got["so"])
    assert so.parent == cache and so.exists() and got["same"]
    assert len((tmp_path / "calls.txt").read_text().splitlines()) == 5   # 4 sources, 1 link
    assert sorted(p.name for p in cache.iterdir()) == sorted([so.name, so.stem + ".log"])
    assert not (PKG_BUILD / so.name).exists() and not (PKG_BUILD / (so.stem + ".log")).exists()


def test_reader_library_is_named_by_its_source():
    """The reader's library is named by a hash of tsio.cc, the inflate.h it
    includes and the flags: a changed source (a new ABI) gets a new name,
    so a cache never hands it a library built from another source."""
    src, header = Path(t_loader._SRC).read_bytes(), Path(t_loader._HEADER).read_bytes()
    assert b'#include "inflate.h"' in src
    assert READER == t_loader.library_name(src, header)
    assert READER.startswith("_tsio-") and READER.endswith(".so")
    changed = src.replace(b"void tsio_close(", b"void tsio_close (")
    assert changed != src and t_loader.library_name(changed, header) != READER
    assert t_loader.library_name(src + b"\n", header) != READER


def test_reader_library_is_named_by_its_inflate_header():
    """A change to inflate.h alone renames the library, so a cache that
    holds a library built from an older decoder never loads it."""
    src, header = Path(t_loader._SRC).read_bytes(), Path(t_loader._HEADER).read_bytes()
    changed = header.replace(b"constexpr size_t kFastOut = 320;", b"constexpr size_t kFastOut = 384;")
    assert changed != header
    assert t_loader.library_name(src, changed) != READER
    assert t_loader.library_name(src, header + b"\n") != READER
    # the two sources are hashed apart: moving bytes from one to the other renames it too
    assert t_loader.library_name(src + header[:1], header[1:]) != READER


def test_precompile_builds_the_reader_in_the_cache(tmp_path):
    """`topsicle-torch --precompile --device cpu` builds the C++ reader
    into the cache and logs its path; a second process loads it without
    building; neither reads the (absent) input."""
    if not t_loader.native_available():
        pytest.skip("no C++ toolchain or zlib: the native reader is unavailable")
    cache = tmp_path / "cache"
    before = _reader_stamp()
    code = ("import json, sys; sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
            "from topsicle_tpu_torch.cli import main\n"
            "rc = main(['--precompile', '--device', 'cpu', '--inputDir', 'no-input',\n"
            "           '--outputDir', sys.argv[1], '--pattern', 'CCCTAAA'])\n"
            "print(json.dumps(dict(rc=rc)))\n")
    logs = []
    for out in ("first", "second"):
        assert _child(code.replace("sys.argv[1]", repr(out)), tmp_path, cache) == {"rc": 0}
        logs.append((tmp_path / out / "topsicle_run.log").read_text())
    so = cache / READER
    assert so.exists()
    assert f"precompile: reader native C++ (native/tsio.cc), built {so}" in logs[0]
    assert f"precompile: reader native C++ (native/tsio.cc), loaded {so}" in logs[1]
    for log in logs:
        assert f"precompile: 0 kernel libraries in {cache}; ready" in log
        assert "precompile: k=5 ready on cpu" in log
    assert _reader_stamp() == before


def test_unwritable_cache_names_itself(tmp_path):
    """A cache that cannot be created (its parent is a file): the kernel
    build raises CacheDirError naming the directory and
    TOPSICLE_COMPILE_CACHE before any compiler runs, and builds nowhere
    else; the reader falls back to the Python reader and says why."""
    (tmp_path / "file").write_text("not a directory\n")
    cache = tmp_path / "file" / "cache"
    before = _reader_stamp()
    got = _child("import json\n"
                 "from topsicle_tpu_torch.native import loader\n"
                 "from topsicle_tpu_torch.ops import cuda_kernels\n"
                 "from topsicle_tpu_torch.utils import compile_cache\n"
                 "try:\n"
                 "    cuda_kernels.build_library()\n"
                 "    error = None\n"
                 "except compile_cache.CacheDirError as e:\n"
                 "    error = str(e)\n"
                 "print(json.dumps(dict(error=error, native=loader.native_available(),\n"
                 "                      status=loader.status(),\n"
                 "                      library=cuda_kernels.library_path().name)))\n",
                 tmp_path, cache, _fake_nvcc(tmp_path))
    assert got["error"] is not None
    assert str(cache) in got["error"] and "TOPSICLE_COMPILE_CACHE" in got["error"]
    assert not (tmp_path / "calls.txt").exists()
    assert got["native"] is False
    assert got["status"].startswith(f"not built: cannot write the compile cache {cache}")
    assert not (PKG_BUILD / got["library"]).exists() and _reader_stamp() == before


def test_writable_dir_and_default(tmp_path, monkeypatch):
    """In process: writable_dir creates the directory and leaves nothing
    in it, refuses a path under a file, and default_cache_dir reads the
    variable at each call."""
    d = compile_cache.writable_dir(tmp_path / "a" / "b")
    assert d.is_dir() and not list(d.iterdir())
    (tmp_path / "f").write_text("")
    with pytest.raises(compile_cache.CacheDirError, match="TOPSICLE_COMPILE_CACHE"):
        compile_cache.writable_dir(tmp_path / "f" / "c")
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "x"))
    assert compile_cache.default_cache_dir() == tmp_path / "x"
    monkeypatch.delenv(compile_cache.ENV)
    assert compile_cache.default_cache_dir() == PKG_BUILD
