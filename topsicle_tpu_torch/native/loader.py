"""Build-on-demand ctypes loader for the package's own native/tsio.cc.

The library is built into the compile cache (utils/compile_cache.py:
TOPSICLE_COMPILE_CACHE, else topsicle_tpu_torch/_build/), never beside
the source, so an installed package is whole and a checkout stays clean.
Its name carries a hash of the source and the compiler flags
(`library_name`), so a cache shared by installs of other versions never
hands one a library built from another source, whatever the files' times.
When it cannot be built (no g++ or zlib, a cache that cannot be
written), callers fall back to the Python reader and `status()` says
why."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from topsicle_tpu_torch.utils import compile_cache

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_STATUS = ""        # "built <path>", "loaded <path>" or "not built: <why>"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "tsio.cc")
_BUILD_DIR = str(compile_cache.default_cache_dir())
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def library_name(source: bytes) -> str:
    """The file name of the library built from `source` with _FLAGS."""
    h = hashlib.sha256(source + b"\0" + " ".join(_FLAGS).encode())
    return f"_tsio-{h.hexdigest()[:16]}.so"


def _source() -> bytes:
    try:
        with open(_SRC, "rb") as fh:
            return fh.read()
    except OSError:
        return b""          # _lib() reports the missing source


_SO = os.path.join(_BUILD_DIR, library_name(_source()))


def _build() -> Optional[str]:
    global _STATUS
    if os.path.exists(_SO):
        _STATUS = f"loaded {_SO}"
        return _SO
    try:
        compile_cache.writable_dir(_BUILD_DIR)
        # build under a private name, then rename: a concurrent process
        # never loads half a file
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        _STATUS = f"built {_SO}"
        return _SO
    except subprocess.CalledProcessError as e:
        err = e.stderr.decode(errors="replace").strip().splitlines()
        _STATUS = f"not built: g++ exited {e.returncode}: {err[-1] if err else ''}"
    except (OSError, subprocess.SubprocessError, compile_cache.CacheDirError) as e:
        _STATUS = f"not built: {e}"
    return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _STATUS
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            _STATUS = f"not built: no source {_SRC}"
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _STATUS = f"not loaded: {e}"
            return None
        lib.tsio_open.restype = ctypes.c_void_p
        lib.tsio_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.tsio_format.restype = ctypes.c_int
        lib.tsio_format.argtypes = [ctypes.c_void_p]
        lib.tsio_next.restype = ctypes.c_int64
        lib.tsio_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.tsio_stats.restype = None
        lib.tsio_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.tsio_close.argtypes = [ctypes.c_void_p]
        lib.tsio_subset.restype = ctypes.c_int64
        lib.tsio_subset.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _lib() is not None


def status() -> str:
    """How this process got the C++ reader, building it if it has not
    tried yet: "built <path>" or "loaded <path>", else why not (the
    Python reader runs)."""
    _lib()
    return _STATUS


class Block:
    """One parsed block: `ids` (list of read IDs), `codes` (flat uint8
    code array owned by this block), `offs` (int64 offsets, read i =
    codes[offs[i]:offs[i+1]])."""

    __slots__ = ("ids", "codes", "offs")

    def __init__(self, ids: List[str], codes: np.ndarray, offs: np.ndarray):
        self.ids = ids
        self.codes = codes
        self.offs = offs

    def __len__(self) -> int:
        return len(self.ids)


class NativeReader:
    """Streams eligible reads (len > min_len), decoded/encoded in C++.

    `iter_blocks()` is the fast path: one buffer copy + one queue item
    per block instead of per read (the round-2 per-read slice loop was
    the host bottleneck on fast-transfer deployments).  `__iter__`
    keeps the per-read API for callers that want it."""

    def __init__(self, path: str, min_len: int, batch_reads: int = 512,
                 codes_cap: int = 64 << 20):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._h = lib.tsio_open(path.encode(), min_len)
        if not self._h:
            self._h = None
            raise FileNotFoundError(f"cannot open/sniff {path}")
        self.batch_reads = batch_reads
        self.codes_cap = codes_cap

    def iter_blocks(self) -> Iterator[Block]:
        """Yield Blocks of up to batch_reads reads; the block's codes
        array is freshly owned (the scratch buffer is reused), so
        callers may hold blocks across iterations."""
        lib = self._lib
        codes = np.empty(self.codes_cap, dtype=np.uint8)
        offs = np.empty(self.batch_reads + 1, dtype=np.int64)
        ids_cap = 1 << 20
        ids = ctypes.create_string_buffer(ids_cap)
        id_offs = np.empty(self.batch_reads + 1, dtype=np.int64)
        while True:
            n = lib.tsio_next(
                self._h,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                codes.size,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ids, ids_cap,
                id_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.batch_reads,
            )
            if n == 0:
                return
            if n == -2:
                raise MemoryError("native reader buffer too small for one read")
            if n == -3:
                raise IOError("truncated or malformed input stream")
            if n < 0:
                raise IOError("native reader failed")
            raw_ids = ids.raw
            rid_list = [raw_ids[id_offs[i]:id_offs[i + 1]].decode()
                        for i in range(n)]
            yield Block(rid_list, codes[: offs[n]].copy(),
                        offs[: n + 1].copy())

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for blk in self.iter_blocks():
            for i, rid in enumerate(blk.ids):
                yield rid, blk.codes[blk.offs[i]:blk.offs[i + 1]].copy()

    def stats(self) -> Tuple[int, int, int]:
        """(records, bases, short records) parsed so far: every record of
        the input, the short ones (len <= min_len, skipped) too."""
        out = (ctypes.c_int64 * 3)()
        if self._h is not None:
            self._lib.tsio_stats(self._h, out)
        return out[0], out[1], out[2]

    def close(self) -> None:
        if self._h is not None:
            self._lib.tsio_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def write_subset_native(in_path: str, out_path: str, keep_ids: List[str],
                        fastq_out: bool, stats: Optional[Dict[str, float]] = None) -> int:
    """Write the records of `keep_ids` to out_path; the records written.
    `stats`, where given, gets "reread_s": the seconds spent re-reading
    the input (inflate and parse)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    joined = "\n".join(keep_ids).encode()
    reread = ctypes.c_double(0.0)
    n = lib.tsio_subset(in_path.encode(), out_path.encode(), joined,
                        1 if fastq_out else 0, ctypes.byref(reread))
    if stats is not None:
        stats["reread_s"] = reread.value
    if n < 0:
        raise IOError(f"native subset write failed for {in_path}")
    return int(n)
