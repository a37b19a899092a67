"""Build-on-demand ctypes loader for the package's own native/tsio.cc.

The library is built into the compile cache (utils/compile_cache.py:
TOPSICLE_COMPILE_CACHE, else topsicle_tpu_torch/_build/), never beside
the source, so an installed package is whole and a checkout stays clean.
Its name carries a hash of the sources (tsio.cc and the inflate.h it
includes) and the compiler flags (`library_name`), so a cache shared by
installs of other versions never hands one a library built from another
source, whatever the files' times.
When it cannot be built (no g++ or zlib, a cache that cannot be
written), callers fall back to the Python reader and `status()` says
why."""

from __future__ import annotations

import ctypes
import hashlib
import mmap
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
_HEADER = os.path.join(_PKG_DIR, "native", "inflate.h")    # included by tsio.cc
_BUILD_DIR = str(compile_cache.default_cache_dir())
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def library_name(source: bytes, header: bytes) -> str:
    """The file name of the library built from tsio.cc's `source`, which
    includes inflate.h's `header`, with _FLAGS."""
    h = hashlib.sha256()
    for part in (source, header, " ".join(_FLAGS).encode()):
        h.update(hashlib.sha256(part).digest())
    return f"_tsio-{h.hexdigest()[:16]}.so"


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return b""          # _lib() reports a missing source; g++, a missing header


_SO = os.path.join(_BUILD_DIR, library_name(_read(_SRC), _read(_HEADER)))


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
            ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.tsio_stats.restype = None
        lib.tsio_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.tsio_close.argtypes = [ctypes.c_void_p]
        lib.tsio_kept.restype = ctypes.c_int64
        lib.tsio_kept.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.tsio_take.restype = None
        lib.tsio_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.tsio_repeated.restype = ctypes.c_int64
        lib.tsio_repeated.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.tsio_token_hash.restype = ctypes.c_uint64
        lib.tsio_token_hash.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.tsio_emit.restype = ctypes.c_int64
        lib.tsio_emit.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64, ctypes.c_int,
                                                           ctypes.c_void_p, ctypes.c_int64])
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


class Records:
    """What the subset file needs of a block's reads beside their codes
    (NativeReader(keep_records=True)), in arrays of the block's own:
    `headers` (the header lines after '@'/'>', concatenated; read i's is
    headers[header_offs[i]:header_offs[i+1]]), `quals` (FASTQ input: the
    quality bytes at the block's `offs`; None for FASTA), `plain` (read i
    is all uppercase A, C, G and T, so "ACGT"[codes] is its sequence) and
    `raw` (the sequences of the reads that are not plain, at `raw_offs`)."""

    __slots__ = ("headers", "header_offs", "quals", "plain", "raw", "raw_offs")

    def __init__(self, headers, header_offs, quals, plain, raw, raw_offs):
        self.headers = headers
        self.header_offs = header_offs
        self.quals = quals
        self.plain = plain
        self.raw = raw
        self.raw_offs = raw_offs


class Block:
    """One parsed block: `ids` (list of read IDs), `codes` (flat uint8
    code array owned by this block), `offs` (int64 offsets, read i =
    codes[offs[i]:offs[i+1]]), and `records` (Records, where the reader
    kept them; else None)."""

    __slots__ = ("ids", "codes", "offs", "records")

    def __init__(self, ids: List[str], codes: np.ndarray, offs: np.ndarray,
                 records: Optional[Records] = None):
        self.ids = ids
        self.codes = codes
        self.offs = offs
        self.records = records

    def __len__(self) -> int:
        return len(self.ids)


# Each array of a block (its codes; with keep_records, its qualities) is a
# private anonymous mapping of this many bytes, of which only the pages its
# reads fill are resident, and which is unmapped when the block and its
# views are freed.
_BLOCK_BYTES = 64 << 20


def _block_array() -> np.ndarray:
    m = mmap.mmap(-1, _BLOCK_BYTES, flags=mmap.MAP_PRIVATE)
    # no huge pages: one would hold up to 2 MB past a block's bytes
    m.madvise(mmap.MADV_NOHUGEPAGE)
    return np.frombuffer(m, np.uint8)


class NativeReader:
    """Streams eligible reads (len > min_len), decoded/encoded in C++.

    `iter_blocks()` is the fast path: one queue item per block instead
    of per read, its arrays written in place (the round-2 per-read slice loop was
    the host bottleneck on fast-transfer deployments).  `__iter__`
    keeps the per-read API for callers that want it."""

    def __init__(self, path: str, min_len: int, batch_reads: int = 512,
                 keep_records: bool = False):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._h = lib.tsio_open(path.encode(), min_len)
        if not self._h:
            self._h = None
            raise FileNotFoundError(f"cannot open/sniff {path}")
        self.batch_reads = batch_reads
        # each block also carries its Records, for a subset file written
        # from this parse; repeated() is then the input's repeated ids
        self.keep_records = keep_records
        self._fastq = lib.tsio_format(self._h) == 2

    def iter_blocks(self) -> Iterator[Block]:
        """Yield Blocks of up to batch_reads reads; each block's arrays
        are its own, so callers may hold blocks across iterations."""
        lib = self._lib
        offs = np.empty(self.batch_reads + 1, dtype=np.int64)
        ids_cap = 1 << 20
        ids = ctypes.create_string_buffer(ids_cap)
        id_offs = np.empty(self.batch_reads + 1, dtype=np.int64)
        while True:     # each block's arrays its own, nothing copied
            codes = _block_array()
            quals = _block_array() if self.keep_records else None
            n = lib.tsio_next(
                self._h,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                codes.size,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ids, ids_cap,
                1 if self.keep_records else 0,
                None if quals is None else quals.ctypes.data,
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
            raw_ids = ctypes.string_at(ids, id_offs[n])
            rid_list = [raw_ids[id_offs[i]:id_offs[i + 1]].decode()
                        for i in range(n)]
            yield Block(rid_list, codes[: offs[n]], offs[: n + 1].copy(),
                        None if quals is None else self._take(quals[: offs[n]]))

    def _take(self, quals: np.ndarray) -> Records:
        """The Records of the block tsio_next just delivered, with the
        quality bytes it wrote to `quals`, in arrays made for them (the
        C++ side frees its copies)."""
        sizes = (ctypes.c_int64 * 2)()
        n = self._lib.tsio_kept(self._h, sizes)
        rec = Records(np.empty(sizes[0], np.uint8), np.empty(n + 1, np.int64),
                      quals if self._fastq else None, np.empty(n, np.bool_),
                      np.empty(sizes[1], np.uint8), np.empty(n + 1, np.int64))
        self._lib.tsio_take(self._h, rec.headers.ctypes.data, rec.header_offs.ctypes.data,
                            rec.plain.ctypes.data, rec.raw.ctypes.data, rec.raw_offs.ctypes.data)
        return rec

    def repeated(self) -> set:
        """At the end of a keep_records input: the hashes (token_hash) of
        the read ids that more than one record had, short records too."""
        n = self._lib.tsio_repeated(self._h, None, 0)
        out = np.empty(n, np.uint64)
        if n:
            self._lib.tsio_repeated(self._h, out.ctypes.data, n)
        return set(out.tolist())

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for blk in self.iter_blocks():
            for i, rid in enumerate(blk.ids):
                yield rid, blk.codes[blk.offs[i]:blk.offs[i + 1]].copy()

    def _stats(self) -> List[int]:
        out = (ctypes.c_int64 * 5)()
        if self._h is not None:
            self._lib.tsio_stats(self._h, out)
        return list(out)

    def stats(self) -> Tuple[int, int, int]:
        """(records, bases, short records) parsed so far: every record of
        the input, the short ones (len <= min_len, skipped) too."""
        records, bases, short, _, _ = self._stats()
        return records, bases, short

    def inflate_stats(self) -> Tuple[float, int]:
        """(seconds, bytes) of the gzip inflate so far: the time spent in
        it, on the steady clock, and the bytes of text it made; (0.0, 0)
        for input that is not gzip, which passes through."""
        _, _, _, ns, inflated = self._stats()
        return ns * 1e-9, inflated

    def close(self) -> None:
        if self._h is not None:
            self._lib.tsio_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def token_hash(read_id: str) -> int:
    """The hash NativeReader.repeated() gives a read id."""
    raw = read_id.encode()
    return _lib().tsio_token_hash(raw, len(raw))


def format_records(blk: Block, idx: np.ndarray, fastq_out: bool) -> memoryview:
    """The subset file's bytes of reads `idx` of a block that carries its
    Records, formatted as write_subset_native writes them."""
    rec = blk.records
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    lens = blk.offs[idx + 1] - blk.offs[idx]
    hlens = rec.header_offs[idx + 1] - rec.header_offs[idx]
    out = np.empty(int(hlens.sum() + 2 * lens.sum() + 6 * len(idx)), np.uint8)
    n = _lib().tsio_emit(
        blk.codes.ctypes.data, blk.offs.ctypes.data, rec.headers.ctypes.data,
        rec.header_offs.ctypes.data, None if rec.quals is None else rec.quals.ctypes.data,
        rec.plain.ctypes.data, rec.raw.ctypes.data, rec.raw_offs.ctypes.data,
        idx.ctypes.data, len(idx), 1 if fastq_out else 0, out.ctypes.data, out.size)
    if n < 0:
        raise MemoryError("subset record buffer too small")
    return memoryview(out)[:n]


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
