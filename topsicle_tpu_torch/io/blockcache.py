"""Encoded-block disk cache for multi-telophrase runs.

The reference re-reads every input file once per telophrase (its outer
loop at main.py:206 re-runs the whole per-file pipeline per k), and so
does this engine's streaming path — parse + gzip inflate + encode is
the dominant host cost, so a 3-k sweep pays it three times.  This
cache stores each file's eligible reads in engine-native form (ids +
flat uint8 base codes + offsets, exactly one Block per device batch)
during the FIRST phrase's parse and replays them for later phrases:
~10x faster than re-inflating and re-parsing, with identical blocks by
construction.

Layout: one stream file per input, `<outputDir>/.blockcache/<key>.blk`,
where key = sha1(absolute path).  The stream is a header record
(cache-format version, input mtime/size, min_seq_length, batch size)
followed by one pickled (ids, codes_bytes, offs) record per block;
a partial write is never visible (tmp + atomic rename at the end of a
complete, successful parse).  A total-size cap bounds disk use
(TOPSICLE_BLOCK_CACHE_MB, default 4096; 0 disables caching): when a
run's caches would exceed it, later files simply parse again.

Ahead of the disk, a run's first MEMORY_BUDGET_BYTES (1,024 MB) of entries
stay in memory (`MemoryCache`, one an engine): a file's blocks are held as
the parse made them, and the entry spills to disk, held blocks first, once
that budget refuses one.  A sweep whose first phrase fits so writes
nothing to disk.

Correctness keys: input (mtime, size) — an edited input invalidates —
plus min_seq_length and the block batch size, which shape the blocks.

Counters (utils/profiling.py::StageTimers, given as `timers`; added on the
reader threads): blockcache.write_s and blockcache.bytes_written for the
records kept (held, or pickled and written), blockcache.replay_s,
blockcache.bases_replayed and blockcache.bytes_replayed for the records
handed back.  A record's bytes are its codes, offsets and ids, the same on
both sides and in either tier.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
import time
from typing import Iterator, Optional

import numpy as np

_VERSION = 2          # v2: end-sentinel record detects truncated entries
_END = ("__end__",)
# a run's entries held in memory ahead of the disk (MemoryCache)
MEMORY_BUDGET_BYTES = 1024 * 10**6


def cache_budget_bytes() -> int:
    try:
        mb = float(os.environ.get("TOPSICLE_BLOCK_CACHE_MB", "4096"))
    except ValueError:
        mb = 4096.0
    return int(mb * 1e6)


def _record_bytes(ids, codes: np.ndarray, offs: np.ndarray) -> int:
    return codes.nbytes + offs.nbytes + sum(len(i) for i in ids)


class MemoryCache:
    """The entries held in memory, keyed and checked like the disk's,
    within a byte budget that writers reserve record by record."""

    def __init__(self, budget: int):
        self._budget = budget
        self._left = budget
        self._lock = threading.Lock()
        self._entries: dict = {}

    def reserve(self, n: int) -> bool:
        with self._lock:
            if self._left >= n:
                self._left -= n
                return True
            return False

    def refund(self, n: int) -> None:
        with self._lock:
            self._left += n

    def publish(self, output_dir: str, input_path: str, header: dict, records: list) -> None:
        with self._lock:
            self._entries[_entry_path(output_dir, input_path)] = (header, records)

    def get(self, output_dir: str, input_path: str, min_len: int,
            batch_reads: int) -> Optional[list]:
        """The held records of a valid entry, else None."""
        with self._lock:
            got = self._entries.get(_entry_path(output_dir, input_path))
        try:
            if got is None or got[0] != _header(input_path, min_len, batch_reads):
                return None
        except OSError:
            return None
        return got[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._left = self._budget


def cache_dir(output_dir: str) -> str:
    return os.path.join(output_dir, ".blockcache")


def _entry_path(output_dir: str, input_path: str) -> str:
    key = hashlib.sha1(os.path.abspath(input_path).encode()).hexdigest()[:24]
    return os.path.join(cache_dir(output_dir), f"{key}.blk")


def _header(input_path: str, min_len: int, batch_reads: int) -> dict:
    st = os.stat(input_path)
    return {
        "version": _VERSION,
        "mtime_ns": st.st_mtime_ns,
        "size": st.st_size,
        "min_len": min_len,
        "batch_reads": batch_reads,
    }


class BlockCacheWriter:
    """Accumulates one file's parsed blocks; `commit()` makes the cache
    visible atomically.  `abandon()` (or an uncommitted close, e.g. a
    parse error) leaves nothing behind and refunds the reservation.

    Budget is RESERVED incrementally through the caller-supplied
    `reserve(nbytes) -> bool` / `refund(nbytes)` callbacks (atomic in
    the engine), so concurrent writers — the cross-file read-ahead pool
    runs one per file — can never jointly overshoot the configured cap.
    `add` returns False once a reservation is refused; the caller keeps
    parsing, the cache is just dropped.  With `memory` (a MemoryCache)
    the blocks are held there while its budget lasts; a refusal spills
    the entry to disk."""

    def __init__(self, output_dir: str, input_path: str, min_len: int,
                 batch_reads: int, reserve, refund, timers=None, memory=None):
        self._output_dir = output_dir
        self._input_path = input_path
        self._final = _entry_path(output_dir, input_path)
        self._tmp = self._final + ".tmp"
        self._reserve = reserve
        self._refund = refund
        self._timers = timers
        self._memory = memory
        self._held = None         # [(record, bytes)] while in memory
        self._held_bytes = 0
        self._reserved = 0
        self._fh = None
        self.exhausted = False    # abandoned because the budget ran out
        try:
            self._hdr = _header(input_path, min_len, batch_reads)
        except OSError:
            return
        if memory is not None:
            self._held = []
        else:
            self._open()

    def _open(self) -> None:
        try:
            os.makedirs(cache_dir(self._output_dir), exist_ok=True)
            self._fh = open(self._tmp, "wb")
            pickle.dump(self._hdr, self._fh)
        except OSError:
            self.abandon()

    @property
    def active(self) -> bool:
        return self._fh is not None or self._held is not None

    def add(self, ids, codes: np.ndarray, offs: np.ndarray) -> bool:
        if not self.active:
            return False
        t = time.perf_counter()
        n = _record_bytes(ids, codes, offs)
        if self._held is not None:
            if self._memory.reserve(n):
                self._held.append(((list(ids), codes, np.asarray(offs, np.int64)), n))
                self._held_bytes += n
                self._count(t, n)
                return True
            if not self._spill():
                return False
        if not self._write(ids, codes, offs):
            return False
        self._count(t, n)
        return True

    def _count(self, t: float, n: int) -> None:
        if self._timers is not None:
            self._timers.add("blockcache.write_s", time.perf_counter() - t)
            self._timers.add("blockcache.bytes_written", n)

    def _write(self, ids, codes: np.ndarray, offs: np.ndarray) -> bool:
        blob = pickle.dumps(
            (list(ids), codes.tobytes(), np.asarray(offs, np.int64).tobytes()),
            protocol=pickle.HIGHEST_PROTOCOL)
        if not self._reserve(len(blob)):
            self.exhausted = True
            self.abandon()
            return False
        self._reserved += len(blob)
        try:
            self._fh.write(blob)
        except OSError:
            self.abandon()
            return False
        return True

    def _spill(self) -> bool:
        """The memory budget is spent: the entry goes on on disk, its held
        blocks first (their bytes counted when they were held)."""
        held, self._held = self._held, None
        self._memory.refund(self._held_bytes)
        self._held_bytes = 0
        self._open()
        return all(self._fh is not None and self._write(*rec) for rec, _ in held)

    def commit(self) -> int:
        """Atomically publish; returns bytes consumed (0 if abandoned;
        the reservation is kept on success, refunded on failure).  An
        end-sentinel record is appended so a replay can distinguish a
        complete stream from one truncated after the rename (crash
        before data blocks reached disk)."""
        if self._held is not None:
            n, held = self._held_bytes, self._held
            self._held, self._held_bytes = None, 0
            if held:
                self._memory.publish(self._output_dir, self._input_path, self._hdr, held)
            return n
        if self._fh is None:
            return 0
        try:
            pickle.dump(_END, self._fh)
            self._fh.close()
            os.replace(self._tmp, self._final)
            n = self._reserved
            self._reserved = 0
            return n
        except OSError:
            self.abandon()
            return 0
        finally:
            self._fh = None

    def abandon(self) -> None:
        if self._held is not None:
            self._memory.refund(self._held_bytes)
            self._held, self._held_bytes = None, 0
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self._reserved:
            self._refund(self._reserved)
            self._reserved = 0
        try:
            if os.path.exists(self._tmp):
                os.remove(self._tmp)
        except OSError:
            pass


def open_cached_blocks(output_dir: str, input_path: str, min_len: int,
                       batch_reads: int, timers=None, memory=None) -> Optional[Iterator]:
    """Iterator of (ids, codes, offs) tuples when a valid cache entry
    exists for this input + parameters, in `memory` (a MemoryCache) or on
    disk, else None.  `timers` counts the records as they are handed back."""
    held = memory.get(output_dir, input_path, min_len, batch_reads) \
        if memory is not None else None
    if held is not None:
        return _replay_held(held, timers)
    path = _entry_path(output_dir, input_path)
    try:
        fh = open(path, "rb")
    except OSError:
        return None
    try:
        hdr = pickle.load(fh)
        if hdr != _header(input_path, min_len, batch_reads):
            fh.close()
            return None
    except Exception:
        fh.close()
        return None

    def gen():
        with fh:
            while True:
                t = time.perf_counter()
                try:
                    rec = pickle.load(fh)
                except EOFError:
                    # EOF before the end sentinel: the entry was
                    # truncated after commit (crash before data blocks
                    # reached disk) — a clean-looking short stream
                    # would silently drop the file's tail reads
                    raise ValueError("truncated block-cache entry")
                if rec == _END:
                    return
                ids, codes_b, offs_b = rec
                codes = np.frombuffer(codes_b, np.uint8)
                offs = np.frombuffer(offs_b, np.int64)
                if timers is not None:
                    _count_replay(timers, t, ids, codes, offs)
                yield ids, codes, offs
    return gen()


def _replay_held(held: list, timers) -> Iterator:
    t = time.perf_counter()
    for (ids, codes, offs), _ in held:
        if timers is not None:
            _count_replay(timers, t, ids, codes, offs)
        yield ids, codes, offs
        t = time.perf_counter()


def _count_replay(timers, t: float, ids, codes: np.ndarray, offs: np.ndarray) -> None:
    timers.add("blockcache.replay_s", time.perf_counter() - t)
    timers.add("blockcache.bases_replayed", len(codes))
    timers.add("blockcache.bytes_replayed", _record_bytes(ids, codes, offs))


def drop_entry(output_dir: str, input_path: str) -> int:
    """Remove one cache entry (used when a replay fails mid-stream so
    the retry re-parses the input instead of re-hitting the
    corruption).  Returns the bytes freed so the caller can refund the
    entry's kept budget reservation."""
    path = _entry_path(output_dir, input_path)
    try:
        n = os.path.getsize(path)
        os.remove(path)
        return n
    except OSError:
        return 0


def clear(output_dir: str) -> None:
    d = cache_dir(output_dir)
    try:
        for f in os.listdir(d):
            try:
                os.remove(os.path.join(d, f))
            except OSError:
                pass
        os.rmdir(d)
    except OSError:
        pass
