"""Bounded background prefetch for host iterators.

The reference gets host-side overlap from a fork pool over files
(main.py:232-235).  Here a reader thread keeps parsing/encoding ahead
while the main thread drives the device, bounded by a queue so memory
stays flat."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher(Iterator[T]):
    """Iterate `iterable` on a background thread, `depth` items ahead.

    The worker starts EAGERLY at construction (not first next()), so a
    Prefetcher built for the *next* input file fills its queue while the
    current file drives the device — the engine's cross-file read-ahead
    (--threads).  Exceptions propagate to the consumer at the point of
    iteration."""

    def __init__(self, iterable: Iterable[T], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = False
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, args=(iterable,),
                                   daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when close() was called, so an
        abandoned worker never blocks forever holding file handles."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterable):
        try:
            try:
                for item in iterable:
                    if not self._put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                self._put((_SENTINEL, e))
                return
            self._put((_SENTINEL, None))
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def close(self) -> None:
        """Stop the worker and release its resources.  Safe to call on a
        fully- or partially-consumed (or never-consumed) prefetcher."""
        self._stop.set()
        self._done = True
        while True:  # unblock a worker stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5.0)

    def __iter__(self) -> "Prefetcher[T]":
        return self

    def __next__(self) -> T:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            self._done = True
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        return item


def prefetch(iterable: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Functional alias for Prefetcher (kept for callers/tests)."""
    return Prefetcher(iterable, depth)
