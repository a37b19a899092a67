"""--shardMode global: lockstep global batches across processes.

Counterpart of topsicle_tpu/parallel/multihost.py.  There every process
contributes a B_local shard of one global batch, GSPMD runs the scan over
every chip of every host, and the results come back replicated without a
sync, so the engine keeps a batch in flight while the hosts build the
next one.  Here each process computes its own B_local rows on its own
cards (a TorchScanModel, or a ShardedScanModel over several), and the
per-read outputs are all-gathered over gloo in rank order, so every
process holds the global result and keeps its own rows (`my_rows`).
Only those records cross processes: [B_local, 2, K] int32 counts from
step 1, t (int64) and has (bool) of [B_local] reads from step 2.

A launch returns at once, as JAX's does.  Gloo sends host tensors, so a
gather can start only once the local result has reached the host, and
gloo pairs collectives by the order they are issued, so every process
must issue the same sequence; the engine's drains are not in lockstep (a
process whose stream dries drains early).  So each launch queues its
batch, in launch order, for one gather thread a process
(`_GatherThread`), which waits for the local result (an event wait that
releases the GIL) and then issues the all-gather on a gloo group of its
own (mesh.result_group()); `np.asarray` of a handle waits for its entry.
The control word (`or_across_processes`) stays on the default group,
issued by the caller's thread: two groups keep the two orders apart.  A
failure in the gather thread (a local result that raises, a gather past
mesh.COLLECTIVE_TIMEOUT) is raised by its handle's `np.asarray` and by
every later handle's.  mesh.shutdown_distributed drains the queue and
joins the thread before the groups go.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from topsicle_tpu_torch.parallel import mesh
from topsicle_tpu_torch.parallel.distributed import world


def _all_gather(local: np.ndarray, n: int, group=None) -> np.ndarray:
    """[n * rows, ...]: every process's `local` in rank order."""
    mine = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    return np.concatenate([p.numpy() for p in parts])


class GatheredResult:
    """A batch's global result on its way: `np.asarray` waits and returns
    the [n_proc * B_local, ...] array, rank 0's rows first.  `local` is
    this process's handle of its rows; with one process the result is
    that handle's array, and the wait is its own."""

    def __init__(self, local):
        self.local = local
        self._n = world()[1]
        self._done = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        if self._n > 1:
            _gather_thread().submit(self)

    def _gather(self, group) -> None:
        """On the gather thread: the local rows, then the all-gather."""
        self._value = _all_gather(np.asarray(self.local), self._n, group)

    def __array__(self, dtype=None, copy=None):
        if self._n == 1:
            a = np.asarray(self.local)
        else:
            self._done.wait()
            if self._error is not None:
                raise self._error
            a = self._value
        return a if dtype is None else a.astype(dtype, copy=False)


class _GatherThread:
    """Issues global mode's result gathers on `group`, one at a time, in
    the order their batches were launched.  After a failure it issues no
    more: that handle and every later one raise the failure."""

    def __init__(self, group):
        self._group = group
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="topsicle-gathers",
                                        daemon=True)
        self._thread.start()

    def submit(self, handle: GatheredResult) -> None:
        self._queue.put(handle)

    def _run(self) -> None:
        while (handle := self._queue.get()) is not None:
            if self._error is None:
                try:
                    handle._gather(self._group)
                except Exception as e:      # raised where the handles are read
                    self._error = e
            handle._error = self._error
            handle._done.set()

    def close(self) -> None:
        """Finish every queued gather (each ends or fails within the
        collective timeout), then join the thread."""
        self._queue.put(None)
        self._thread.join()


_THREAD: Optional[_GatherThread] = None
_THREAD_LOCK = threading.Lock()


def _gather_thread() -> _GatherThread:
    """This process's gather thread, started at its first global launch."""
    global _THREAD
    with _THREAD_LOCK:
        if _THREAD is None:
            group = mesh.result_group()
            if group is None:
                raise RuntimeError("global gathers need the result group: join the "
                                   "process group with mesh.initialize_distributed")
            _THREAD = _GatherThread(group)
        return _THREAD


def stop_gathers() -> None:
    """Drain the gather queue and join its thread, if one was started."""
    global _THREAD
    with _THREAD_LOCK:
        thread, _THREAD = _THREAD, None
    if thread is not None:
        thread.close()


class GlobalScanModel:
    """Wraps this process's model: inputs are its B_local rows of a
    global batch, outputs the global results.  Every process calls each
    launch with the same B_local and the same `dense` flag (agreed
    through or_across_processes); dense=True ships the dense wire even
    for a clean local batch.  A launch returns without waiting for the
    device; its gather follows on the gather thread."""

    def __init__(self, base):
        self.base = base
        self.pid, self.n_proc = world()

    def step1_counts_global_launch(self, local_ends: np.ndarray, local_len: np.ndarray,
                                   dense: bool = False) -> GatheredResult:
        """[B_local, 2, no_bp] codes + [B_local] lengths -> handle of the
        [B_global, 2, K] int32 counts."""
        return GatheredResult(self.base.step1_counts_launch(local_ends,
                                                            None if dense else local_len))

    def step1_counts_global(self, local_ends: np.ndarray, local_len: np.ndarray,
                            dense: bool = False) -> np.ndarray:
        return np.asarray(self.step1_counts_global_launch(local_ends, local_len, dense))

    def step2_boundary_global_launch(self, local_tails: np.ndarray, local_nw: np.ndarray,
                                     local_lens: np.ndarray, dense: bool = False
                                     ) -> Tuple[GatheredResult, GatheredResult]:
        """[B_local, L] codes -> handles of the global (t, has)."""
        t, has = self.base.step2_boundary_launch(local_tails, local_nw,
                                                 None if dense else local_lens)
        return GatheredResult(t), GatheredResult(has)

    def step2_boundary_global(self, local_tails: np.ndarray, local_nw: np.ndarray,
                              local_lens: np.ndarray, dense: bool = False
                              ) -> Tuple[np.ndarray, np.ndarray]:
        t, has = self.step2_boundary_global_launch(local_tails, local_nw, local_lens, dense)
        return np.asarray(t), np.asarray(has)

    def my_rows(self, global_arr: np.ndarray, B_local: int) -> np.ndarray:
        """This process's slice of a global result."""
        return global_arr[self.pid * B_local:(self.pid + 1) * B_local]


def or_across_processes(flags: np.ndarray) -> np.ndarray:
    """Element-wise OR of a small bool vector over every process: the
    lockstep control word of global mode (one tiny all-gather on the
    default group, from the caller's thread, never the gather thread's
    group).  The input, as bools, when there is one process."""
    flags = np.asarray(flags, dtype=np.bool_)
    n = world()[1]
    if n == 1:
        return flags
    return _all_gather(flags[None, :], n).any(axis=0)


def any_process_has_data(flag: bool) -> bool:
    """OR of one bool over every process (see or_across_processes)."""
    return bool(or_across_processes(np.array([flag]))[0])
