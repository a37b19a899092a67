"""--shardMode global: lockstep global batches across processes.

Counterpart of topsicle_tpu/parallel/multihost.py.  There every process
contributes a B_local shard of one global batch, GSPMD runs the scan over
every chip of every host, and the results come back replicated.  Here
each process computes its own B_local rows on its own cards (a
TorchScanModel, or a ShardedScanModel over several), and the per-read
outputs are all-gathered over the gloo process group in rank order, so
every process holds the global result and keeps its own rows
(`my_rows`).  Only those records cross processes: [B_local, 2, K] int32
counts from step 1, t (int64) and has (bool) of [B_local] reads from
step 2.

Gloo pairs collectives by the order they are issued, so every process
must issue the same sequence.  The engine's drains are not in lockstep
(a process whose stream dries drains early), so each gather is issued
when its batch is launched, in the lockstep order, and waited for when
the batch is drained.  The launch first waits for the local result to
reach the host: gloo sends host tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from topsicle_tpu_torch.parallel.distributed import world


class GatheredResult:
    """A local [B_local, ...] result, all-gathered asynchronously;
    `np.asarray` waits and returns the [n_proc * B_local, ...] global
    array, rank 0's rows first."""

    def __init__(self, local: np.ndarray):
        self._local = torch.from_numpy(np.ascontiguousarray(local))
        self._parts = [self._local]
        self._work = None
        n = world()[1]
        if n > 1:
            self._parts = [torch.empty_like(self._local) for _ in range(n)]
            self._work = dist.all_gather(self._parts, self._local, async_op=True)

    def __array__(self, dtype=None, copy=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
        a = np.concatenate([p.numpy() for p in self._parts])
        return a if dtype is None else a.astype(dtype, copy=False)


class GlobalScanModel:
    """Wraps this process's model: inputs are its B_local rows of a
    global batch, outputs the global results.  Every process calls each
    launch with the same B_local and the same `dense` flag (agreed
    through or_across_processes); dense=True ships the dense wire even
    for a clean local batch."""

    def __init__(self, base):
        self.base = base
        self.pid, self.n_proc = world()

    def step1_counts_global_launch(self, local_ends: np.ndarray, local_len: np.ndarray,
                                   dense: bool = False) -> GatheredResult:
        """[B_local, 2, no_bp] codes + [B_local] lengths -> handle of the
        [B_global, 2, K] int32 counts."""
        counts = self.base.step1_counts_launch(local_ends, None if dense else local_len)
        return GatheredResult(np.asarray(counts))

    def step1_counts_global(self, local_ends: np.ndarray, local_len: np.ndarray,
                            dense: bool = False) -> np.ndarray:
        return np.asarray(self.step1_counts_global_launch(local_ends, local_len, dense))

    def step2_boundary_global_launch(self, local_tails: np.ndarray, local_nw: np.ndarray,
                                     local_lens: np.ndarray, dense: bool = False
                                     ) -> Tuple[GatheredResult, GatheredResult]:
        """[B_local, L] codes -> handles of the global (t, has)."""
        t, has = self.base.step2_boundary_launch(local_tails, local_nw,
                                                 None if dense else local_lens)
        return GatheredResult(np.asarray(t)), GatheredResult(np.asarray(has))

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
    lockstep control word of global mode (one tiny all-gather).  The
    input, as bools, when there is one process."""
    flags = np.asarray(flags, dtype=np.bool_)
    if world()[1] == 1:
        return flags
    return np.asarray(GatheredResult(flags[None, :])).any(axis=0)


def any_process_has_data(flag: bool) -> bool:
    """OR of one bool over every process (see or_across_processes)."""
    return bool(or_across_processes(np.array([flag]))[0])
