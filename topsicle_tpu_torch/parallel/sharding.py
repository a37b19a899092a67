"""ShardedScanModel: one process's batches split over its devices.

Counterpart of topsicle_tpu/parallel/sharding.py::ShardedScanModel, whose
shard_map programs (and `_pallas_prog`, the sharded caller of both Pallas
kernels) run one program per chip on a row shard of the batch.  Here each
device holds a TorchScanModel with the same k-mer table and kernel choice;
a batch of B rows (B a multiple of the device count n, which the engine
pads to) is cut into n contiguous, equal row shards, and each shard packs
and launches on its own device, so the CUDA kernels run once per shard on
any card.  A launch returns one handle that concatenates the shards'
results in row order: the device path is integer-exact, so it equals one
device's result bit for bit.

The TPU-only parts of the JAX caller have no counterpart: the Pallas
8-row gate and the phase-planar wire.  Rawcounts (--rawcountpattern,
--plot) stay on the first device with the whole batch, as JAX keeps them
on its base model.

H2D: each shard's wire is pinned and copied with non_blocking=True onto
its card's current stream; torch's pinned-memory allocator records that
stream, so a pinned buffer is not reused before its copy has landed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class ShardedResult:
    """The handles of one batch's row shards; `np.asarray` waits for each
    and concatenates them in shard order."""

    def __init__(self, parts: List):
        self._parts = parts

    def __array__(self, dtype=None, copy=None):
        a = np.concatenate([np.asarray(p) for p in self._parts])
        return a if dtype is None else a.astype(dtype, copy=False)


class ShardedScanModel:
    """The host API of TorchScanModel over `devices` (n >= 1, repeats
    allowed: [cuda:0, cuda:0] runs two shards on one card).  Batches must
    be positive multiples of n."""

    def __init__(self, base, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("ShardedScanModel needs at least one device")
        self.base = base
        self.devices = [torch.device(d) for d in devices]
        self.models = [base.to(d) for d in self.devices]
        self.n = len(self.devices)

    def _shards(self, B: int) -> List[slice]:
        if B == 0 or B % self.n:
            raise ValueError(f"batch {B} is not a positive multiple of the "
                             f"{self.n} devices (the engine pads to one)")
        rows = B // self.n
        return [slice(i * rows, (i + 1) * rows) for i in range(self.n)]

    # ---- step 1 ------------------------------------------------------------
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None) -> ShardedResult:
        return ShardedResult([
            m.step1_counts_launch(ends_codes[s], None if ends_len is None else ends_len[s])
            for m, s in zip(self.models, self._shards(ends_codes.shape[0]))])

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        return np.asarray(self.step1_counts_launch(ends_codes, ends_len))

    # ---- step 2 ------------------------------------------------------------
    def step2_boundary_launch_packed(self, packed, n_windows: np.ndarray
                                     ) -> Tuple[ShardedResult, ShardedResult]:
        """A pack_scan_batch result, split by rows: on the lean wire `a`
        is [B, L/4] and `b` the [B] lengths, on the dense wire `b` is the
        [B, L/8] invalid plane."""
        kind, a, b = packed
        parts = [m.step2_boundary_launch_packed((kind, a[s], b[s]), n_windows[s])
                 for m, s in zip(self.models, self._shards(a.shape[0]))]
        return ShardedResult([t for t, _ in parts]), ShardedResult([h for _, h in parts])

    def step2_boundary_launch(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                              lens: np.ndarray | None = None):
        return self.step2_boundary_launch_packed(
            self.pack_scan_batch(tail_codes, lens), n_windows)

    def step2_boundary(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                       lens: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        t, has = self.step2_boundary_launch(tail_codes, n_windows, lens)
        return np.asarray(t), np.asarray(has)

    # ---- the first device's model, whole batch -------------------------------
    def pack_scan_batch(self, tail_codes: np.ndarray, lens: np.ndarray | None = None):
        return self.base.pack_scan_batch(tail_codes, lens)

    def rawcounts_launch_packed(self, packed):
        return self.base.rawcounts_launch_packed(packed)

    def rawcounts(self, tail_codes: np.ndarray,
                  lens: np.ndarray | None = None) -> np.ndarray:
        return self.base.rawcounts(tail_codes, lens)

    @property
    def kmers(self):
        return self.base.kmers

    @property
    def device(self) -> torch.device:
        return self.base.device

    def num_windows(self, length: int) -> int:
        return self.base.num_windows(length)
