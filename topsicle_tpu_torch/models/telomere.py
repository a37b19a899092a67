"""TorchScanModel: the device API the engine calls, on torch.

Counterpart of topsicle_tpu/models/telomere.py::TelomereScanModel, for
the tables this slice serves (fully aperiodic, K <= 31, k <= 15):

  step 1: [B, 2, no_bp] end codes -> [B, 2, K] occurrence counts (plain
          torch: unpack, rolling codes, match, sum)
  step 2: [B, L] tail codes -> (t, has): the CUDA sum-signal kernel
          (ops.cuda_kernels.sum_signal) then the exact changepoint

Batches ship on the lean wire (2 bits/base + lengths) when every read's
valid prefix is pure ACGT, else on the dense wire (+ an invalid bit-plane),
exactly as the JAX model chooses.  Launches return handles that copy the
result to pinned host memory without blocking; `np.asarray(handle)` waits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import aperiodic_mask, pack_kmer_table
from topsicle_tpu_torch import ops
from topsicle_tpu_torch.device import resolve_device


def _batch_is_clean(codes: np.ndarray, lens: np.ndarray) -> bool:
    """True iff every row's valid prefix is pure ACGT (codes < 4); rows
    are suffix-padded, so the ACGT count equals the length exactly then."""
    return bool(((codes < 4).sum(axis=1) == np.asarray(lens).reshape(-1)).all())


class HostResult:
    """A device result on its way to the host.  On CUDA the copy goes to
    freshly allocated pinned memory with non_blocking=True and an event
    marks its end; `np.asarray(handle)` waits on that event only.  Each
    handle owns its buffer, so batches kept in flight never share one."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            self._host = host
        else:
            self._host = t

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return a.copy() if copy else a


def unsupported(what: str, item: str) -> ValueError:
    """The error for a case the port refuses rather than serves."""
    return ValueError(f"{what} is not ported to the torch engine yet "
                      f"(ROADMAP.md {item}); use topsicle_tpu for it")


def check_table(kmers: Sequence[str]) -> None:
    """Raise for tables outside this slice: k > 15 (the host oracle
    fallback), periodic or mixed tables and K > 31 (the greedy kernel).
    Occurrence counting equals the reference's greedy non-overlapping
    count only when no entry self-overlaps."""
    k = len(kmers[0])
    if k > ops.MAX_ROLLING_K:
        raise unsupported(f"telophrase {k} > {ops.MAX_ROLLING_K}",
                          "queue 1 item 5, the k>15 oracle fallback")
    if not all(aperiodic_mask(kmers)):
        raise unsupported("a periodic or mixed k-mer table",
                          "queue 2 item 2, the greedy kernel")
    if len(kmers) > ops.cuda_kernels.MAX_ENTRIES:
        raise unsupported(f"a table of {len(kmers)} > 31 k-mers",
                          "queue 2 item 2, the greedy kernel")


class TorchScanModel:
    """Bound to one k-mer table; the host-facing API of TelomereScanModel
    (numpy in, handles out) on one torch device."""

    def __init__(self, kmers: Sequence[str], *, device: str | torch.device = "cuda",
                 window_size: int = 100, slide: int = 7, jump: int = 5,
                 min_size: int = 2, k: int | None = None, table=None):
        if not kmers:
            raise ValueError("empty k-mer table")
        self.kmers = list(kmers)
        self.k = len(self.kmers[0])
        if k is not None and k != self.k:
            raise ValueError(f"k={k} does not match the {self.k}-mer table")
        self.K = len(self.kmers)
        self.window_size = window_size
        self.slide = slide
        self.jump = jump
        self.min_size = min_size
        check_table(self.kmers)
        packed = pack_kmer_table(self.kmers) if table is None \
            else np.asarray(table, dtype=np.int32)
        if packed.shape != (self.K,):
            raise ValueError(f"table shape {packed.shape} does not match {self.K} k-mers")
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.table = torch.from_numpy(packed.copy()).to(self.device)

    # ---- host -> device ----------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def pack_scan_batch(self, codes: np.ndarray, lens: np.ndarray | None = None):
        """Host pack: ('lean', packed, lens) for clean batches, else
        ('dense', packed, invalid_bits)."""
        if lens is not None and _batch_is_clean(codes, lens):
            return ("lean", batching.pack_codes(codes), np.asarray(lens, np.int32))
        p, m = batching.pack_batch(codes)
        return ("dense", p, m)

    # ---- step 1 ------------------------------------------------------------
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None) -> HostResult:
        """[B, 2, no_bp] uint8 (+ [B] valid lengths) -> handle of [B, 2, K]
        int32 occurrence counts of each table entry in each end."""
        B = ends_codes.shape[0]
        flat = ends_codes.reshape(B * 2, -1)
        lens = None if ends_len is None else np.repeat(ends_len, 2)
        kind, a, b = self.pack_scan_batch(flat, lens)
        codes = ops.unpack_wire(self._to_device(a), self._to_device(b), a.shape[-1] * 4,
                                lean=kind == "lean")
        match = ops.match_positions(codes, self.table, self.k)
        return HostResult(ops.greedy_count_sum(match, self.k).reshape(B, 2, -1))

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        return np.asarray(self.step1_counts_launch(ends_codes, ends_len))

    # ---- step 2 ------------------------------------------------------------
    def step2_boundary_launch_packed(self, packed, n_windows: np.ndarray
                                     ) -> Tuple[HostResult, HostResult]:
        """(t, has) handles for a pack_scan_batch result: the sum-signal
        kernel on the wire as packed, then the exact changepoint."""
        kind, a, b = packed
        L = a.shape[-1] * 4
        y = ops.sum_signal(self._to_device(a), self._to_device(b), self.table,
                           k=self.k, window_size=self.window_size,
                           slide=self.slide, L=L, lean=kind == "lean")
        t, has = ops.binseg_l2_device(y, self._to_device(np.asarray(n_windows)),
                                      jump=self.jump, min_size=self.min_size)
        return HostResult(t), HostResult(has)

    def step2_boundary_launch(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                              lens: np.ndarray | None = None):
        return self.step2_boundary_launch_packed(
            self.pack_scan_batch(tail_codes, lens), n_windows)

    def step2_boundary(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                       lens: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, L] uint8, [B] int32 -> (t [B] int64, has [B] bool)."""
        t, has = self.step2_boundary_launch(tail_codes, n_windows, lens)
        return np.asarray(t), np.asarray(has)

    def num_windows(self, length: int) -> int:
        return ops.num_windows(length, self.window_size, self.slide)
