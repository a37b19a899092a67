"""TorchScanModel: the device API the engine calls, on torch.

Counterpart of topsicle_tpu/models/telomere.py::TelomereScanModel for
every table with k <= 15:

  step 1: [B, 2, no_bp] end codes -> [B, 2, K] greedy counts: one kernel
          for every table (ops.step1_counts, a block a read end)
  step 2: [B, L] tail codes -> (t, has): the window signal and its exact
          changepoint, in one fused kernel: ops.sum_boundary for
          aperiodic tables with K <= 31, ops.greedy_boundary for the
          rest, one block a read or, for a read past one block, a
          thread-block cluster of its blocks.  A kernel asked for by name
          runs unfused: its signal (ops.sum_signal or ops.greedy_signal),
          then the changepoint kernel (ops.binseg_l2); so does a scan too
          long for a cluster (ops.geometry.pick_route, asked before every
          launch), its signal kernel on the window-block grid where a
          read's rows pass a block's shared memory.  No scan length is
          refused
  rawcounts: [B, L] tail codes -> [B, K, W] per-entry greedy counts, no
          floor (ops.greedy_counts, by the same picker), for
          --rawcountpattern and --plot

Batches ship on the lean wire (2 bits/base + lengths) when every read's
valid prefix is pure ACGT, else on the dense wire (+ an invalid bit-plane),
exactly as the JAX model chooses.  Launches return handles that copy the
result to pinned host memory without blocking; `np.asarray(handle)` waits.
"""

from __future__ import annotations

import copy
import warnings
from typing import Sequence, Tuple

import numpy as np
import torch

from topsicle_tpu_torch import ops
from topsicle_tpu_torch.device import resolve_device
from topsicle_tpu_torch.io import batch as batching
from topsicle_tpu_torch.kmers import aperiodic_mask, pack_kmer_table


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
            # the copy and its event go on t's card's stream, whichever
            # card is current: the event must follow the copy it marks
            with torch.cuda.device(t.device):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(t.device))
            self._host = host
        else:
            self._host = t

    def ready(self) -> bool:
        """Whether the result has reached the host, without waiting."""
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return a.copy() if copy else a


def resolve_kernel(requested) -> str | None:
    """The step-2 kernel asked for, as TopsicleConfig.use_pallas holds it:
    None (auto), "sum", or "greedy" (True is the legacy spelling).  False
    (--kernel xla) is auto: the port has no XLA programs, and the bytes
    are the same under any kernel.  Every other value raises."""
    if requested is None or requested is False:
        return None
    if requested is True:
        return "greedy"
    if requested in ("sum", "greedy"):
        return requested
    raise ValueError(f"unknown kernel {requested!r} (expected None, False, 'sum' or "
                     "'greedy')")


class TorchScanModel:
    """Bound to one k-mer table; the host-facing API of TelomereScanModel
    (numpy in, handles out) on one torch device.

    `kernel` picks step 2's signal kernel: "sum" and auto (None) take the
    sum kernel when the table is inside its envelope (every entry
    aperiodic, K <= 31), and the greedy kernel otherwise; "greedy" always
    takes the greedy kernel.  "sum" outside the envelope warns and takes
    the greedy kernel, as the JAX model does.  Auto runs its kernel fused
    with the changepoint (one launch: ops.sum_boundary or
    ops.greedy_boundary) where a read's rows and y fit one block, or a
    cluster of 2 to 8 blocks a read where one block a read would fit
    without y; a kernel asked for by name, and auto
    past that size, run the two kernels one after the other
    (ops.sum_signal or ops.greedy_signal, then ops.binseg_l2), the signal
    kernel one block a read or, for a longer read still, on the
    window-block grid.  ops.geometry.pick_route decides from the batch's
    length before each launch; `log` (a callable, the engine's run log)
    gets one line the first time a geometry leaves one fused block.  The
    results are bit-identical on every route."""

    def __init__(self, kmers: Sequence[str], *, device: str | torch.device = "cuda",
                 window_size: int = 100, slide: int = 7, jump: int = 5,
                 min_size: int = 2, k: int | None = None, table=None,
                 kernel: str | None = None, log=None):
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
        if self.k > ops.MAX_ROLLING_K:
            raise ValueError(
                f"k={self.k} (k>{ops.MAX_ROLLING_K}) exceeds the device k-mer capacity; "
                "TorchEngine computes such phrases on the host (models.oracle_model)")
        requested = resolve_kernel(kernel)
        self.aperiodic = all(aperiodic_mask(self.kmers))
        in_sum_envelope = self.aperiodic and self.K <= ops.cuda_kernels.MAX_ENTRIES
        self.kernel = "sum" if requested != "greedy" and in_sum_envelope else "greedy"
        self.fused = requested is None
        self.log = log
        self._routes_logged: set = set()    # shared by the copies `to` makes
        if requested == "sum" and self.kernel != "sum":
            warnings.warn("kernel 'sum' requires a table of aperiodic k-mers with "
                          f"K <= {ops.cuda_kernels.MAX_ENTRIES} entries; falling back "
                          "to 'greedy'")
        packed = pack_kmer_table(self.kmers) if table is None \
            else np.asarray(table, dtype=np.int32)
        if packed.shape != (self.K,):
            raise ValueError(f"table shape {packed.shape} does not match {self.K} k-mers")
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.table = torch.from_numpy(packed.copy()).to(self.device)

    def to(self, device: torch.device) -> "TorchScanModel":
        """The same model (table, kernel, geometry) on another device."""
        model = copy.copy(self)
        model.device = torch.device(device)
        model.table = self.table.to(model.device)
        return model

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

    def _wire_to_device(self, packed):
        """A pack_scan_batch result -> (codes_wire, aux, L, lean) on the device."""
        kind, a, b = packed
        return self._to_device(a), self._to_device(b), a.shape[-1] * 4, kind == "lean"

    # ---- step 1 ------------------------------------------------------------
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None) -> HostResult:
        """[B, 2, no_bp] uint8 (+ [B] valid lengths) -> handle of [B, 2, K]
        int32 greedy counts of each table entry in each end."""
        B = ends_codes.shape[0]
        flat = ends_codes.reshape(B * 2, -1)
        lens = None if ends_len is None else np.repeat(ends_len, 2)
        a, b, L, lean = self._wire_to_device(self.pack_scan_batch(flat, lens))
        counts = ops.step1_counts(a, b, self.table, k=self.k, L=L, lean=lean)
        return HostResult(counts.reshape(B, 2, -1))

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        return np.asarray(self.step1_counts_launch(ends_codes, ends_len))

    # ---- step 2 ------------------------------------------------------------
    def step2_boundary_launch_packed(self, packed, n_windows: np.ndarray
                                     ) -> Tuple[HostResult, HostResult]:
        """(t, has) handles for a pack_scan_batch result.  The signal
        kernel has the exact changepoint fused behind it (one launch: one
        block a read, or a cluster of a long read's blocks) unless it was
        asked for by name or the read passes a cluster; then the
        changepoint is ops.binseg_l2's launch.  The window counts ride one pinned copy,
        as the wire does."""
        a, b, L, lean = self._wire_to_device(packed)
        n = self._to_device(np.asarray(n_windows, dtype=np.int32))
        geometry = dict(k=self.k, window_size=self.window_size, slide=self.slide, L=L,
                        lean=lean)
        kernel, route = self.route(self.kernel, L, lean, fused=self.fused)
        if route.fused:
            boundary = ops.sum_boundary if kernel == "sum" else ops.greedy_boundary
            t, has = boundary(a, b, self.table, n, jump=self.jump, min_size=self.min_size,
                              cluster_windows=route.block_windows, **geometry)
        else:
            signal = ops.sum_signal if kernel == "sum" else ops.greedy_signal
            y = signal(a, b, self.table, block_windows=route.block_windows, **geometry)
            t, has = ops.binseg_l2(y, n, jump=self.jump, min_size=self.min_size)
        return HostResult(t), HostResult(has)

    def route(self, entry: str, L: int, lean: bool, fused: bool = False):
        """(entry, route) of a launch of `entry` ("sum", "greedy" or
        "counts") on a batch of L bases a read (ops.geometry.find_route).
        A window so long that the sum body cannot hold one (its groups
        pass a block's shared memory) takes the greedy body, which is
        exact for every table.  On a card, the first batch of a geometry
        that asked for the fused route and leaves one block a read for a
        cluster or for two launches, that takes the grid or that changes
        body is named in the run log."""
        geometry = dict(L=L, W=self.num_windows(L), K=self.K, k=self.k,
                        window_size=self.window_size, slide=self.slide, dense=not lean,
                        fused=fused)
        asked = entry
        route = ops.geometry.find_route(entry, **geometry)
        if route is None and entry == "sum":
            entry = "greedy"
        if route is None:
            route = ops.geometry.pick_route(entry, **geometry)
        left = route.kind != "fused" and (fused or route.kind == "grid") or entry != asked
        key = (asked, L, lean, fused)
        if left and self.log is not None and self.device.type == "cuda" \
                and key not in self._routes_logged:
            self._routes_logged.add(key)
            kernels = {"sum": "sum_signal then binseg_l2",
                       "greedy": "greedy_signal then binseg_l2",
                       "counts": "greedy_counts"}[entry]
            if route.fused:
                kernels = f"{entry}_boundary"
            W = self.num_windows(L)
            how = {"grid": f"on the window-block grid ({route.block_windows} windows a block)",
                   "cluster": f"on a cluster of {route.blocks(W)} blocks a read "
                              f"({route.block_windows} windows a block)"}.get(route.kind,
                                                                              "one block a read")
            why = ("takes " if not fused else
                   "is past the fused kernel's shared memory: " if not route.fused else
                   "has a window past the sum kernel's shared memory: " if entry != asked else
                   "is past one block's shared memory: ")
            self.log(f"INFO: scan length {L} ({'lean' if lean else 'dense'} wire, window "
                     f"{self.window_size}, slide {self.slide}, k={self.k}) {why}{kernels}, {how}")
        return entry, route

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

    # ---- rawcounts (--rawcountpattern, --plot) -------------------------------
    def rawcounts_launch_packed(self, packed) -> HostResult:
        """Handle of the per-entry window counts [B, K, W] int32 (no or-1
        floor; consumers apply it) on the same pack_scan_batch result as
        the boundary launch: the greedy kernel without the floor, exact
        for every table."""
        a, b, L, lean = self._wire_to_device(packed)
        return HostResult(ops.greedy_counts(
            a, b, self.table, k=self.k, J=self.window_size - self.k,
            W=self.num_windows(L), slide=self.slide, L=L, lean=lean,
            block_windows=self.route("counts", L, lean)[1].block_windows))

    def rawcounts(self, tail_codes: np.ndarray,
                  lens: np.ndarray | None = None) -> np.ndarray:
        """[B, L] uint8 -> [B, K, W] int32 per-window counts."""
        return np.asarray(
            self.rawcounts_launch_packed(self.pack_scan_batch(tail_codes, lens)))

    def num_windows(self, length: int) -> int:
        return ops.num_windows(length, self.window_size, self.slide)
