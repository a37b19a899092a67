"""Host fallback model for telophrases beyond the device k-mer capacity.

The reference's regex matcher has no cap on the k-mer length
(the reference tool's allsteps.py:182-183); the device engine's
rolling codes are base-4 int32 and cap at k = 15
(ops.match.MAX_ROLLING_K).  Rather than refuse such runs, the engine
swaps in this model for the offending phrase only: it exposes the same
host-facing API as models.telomere.TelomereScanModel (counts in, (t,
has) out, numpy arrays), computed with the verified oracle semantics
(oracle/reference.py) on decoded reads.  k > 15 requires a pattern of
at least 8 bp and is exotic; a slower CPU path for just that phrase is
preferable to erroring a multi-k sweep.  Every other part of the run —
batching, CSV, subset files, resume manifest, per-read extras — is the
shared engine code, unchanged, so outputs stay format-identical.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from topsicle_tpu_torch.oracle.reference import binseg_l2_single, count_nonoverlapping

_DECODE = np.frombuffer(b"ACGT", np.uint8)


def _decode(codes: np.ndarray, n: int) -> str:
    """uint8 codes -> uppercase string; any non-ACGT class (including
    0xFF padding) becomes 'N', which no ACGT k-mer can match — the same
    poisoning rule the device kernels use."""
    c = np.ascontiguousarray(codes[:n])
    out = np.full(c.shape, ord("N"), np.uint8)
    mask = c < 4
    out[mask] = _DECODE[c[mask]]
    return out.tobytes().decode("ascii")


class OracleScanModel:
    """Drop-in TelomereScanModel replacement computed on host."""

    use_pallas = False

    def __init__(self, kmers: Sequence[str], *, window_size: int = 100,
                 slide: int = 7, jump: int = 5, min_size: int = 2):
        if not kmers:
            raise ValueError("empty k-mer table")
        self.kmers = list(kmers)
        self.k = len(kmers[0])
        self.K = len(kmers)
        self.window_size = window_size
        self.slide = slide
        self.jump = jump
        self.min_size = min_size

    # ---- step 1 ----------------------------------------------------------
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None) -> np.ndarray:
        """[B, 2, no_bp] uint8 -> [B, 2, K] int32 greedy non-overlapping
        counts (allsteps.py:181-187 semantics via the oracle)."""
        B, two, no_bp = ends_codes.shape
        counts = np.zeros((B, two, self.K), np.int32)
        for i in range(B):
            for e in range(two):
                s = _decode(ends_codes[i, e], no_bp)
                for j, km in enumerate(self.kmers):
                    counts[i, e, j] = count_nonoverlapping(s, km)
        return counts

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        return self.step1_counts_launch(ends_codes, ends_len)

    # ---- step 2 ----------------------------------------------------------
    def _window_means(self, s: str):
        means = []
        for st in range(0, len(s) - self.window_size + 1, self.slide):
            win = s[st : st + self.window_size - 1]
            cs = [count_nonoverlapping(win, km) or 1 for km in self.kmers]
            means.append(sum(cs) / len(cs))
        return means

    def step2_boundary_launch(self, tail_codes: np.ndarray,
                              n_windows: np.ndarray,
                              lens: np.ndarray | None = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, L] uint8 (+ per-read valid lengths) -> (t [B] int64,
        has [B] bool), t the changepoint window index as in
        ops.binseg_l2_device."""
        B, L = tail_codes.shape
        if lens is None:
            lens = np.full(B, L, np.int32)
        t = np.zeros(B, np.int64)
        has = np.zeros(B, bool)
        for i in range(B):
            means = self._window_means(_decode(tail_codes[i], int(lens[i])))
            ti = binseg_l2_single(means, self.min_size, self.jump) if means else None
            if ti is not None:
                t[i] = ti
                has[i] = True
        return t, has

    def step2_boundary(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                       lens: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return self.step2_boundary_launch(tail_codes, n_windows, lens)

    # ---- per-read extras -------------------------------------------------
    def rawcounts(self, tail_codes: np.ndarray) -> np.ndarray:
        """[B, L] uint8 -> [B, K, W] int32 per-window counts, no or-1
        floor (consumers apply it, matching allsteps.py:402,408)."""
        B, L = tail_codes.shape
        W = self.num_windows(L)
        out = np.zeros((B, self.K, W), np.int32)
        for i in range(B):
            s = _decode(tail_codes[i], L)
            for w, st in enumerate(range(0, len(s) - self.window_size + 1,
                                         self.slide)):
                win = s[st : st + self.window_size - 1]
                for j, km in enumerate(self.kmers):
                    out[i, j, w] = count_nonoverlapping(win, km)
        return out

    def num_windows(self, length: int) -> int:
        if length < self.window_size:
            return 0
        return (length - self.window_size) // self.slide + 1
