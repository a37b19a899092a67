"""Telophrase k-mer table generation (host-side, tiny).

Semantics verified against the reference (SURVEY.md §8 item 1 and
the reference tool's allsteps.py:57-125): the k-mer set is the sorted
unique length-k substrings of the doubled, uppercased pattern (= all
rotations for k <= len(pattern)), followed by the same list complemented
via ACGT->TGCA *without* reversal.  Order matters: tie-breaks downstream
pick the first of equals in this exact order.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

COMPLEMENT_TABLE = str.maketrans("ACGT", "TGCA")

# Base codes used across host packing and device kernels.
# A/C/G/T -> 0..3; anything else (N, gaps, padding) -> INVALID_CODE.
INVALID_CODE = 4
PAD_BYTE = 0xFF

_ENCODE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
    _ENCODE_LUT[_b + 32] = _i  # lowercase


def telophrase_kmers(pattern: str, k: int) -> List[str]:
    """All distinct k-long windows of pattern+pattern (sorted), then their
    complements, concatenated origin-first."""
    doubled = (pattern + pattern).upper()
    if k > len(doubled):
        return []
    origin = sorted({doubled[i : i + k] for i in range(len(doubled) - k + 1)})
    return origin + [s.translate(COMPLEMENT_TABLE) for s in origin]


def smallest_period(s: str) -> int:
    """Smallest d >= 1 with s[i] == s[i+d] for all valid i (d == len(s)
    when the string does not overlap itself at all)."""
    n = len(s)
    for d in range(1, n):
        if s[d:] == s[:-d]:
            return d
    return n


def all_aperiodic(kmers: Sequence[str]) -> bool:
    """True iff no k-mer in the table self-overlaps (smallest period ==
    its length).

    Why this matters: if a k-mer is aperiodic, two of its matches in any
    text are always >= k apart (a closer pair would force a period < k),
    so `re.finditer`'s non-overlapping blocking can never skip a match —
    greedy counting (allsteps.py:182-183 semantics) degenerates to plain
    occurrence counting.  models.telomere uses this to select windowed
    *sum* kernels (no sequential scan) when the whole table qualifies;
    complementation preserves periods, so origin+complement tables
    qualify together."""
    return all(aperiodic_mask(kmers))


def aperiodic_mask(kmers: Sequence[str]) -> List[bool]:
    """Per-entry aperiodicity (see all_aperiodic).  Production tables
    are usually MIXED — e.g. the human CCCTAA k=5 table has only 2 of
    12 self-overlapping entries — so models.telomere splits them: the
    aperiodic subset takes the scan-free sum kernels and only the few
    periodic entries pay the exact sequential scan (its cost scales
    ~linearly in the entry count)."""
    return [smallest_period(s) == len(s) for s in kmers]


def patterns_to_search(pattern: Union[str, Sequence[str]], k: int) -> List[str]:
    """Reference-compatible entry point (allsteps.py:84-125).

    A list input is taken verbatim (uppercased); a 'A|B' string is refused
    (the reference branch for it is broken — see TopsicleConfig.validate).
    """
    if isinstance(pattern, (list, tuple)):
        return [p.upper() for p in pattern]
    if "|" in pattern:
        raise ValueError(
            "multi-pattern 'A|B' input is not supported (broken in the "
            "reference); pass a single repeat string or a list of k-mers"
        )
    return telophrase_kmers(pattern, k)


def encode_ascii(seq_bytes: bytes) -> np.ndarray:
    """Vectorized base encoding: bytes -> uint8 codes (A0 C1 G2 T3, else 4).

    Case-insensitive, so host never needs to .upper() strings (the
    reference uppercases at every use site)."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8)
    return _ENCODE_LUT[arr]


def encode_kmer_codes(kmers: Sequence[str]) -> np.ndarray:
    """[K, k] uint8 code matrix for the k-mer table."""
    if not kmers:
        return np.zeros((0, 0), dtype=np.uint8)
    k = len(kmers[0])
    out = np.empty((len(kmers), k), dtype=np.uint8)
    for i, s in enumerate(kmers):
        out[i] = encode_ascii(s.encode("ascii"))
    return out


def pack_kmer_table(kmers: Sequence[str]) -> np.ndarray:
    """Rolling-code table: kmer -> sum_j code[j] * 4**j (int32).

    A k-mer containing a non-ACGT character cannot be expressed as a
    rolling code; it is mapped to -1 (never matches on device — such
    k-mers only arise from non-ACGT *patterns*, outside the reference's
    envelope; the deviation is documented in ops/match.py)."""
    codes = encode_kmer_codes(kmers)
    K, k = codes.shape if codes.size else (0, 0)
    out = np.full(max(K, 0), -1, dtype=np.int32)
    for i in range(K):
        if (codes[i] >= 4).any():
            continue
        val = 0
        for j in range(k - 1, -1, -1):
            val = val * 4 + int(codes[i, j])
        out[i] = val
    return out
