"""Host-side batch assembly: reads -> padded uint8 code arrays.

The host does only cheap, vectorized byte work (encode LUT, slicing,
reversal); all counting happens on device.  Padding uses PAD_BYTE
(0xFF -> code class "invalid"), which poisons any k-mer window touching
it, so ragged lengths need no extra masks on device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from topsicle_tpu_torch.kmers import encode_ascii, PAD_BYTE


def encode_read(seq: str) -> np.ndarray:
    return encode_ascii(seq.encode("ascii", errors="replace"))


def extract_ends(codes: np.ndarray, no_bp: int) -> np.ndarray:
    """[2, no_bp] uint8: forward start seq[:no_bp] and the REVERSED end
    seq[-no_bp:][::-1] (reversed, not complemented — allsteps.py:176-177;
    the complement k-mers in the table cover the other strand)."""
    out = np.full((2, no_bp), PAD_BYTE, dtype=np.uint8)
    n = min(len(codes), no_bp)
    out[0, :n] = codes[:n]
    out[1, :n] = codes[len(codes) - n :][::-1]
    return out


def ends_batch(code_list: Sequence[np.ndarray], no_bp: int) -> np.ndarray:
    """[B, 2, no_bp] uint8 step-1 batch."""
    out = np.full((len(code_list), 2, no_bp), PAD_BYTE, dtype=np.uint8)
    for i, codes in enumerate(code_list):
        out[i] = extract_ends(codes, no_bp)
    return out


def ends_batch_flat(codes_flat: np.ndarray, offs: np.ndarray,
                    no_bp: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized step-1 ends assembly straight from a block's flat
    codes + offsets (no per-read Python loop): returns (ends [B, 2,
    no_bp] uint8, ends_len [B] int32) for the B = len(offs)-1 reads.

    Row 0 is seq[:n], row 1 the REVERSED seq[-n:][::-1] with n =
    min(len, no_bp); positions past n are PAD_BYTE — identical to
    ends_batch(extract_ends) (allsteps.py:176-177 semantics)."""
    starts = offs[:-1]
    lens = (offs[1:] - starts)
    B = len(starts)
    n = np.minimum(lens, no_bp)
    j = np.arange(no_bp)
    valid = j[None, :] < n[:, None]
    hi = codes_flat.size - 1 if codes_flat.size else 0
    idx_f = np.clip(starts[:, None] + j[None, :], 0, hi)
    idx_r = np.clip((starts + lens)[:, None] - 1 - j[None, :], 0, hi)
    out = np.empty((B, 2, no_bp), np.uint8)
    out[:, 0, :] = np.where(valid, codes_flat[idx_f], PAD_BYTE)
    out[:, 1, :] = np.where(valid, codes_flat[idx_r], PAD_BYTE)
    return out, n.astype(np.int32)


def extract_tail(codes: np.ndarray, tail: str, trimfirst: int,
                 maxlengthtelo: int) -> np.ndarray:
    """The step-2 scan slice: seq[trimfirst:maxc] (forward) or
    seq[::-1][trimfirst:maxc] (reverse) with maxc = min(maxlengthtelo,
    len) — allsteps.py:263-272."""
    maxc = min(maxlengthtelo, len(codes))
    s = codes if tail == "forward" else codes[::-1]
    return s[trimfirst:maxc]


def tails_batch(slices: Sequence[np.ndarray], pad_len: int,
                quantum: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Pad tail slices to a common bucketed length.

    Returns (codes [B, L] uint8, lengths [B] int32) with L = pad_len
    rounded up to `quantum` (bounds jit recompilations across batches).
    """
    L = max(quantum, ((max(pad_len, 1) + quantum - 1) // quantum) * quantum)
    out = np.full((len(slices), L), PAD_BYTE, dtype=np.uint8)
    lens = np.zeros(len(slices), dtype=np.int32)
    for i, s in enumerate(slices):
        ln = min(len(s), L)
        out[i, :ln] = s[:ln]
        lens[i] = ln
    return out, lens


def window_counts_for_lengths(lengths: np.ndarray, window_size: int,
                              slide: int) -> np.ndarray:
    """Per-read valid-window count n (range(0, len-w+1, slide) length)."""
    n = (lengths - window_size) // slide + 1
    return np.maximum(n, 0).astype(np.int32)


# ---------------------------------------------------------------------------
# 2-bit wire format: host->device transfers carry 2 bits/base plus a
# 1 bit/base invalid mask (N or padding) — 3.5x less traffic than byte
# codes.  The device unpacks with shifts (ops/match.unpack_codes).
# ---------------------------------------------------------------------------

def pack_batch(codes: np.ndarray):
    """[B, L] uint8 codes -> (packed [B, ceil(L/4)], invalid_bits
    [B, ceil(L/8)]), both uint8.  L is padded to a multiple of 8 with
    invalid positions."""
    B, L = codes.shape
    Lp = ((L + 7) // 8) * 8
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)), constant_values=PAD_BYTE)
    invalid = codes >= 4
    bits = (codes & 3).astype(np.uint8)
    packed = (
        bits[:, 0::4]
        | (bits[:, 1::4] << 2)
        | (bits[:, 2::4] << 4)
        | (bits[:, 3::4] << 6)
    )
    inval_bits = np.packbits(invalid, axis=1, bitorder="little")
    return packed, inval_bits


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Lean wire format: [B, L] uint8 codes -> packed [B, ceil(L/4)]
    uint8, 2 bits/base with NO invalid-mask plane.  Valid only for
    batches whose every in-length base is ACGT (checked by callers);
    suffix padding is reconstructed on device from per-read lengths
    (ops.unpack_codes_len).  L pads to a multiple of 8 so packed shapes
    match pack_batch's (one jit cache either way)."""
    B, L = codes.shape
    Lp = ((L + 7) // 8) * 8
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)), constant_values=PAD_BYTE)
    bits = (codes & 3).astype(np.uint8)
    return (
        bits[:, 0::4]
        | (bits[:, 1::4] << 2)
        | (bits[:, 2::4] << 4)
        | (bits[:, 3::4] << 6)
    )
