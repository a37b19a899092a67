"""k-mer matching on device: plain torch counterparts of
topsicle_tpu/ops/match.py, with the same layouts ([B, L] uint8 codes,
[B, K, Lp] match bits, [B, K, W] per-entry window counts, [B, W] int32
window signal) and bit-identical integer results.

Two counting paths, as in the JAX package:
  - "sum" (boundary_sum_signal): occurrence counting, exact only for
    aperiodic tables (kmers.all_aperiodic), where no k-mer
    self-overlaps and greedy counting needs no sequential scan;
  - greedy (window_counts, greedy_count): the exact non-overlapping
    count for every table, a (next_free, count) carry over the offsets.

These run on the CPU, and are the plain versions the CUDA kernels
(ops.cuda_kernels) are held against on the card; no path on a card
computes with them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_ROLLING_K = 15  # 4**15 < 2**31; longer k-mers would overflow int32


def _unpack_bases(packed: torch.Tensor, L: int) -> torch.Tensor:
    """[..., L/4] packed bases (base 4q+s at bits 2s of byte q) ->
    [..., L] codes 0..3."""
    shifts2 = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    b = (packed[..., :, None] >> shifts2) & 3
    return b.reshape(*packed.shape[:-1], -1)[..., :L]


def unpack_codes(packed: torch.Tensor, invalid_bits: torch.Tensor, L: int) -> torch.Tensor:
    """The dense 2-bit wire (io.batch.pack_batch): [..., L/4] packed bases
    + [..., L/8] invalid bitmask -> [..., L] uint8 codes, invalid
    positions forced to code 4."""
    shifts1 = torch.arange(8, dtype=torch.uint8, device=packed.device)
    m = (invalid_bits[..., :, None] >> shifts1) & 1
    invalid = m.reshape(*invalid_bits.shape[:-1], -1)[..., :L]
    return torch.where(invalid > 0, 4, _unpack_bases(packed, L)).to(torch.uint8)


def unpack_codes_len(packed: torch.Tensor, lengths: torch.Tensor, L: int) -> torch.Tensor:
    """The lean wire (io.batch.pack_codes): [..., L/4] packed bases +
    [...] valid lengths -> [..., L] uint8 codes, positions >= length
    forced to code 4."""
    pos = torch.arange(L, dtype=torch.int32, device=packed.device)
    invalid = pos >= lengths.to(torch.int32)[..., None]
    return torch.where(invalid, 4, _unpack_bases(packed, L)).to(torch.uint8)


def unpack_wire(packed: torch.Tensor, aux: torch.Tensor, L: int, *, lean: bool) -> torch.Tensor:
    """Either wire -> [..., L] uint8 codes: `aux` is the lengths (lean)
    or the invalid bit-plane (dense)."""
    return unpack_codes_len(packed, aux, L) if lean else unpack_codes(packed, aux, L)


def num_windows(L: int, window_size: int, slide: int) -> int:
    """Windows of `window_size` bases, `slide` apart, in L bases."""
    return max(0, (L - window_size) // slide + 1)


def rolling_codes(codes: torch.Tensor, k: int):
    """[..., L] uint8 base codes -> ([..., L-k+1] int32 rolling codes,
    [..., L-k+1] bool validity); code(p) = sum_j base[p+j] * 4**j,
    invalid wherever any base >= 4."""
    if k > MAX_ROLLING_K:
        raise ValueError(f"k={k} exceeds rolling-code capacity ({MAX_ROLLING_K})")
    L = codes.shape[-1]
    Lp = L - k + 1
    if Lp <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    c = codes.to(torch.int32)
    val = torch.zeros(codes.shape[:-1] + (Lp,), dtype=torch.int32, device=codes.device)
    bad = torch.zeros(codes.shape[:-1] + (Lp,), dtype=torch.bool, device=codes.device)
    for j in range(k):
        sl = c[..., j:j + Lp]
        val = val + sl * (4 ** j)
        bad = bad | (sl >= 4)
    return val, ~bad


def match_positions(codes: torch.Tensor, table: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] codes x [K] rolling-code table -> [B, K, L-k+1] match bits.
    Table entries of -1 (non-ACGT k-mers) never match."""
    val, ok = rolling_codes(codes, k)
    eq = val[..., None, :] == table.to(torch.int32)[:, None]
    return eq & ok[..., None, :]


def window_counts(match: torch.Tensor, k: int, J: int, W: int, slide: int) -> torch.Tensor:
    """[B, K, Lp] match bits -> [B, K, W] int32 greedy non-overlapping
    counts: window w reads offsets w*slide + j for j < J, and the chain
    restarts at each window.  A match at offset j is taken when
    j >= next_free, which then becomes j + k.  The twin of JAX
    _window_counts_offset_scan: one step per offset on the whole
    [B, K, W] carry.  Offsets past the end of `match` never match."""
    B, K, Lp = match.shape
    if J <= 0 or W <= 0:
        return torch.zeros((B, K, max(W, 0)), dtype=torch.int32, device=match.device)
    need = (W - 1) * slide + J          # one past the last offset any window reads
    m = F.pad(match, (0, need - Lp)) if need > Lp else match
    nf = torch.zeros((B, K, W), dtype=torch.int32, device=match.device)
    cnt = torch.zeros_like(nf)
    span = (W - 1) * slide + 1
    for j in range(J):
        take = m[..., j:j + span:slide] & (nf <= j)
        nf = torch.where(take, j + k, nf)
        cnt += take
    return cnt


def greedy_count(match: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy non-overlapping count per [B, K] row over the whole
    position axis: len(re.finditer) semantics, the twin of JAX
    greedy_count_chunked / greedy_count_full.  One window covering
    every position."""
    return window_counts(match, k, match.shape[-1], 1, 1)[..., 0]


def window_signal(counts: torch.Tensor) -> torch.Tensor:
    """[B, K, W] counts -> y_int [B, W] = sum over K of max(count, 1)."""
    return counts.clamp_min(1).sum(dim=-2, dtype=torch.int32)


def _shift_left_zero(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[..., p] -> x[..., p+n], zero-filled at the tail (length kept)."""
    if n == 0:
        return x
    return F.pad(x[..., n:], (0, n))


def _sliding_reduce(x: torch.Tensor, width: int, op) -> torch.Tensor:
    """R[..., p] = op-fold of x[..., p : p+width] by doubling steps plus
    one shifted combine per set bit of `width` (zero fill is the
    identity of add and bitwise-or)."""
    pows = []
    s = x
    w = 1
    while w <= width:
        pows.append((w, s))
        if w * 2 > width:
            break
        s = op(s, _shift_left_zero(s, w))
        w *= 2
    total = None
    off = 0
    for w, sw in pows:              # LSB-first binary decomposition
        if width & w:
            part = _shift_left_zero(sw, off)
            total = part if total is None else op(total, part)
            off += w
    return total


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of nonnegative values < 2**31 (SWAR; torch has no
    popcount op).  Widened to int64 so the final multiply cannot wrap."""
    v = x.to(torch.int64)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def boundary_sum_signal(codes: torch.Tensor, table: torch.Tensor, k: int,
                        window_size: int, slide: int, num_windows: int) -> torch.Tensor:
    """y_int [B, W] = sum_i max(count_i, 1) for APERIODIC tables, with
    count_i the matches of entry i among window w's J = window_size - k
    admissible offsets w*slide + j:

        y[w] = windowed-SUM(t)[w] + K - popcount(windowed-OR(word)[w])

    where t[p] counts the entries matching at p (duplicate entries each
    count) and word[p] has bit i set when entry i matches at p."""
    J = window_size - k
    B = codes.shape[0]
    K = int(table.shape[0])
    if K > 31:
        raise ValueError("presence bit-plane holds at most 31 entries")
    if J <= 0 or num_windows <= 0:
        return torch.zeros((B, max(num_windows, 0)), dtype=torch.int32, device=codes.device)
    val, ok = rolling_codes(codes, k)
    tot = torch.zeros(val.shape, dtype=torch.int32, device=codes.device)
    word = torch.zeros(val.shape, dtype=torch.int32, device=codes.device)
    tv = table.to(torch.int32)
    for i in range(K):
        eq = ((val == tv[i]) & ok).to(torch.int32)
        tot = tot + eq
        word = word | (eq << i)
    W = num_windows
    need = (W - 1) * slide + J      # one past the last position any window reads
    T = need + J                    # cushion: shifted combines never wrap garbage
    padn = T - val.shape[-1]
    if padn > 0:
        tot, word = F.pad(tot, (0, padn)), F.pad(word, (0, padn))
    else:
        tot, word = tot[..., :T], word[..., :T]
    s = _sliding_reduce(tot, J, torch.add)
    o = _sliding_reduce(word, J, torch.bitwise_or)
    lim = (W - 1) * slide + 1
    s_w = s[:, :lim:slide]
    o_w = o[:, :lim:slide]
    present = popcount32(o_w & ((1 << K) - 1))
    return s_w + (K - present)
