"""Single-changepoint binary segmentation (L2 cost), exact: the torch
counterpart of topsicle_tpu/ops/changepoint.py.

The argmax of g(t) = (n*S_t - t*S_n)^2 / (t*(n-t)) over the candidates
t = jump, 2*jump, ... with min_size <= t <= n - min_size is decided in
integers: A = n*S_t - t*S_n and D = t*(n-t) in int64, and the cross
compare A1^2*D2 vs A2^2*D1 in multi-limb arithmetic.  Ties go to the
smaller t (ruptures' first-best-wins).

This is the plain version of the CUDA changepoint (csrc/binseg.cuh, behind
ops.cuda_kernels.sum_boundary and binseg_l2): it runs on the CPU and in
the checks that hold the kernels against it, never on a card's path.

torch has no uint64 add, shift or compare on the CPU, so the limbs are
31-bit values held in int64: a limb times a multiplier digit below 2**32,
plus a carry below 2**32, stays below 2**63.  That keeps the reference's
split: D = t*(n-t) <= W**2/4 is ONE multiplier digit while W**2/4 fits 32
bits (W <= 131071 windows) and two 31-bit digits beyond.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_M31 = (1 << 31) - 1

# Calls of binseg_l2_device by the device type of its input.  On a card the
# engine's path goes through the CUDA changepoint (ops.cuda_kernels), so a
# run there can show that "cuda" stayed 0.
PLAIN_CALLS = {"cpu": 0, "cuda": 0}


def _sq_limbs(a: torch.Tensor):
    """|a|^2 for int64 a, as 5 limbs of 31 bits (little-endian)."""
    ua = a.abs()
    a0 = ua & _M31
    a1 = (ua >> 31) & _M31
    a2 = ua >> 62                       # 0 or 1: |a| < 2**63
    c = a0 * a0
    l0 = c & _M31
    c = (c >> 31) + ((a0 * a1) << 1)
    l1 = c & _M31
    c = (c >> 31) + a1 * a1 + ((a0 * a2) << 1)
    l2 = c & _M31
    c = (c >> 31) + ((a1 * a2) << 1)
    l3 = c & _M31
    l4 = (c >> 31) + a2 * a2
    return (l0, l1, l2, l3, l4)


def _mul_limbs_1(sq, d: torch.Tensor):
    """Limbs times one multiplier digit 0 <= d < 2**32 -> 6 limbs."""
    out = []
    carry = None
    for limb in sq:
        acc = limb * d if carry is None else limb * d + carry
        out.append(acc & _M31)
        carry = acc >> 31
    out.append(carry)
    return tuple(out)


def _mul_limbs(sq, d: torch.Tensor):
    """Limbs times 0 <= d < 2**62, as two 31-bit digits -> 7 limbs."""
    d0 = d & _M31
    d1 = d >> 31
    n = len(sq)
    out = []
    carry = None
    for c in range(n + 1):
        acc = carry
        if c < n:
            p = sq[c] * d0
            acc = p if acc is None else acc + p
        if c >= 1:
            acc = acc + sq[c - 1] * d1
        out.append(acc & _M31)
        carry = acc >> 31
    out.append(carry)
    return tuple(out)


def _cmp(x, y):
    """Lexicographic compare of equal-length limb tuples -> (gt, eq)."""
    gt = torch.zeros_like(x[0], dtype=torch.bool)
    eq = torch.ones_like(x[0], dtype=torch.bool)
    for xi, yi in zip(reversed(x), reversed(y)):
        gt = gt | (eq & (xi > yi))
        eq = eq & (xi == yi)
    return gt, eq


def _pick(c1, c2, mul):
    """Tournament step: the better candidate of two.  Better means a
    larger A^2/D; exact ties go to the smaller t; invalid always loses
    (the same rule, and so the same t on every row, as the reference)."""
    s1, d1, t1, v1 = c1
    s2, d2, t2, v2 = c2
    gt, eq = _cmp(mul(s1, d2), mul(s2, d1))
    take1 = (~v2) | (v1 & (gt | (eq & (t1 <= t2))))

    def pick(u, w):
        return torch.where(take1, u, w)

    sq = tuple(pick(a, b) for a, b in zip(s1, s2))
    return (sq, pick(d1, d2), pick(t1, t2), v1 | v2)


def binseg_l2_device(y_int: torch.Tensor, num_windows: torch.Tensor,
                     jump: int = 5, min_size: int = 2):
    """Exact argmax changepoint per batch row.

    y_int:        [B, W] integer window signal
    num_windows:  [B] valid-window count n per read (ragged batches)
    Returns (t [B] int64, has_candidate [B] bool); t is the left-segment
    length in windows."""
    B, W = y_int.shape
    dev = y_int.device
    PLAIN_CALLS[dev.type] = PLAIN_CALLS.get(dev.type, 0) + 1
    J = W // jump
    if J < 1:
        return (torch.zeros(B, dtype=torch.int64, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
    S = torch.cumsum(y_int.to(torch.int64), dim=1)
    n = num_windows.to(torch.int64)[:, None]                          # [B,1]
    Sn = S.gather(1, (n - 1).clamp(min=0))                            # [B,1]
    t = torch.arange(1, J + 1, dtype=torch.int64, device=dev) * jump  # [J]
    St = S[:, t - 1]                                                   # [B,J]
    A = n * St - t * Sn
    valid = (t >= min_size) & (t <= n - min_size)
    # D of an invalid candidate never decides anything; clamped so the
    # limb arithmetic only ever sees nonnegative multipliers
    D = (t * (n - t)).clamp(min=0)
    tt = t.expand(B, J)

    # Pad to a power of two and reduce contiguous halves pairwise.
    Jp = 1 << (J - 1).bit_length()
    pad = Jp - J
    if pad:
        A = F.pad(A, (0, pad), value=0)
        D = F.pad(D, (0, pad), value=1)
        tt = F.pad(tt, (0, pad), value=0)
        valid = F.pad(valid, (0, pad), value=False)

    mul = _mul_limbs_1 if (W * W) // 4 <= 0xFFFFFFFF else _mul_limbs
    sq = _sq_limbs(A)
    while D.shape[1] > 1:
        h = D.shape[1] // 2
        sq, D, tt, valid = _pick(
            (tuple(s[:, :h] for s in sq), D[:, :h], tt[:, :h], valid[:, :h]),
            (tuple(s[:, h:] for s in sq), D[:, h:], tt[:, h:], valid[:, h:]),
            mul,
        )
    return tt[:, 0], valid[:, 0]
