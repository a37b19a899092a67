"""End-of-run aggregation: per-k medians, quadratic TRC fit, clamp ladder,
and the filtered median.  Host-side float64 (numerically part of the
output contract; np.polyfit deg-2 is ill-conditioned in fp32 — SURVEY.md
§7.3).

Semantics replicate the reference tool's main.py:248-307 and
allsteps.py:467-502, verified on the demo (vertex 0.897, filtered median
2050 bp — SURVEY.md §8 item 11).  Shared by the oracle engine and the JAX
engine (both aggregate on host).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

try:  # numpy >= 1.25 moved RankWarning; accept either home
    _RankWarning = np.exceptions.RankWarning
except AttributeError:  # pragma: no cover
    _RankWarning = np.RankWarning


@dataclasses.dataclass
class PhraseSummary:
    phrase: int
    median_telo: float
    median_trc: float
    vertex_trc: Optional[float] = None        # asymptotic/recommended TRC
    filtered_median_telo: Optional[float] = None
    coeffs: Optional[Tuple[float, float, float]] = None


def quad_vertex(trc: Sequence[float], telo: Sequence[float],
                input_trc: float, median_trc: float):
    """Inner fit + clamps (allsteps.py:467-483): polyfit deg 2 on
    (trc, telo); vertex x=-b/2a; then  >1.0 -> median_trc,
    <input_trc -> input_trc.  Returns (vertex_x, vertex_y, coeffs)."""
    trc_arr = np.asarray(trc, dtype=np.float64)
    telo_arr = np.asarray(telo, dtype=np.float64)
    with warnings.catch_warnings():
        # deg-2 polyfit on few, tightly-clustered TRCs is known
        # ill-conditioned (SURVEY.md §7.3); the fit is part of the
        # output contract, so we keep it and silence only this warning
        warnings.simplefilter("ignore", _RankWarning)
        coeffs = np.polyfit(trc_arr, telo_arr, 2)
    a, b, c = (float(v) for v in coeffs)
    vertex_x = -b / (2 * a)
    if vertex_x > 1.0:
        vertex_x = median_trc
    if vertex_x < input_trc:
        vertex_x = input_trc
    vertex_y = a * vertex_x**2 + b * vertex_x + c
    return vertex_x, vertex_y, (a, b, c)


def summarize_phrase(
    phrase: int,
    trc: Sequence[float],
    telo: Sequence[float],
    input_trc: float,
    log: Callable[..., None] = lambda *a: None,
    plot_fn=None,
) -> PhraseSummary:
    """Per-k aggregation with the outer clamp ladder (main.py:259-304).

    `plot_fn(trc, telo, vertex_x, vertex_y, coeffs)` is invoked (when
    given) right where the reference saves quadfit_{k}mer_{pattern}.png."""
    median_telo = float(np.median(np.asarray(telo, dtype=np.float64)))
    median_trc = float(np.median(np.asarray(trc, dtype=np.float64)))
    out = PhraseSummary(phrase=phrase, median_telo=median_telo, median_trc=median_trc)

    log(f"k-mer: {phrase}, with TRC >= {input_trc}, median telomere length is {median_telo:.2f} bp")

    if len(telo) < 3:
        log("Not enough data points to recommend TRC cutoff.")
        return out

    max_trc = max(trc)
    vertex_x, vertex_y, coeffs = quad_vertex(trc, telo, input_trc, median_trc)
    if plot_fn is not None:
        plot_fn(trc, telo, vertex_x, vertex_y, coeffs)
    out.coeffs = coeffs

    # Outer clamp ladder (main.py:277-291), order-sensitive.
    if vertex_x > max_trc:
        log(f"Asymptotic TRC {vertex_x:.3f} is greater than max TRC, which is not expected. See plot.")
        if median_trc < 1.0:
            log(f"Using median TRC value ({median_trc:.3f}) as asymptotic TRC instead.")
            vertex_x = median_trc
        else:
            log("Using 0.9 as asymptotic TRC instead, since asymptotic is greater than 1.0.")
            vertex_x = 0.9
    if vertex_x < 0.4:
        log("Quadratic fit suggests asymptotic TRC less than 0.4. See plot with fit line")
        if max_trc < 0.4:
            log(f"Maximum TRC value in data is {max_trc:.3f}, which is less than 0.4, indicating low confidence in telomere detection.")
        if vertex_x < input_trc:
            log(f"Asymptotic TRC {vertex_x:.3f} is less than input cutoff {input_trc:.3f}. Topsicle declares input TRC (={input_trc}) as asymptotic TRC.")
            vertex_x = input_trc

    log(f"asymptotic TRC, or recommended cutoff: {vertex_x:.3f}")
    out.vertex_trc = vertex_x

    kept = [t for r, t in zip(trc, telo) if r >= vertex_x]   # inclusive (main.py:296-299)
    if kept:
        med = float(np.median(np.asarray(kept, dtype=np.float64)))
        out.filtered_median_telo = med
        log(f"Median telomere length for reads with TRC cutoff >= {vertex_x:.3f}: {med:.2f} bp")
    else:
        log(f"No read has TRC >= {vertex_x:.3f}, please double check the data or submit log to GitHub.")
    return out


def summarize_all(
    phrase_to_trc: dict,
    phrase_to_telo: dict,
    input_trc: float,
    log: Callable[..., None] = lambda *a: None,
    plot_fn_for_phrase=None,
) -> List[PhraseSummary]:
    """All phrases in sorted order (main.py:249,259)."""
    out = []
    for phrase in sorted(phrase_to_telo):
        plot_fn = plot_fn_for_phrase(phrase) if plot_fn_for_phrase else None
        out.append(
            summarize_phrase(
                phrase,
                phrase_to_trc[phrase],
                phrase_to_telo[phrase],
                input_trc,
                log=log,
                plot_fn=plot_fn,
            )
        )
    return out
