"""Overview visualizations: descriptive match-position plot and the
k-mer/match heatmap (reference: descriptive_plot.py:89-165,233-313).

These are discovery tools (README.md:203,209: used to find/verify the
repeat unit), host-side by nature (matplotlib/seaborn); match positions
come from the same non-overlapping semantics as the engine.

Documented deviations from the reference script (overview_plot.py):
- temp filtered files are placed *inside* outputDir with a per-file
  index (the reference concatenates the path without a separator and
  reuses one name for every input file — overview_plot.py:68-70);
- everything else (hard-coded cutoff 0.7, first-telophrase filtering,
  40-read cap, figure styling, CSV schema incl. the list-repr read id
  column) follows the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from topsicle_tpu_torch.kmers import COMPLEMENT_TABLE
from topsicle_tpu_torch.io import reader


def nonoverlap_positions(haystack: str, needle: str) -> List[int]:
    """Start positions of non-overlapping occurrences (re.finditer)."""
    out: List[int] = []
    i, n = 0, len(needle)
    if n == 0:
        return out
    while True:
        j = haystack.find(needle, i)
        if j < 0:
            return out
        out.append(j)
        i = j + n


def nonoverlap_with_capture(haystack: str, needle: str, extra: int
                            ) -> List[Tuple[int, str]]:
    """(start, following `extra` chars) for non-overlapping matches of
    needle+(.{extra}) — the heatmap regex (descriptive_plot.py:273-287).
    The capture is part of the match span, so the next search resumes
    after needle+extra characters, and a match needs `extra` chars of
    lookahead to exist."""
    out: List[Tuple[int, str]] = []
    i, n = 0, len(needle)
    limit = len(haystack) - n - extra
    while True:
        j = haystack.find(needle, i)
        if j < 0 or j > limit:
            return out
        out.append((j, haystack[j + n : j + n + extra]))
        i = j + n + extra


def _file_label(path: str) -> str:
    return os.path.basename(path).split(".")[0]


def descriptive_plot(filepath: str, pattern: str, min_seq_length: int):
    """Scatter of pattern + complement match positions over the first
    minSeqLength bp of each read and of the reversed read, one line per
    read, capped at 40 reads (descriptive_plot.py:89-165)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    colors = sns.color_palette("colorblind", n_colors=30)
    sns.set_style("whitegrid", {"grid.color": "grey", "grid.linestyle": "--"})
    fig, ax = plt.subplots(figsize=(10, 15))

    patterns = [pattern.upper(), pattern.translate(COMPLEMENT_TABLE).upper()]
    labels = [f"5'-{patterns[0]}-3'", f"3'-{patterns[1]}-5'"]

    k_line = 0
    read_ids: List[str] = []
    added = set()
    count = 0
    for rec in reader.parse_records(filepath):
        if len(rec.seq) <= min_seq_length:
            continue
        count += 1
        seq = rec.seq[:min_seq_length].upper()
        seq_2 = rec.seq[::-1][:min_seq_length].upper()
        read_ids.append(rec.id)
        for i, pat in enumerate(patterns):
            m1 = nonoverlap_positions(seq, pat)
            kwargs = {}
            if pat not in added:
                kwargs["label"] = pat
                added.add(pat)
            ax.scatter(m1, [k_line] * len(m1), color=colors[i], marker="|",
                       zorder=2, **kwargs)
            m2 = nonoverlap_positions(seq_2, pat)
            ax.scatter(m2, [k_line] * len(m2), color=colors[i], marker="|", zorder=2)
        k_line += 2
        if count > 40:
            break

    ax.set_title(f"Location of telomere patterns in {_file_label(filepath)}")
    ax.set_xlabel("Position")
    handles, _ = ax.get_legend_handles_labels()
    ax.legend(handles, labels, title="Pattern")
    ax.set_yticks([i * 2 for i in range(len(read_ids))])
    ax.set_yticklabels(read_ids)
    ax.xaxis.grid(True)
    ax.yaxis.grid(True)
    plt.tight_layout()
    return fig


def patterns_vs_match_heatmap(filepath: str, pattern: str, phrase: int,
                              min_seq_length: int):
    """Forward-rotation k-mers x following-bases crosstab heatmap over
    bp 100-2000 of each read and of its reverse complement
    (descriptive_plot.py:233-313).  Returns (figure, tidy DataFrame with
    Pattern/Match/read id columns — the heatmap_rawcount CSV schema)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    doubled = (pattern + pattern).upper()
    rotations = sorted({doubled[i : i + phrase] for i in range(len(doubled) - phrase + 1)})
    extra = len(pattern) - phrase

    rows = []
    for rec in reader.parse_records(filepath):
        if len(rec.seq) <= min_seq_length:
            continue
        seq = rec.seq[100:2000].upper()
        # reverse, then complement => reverse complement strand
        seq_2 = rec.seq[::-1][100:2000].upper().translate(COMPLEMENT_TABLE)
        for pat in rotations:
            for _, grp in nonoverlap_with_capture(seq, pat, extra):
                rows.append((pat, grp, [rec.id]))
            for _, grp in nonoverlap_with_capture(seq_2, pat, extra):
                rows.append((pat, grp, [rec.id]))

    df = pd.DataFrame(rows, columns=["Pattern", "Match", "read id"])
    match_order = sorted(df["Match"].dropna().unique())
    df["Match"] = pd.Categorical(df["Match"], categories=match_order, ordered=True)

    fig, ax = plt.subplots(figsize=(8, 8), dpi=300)
    hist = pd.crosstab(df["Match"], df["Pattern"])
    ax = sns.heatmap(hist, annot=True, fmt="d", cmap="Blues",
                     cbar_kws=dict(shrink=0.75))
    ax.set_xticklabels(ax.get_xticklabels(), rotation=45, ha="right")
    ax.set_ylabel("Match")
    ax.set_xlabel("Pattern")
    plt.suptitle(f"{phrase}-bp patterns and matches from reads in \n {_file_label(filepath)}")
    plt.tight_layout()
    return fig, df
