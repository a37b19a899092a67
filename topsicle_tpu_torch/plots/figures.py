"""Core matplotlib figures (reference-parity styling where it matters:
figure sizes, labels, colors — allsteps.py:316-328,486-500)."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def changepoint_plot(x, y, boundary: int, read_id: str, out_path: str,
                     xlim: int) -> None:
    """Mean-window signal with the detected boundary marked."""
    plt = _plt()
    plt.figure(figsize=(7.5, 3), dpi=300)
    plt.plot(x, y, color="#000000", linestyle="-", linewidth=2)
    plt.axvline(x=boundary, color="#FF2C2C", linewidth=2, linestyle="--",
                label=f"x = boundary point: {boundary}")
    plt.title(f"mean window + boundary point of {read_id}")
    plt.xlabel("base pair (bp)")
    plt.ylabel("mean window value")
    plt.xlim(0, xlim)
    plt.tight_layout()
    plt.grid(True)
    plt.savefig(out_path, format="png", dpi=300)
    plt.close()


def quadfit_plot(trc, telo, vertex_x: float, vertex_y: float, coeffs,
                 out_path: str) -> None:
    """TRC vs telomere length scatter with the fitted parabola and its
    vertex (the recommended cutoff)."""
    plt = _plt()
    a, b, c = coeffs
    trc_arr = np.asarray(trc, dtype=float)
    telo_arr = np.asarray(telo, dtype=float)
    x_fit = np.linspace(trc_arr.min(), trc_arr.max(), 100)
    y_fit = a * x_fit**2 + b * x_fit + c
    plt.figure(figsize=(7, 5))
    plt.scatter(trc_arr, telo_arr, color="blue", label="Topsicle results")
    plt.plot(x_fit, y_fit, color="red", label="Fit line")
    plt.scatter([vertex_x], [vertex_y], color="green", label="Vertex")
    plt.xlabel("TRC values")
    plt.ylabel("Telomere length, each read (bp)")
    plt.title("Quadratic fit plot")
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=300)
    plt.close()
