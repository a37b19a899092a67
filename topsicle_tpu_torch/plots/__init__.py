"""Host-side visualization (matplotlib), reference-parity figures:

- per-read changepoint plot (--plot; allsteps.py:316-328)
- quadratic-fit plot (allsteps.py:486-500)
- descriptive match-position plot and k-mer/match heatmap live in
  topsicle_tpu_torch.plots.overview (descriptive_plot.py:89-165,233-313)
"""

from topsicle_tpu_torch.plots.figures import changepoint_plot, quadfit_plot  # noqa: F401
