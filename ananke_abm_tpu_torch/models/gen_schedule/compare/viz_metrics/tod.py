"""ToD marginal curves per purpose across models (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/viz_metrics/tod.py``: the
same grayscale-safe marker/linestyle cycle tables, black-by-default lines,
hours x-axis, per-purpose y-zoom and grid; matplotlib imported when
plotting)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.evals.metrics import (
    tod_marginals,
)
from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import pyplot

# reference ToD.py:131-132 — markers distinguish datasets, linestyles
# kick in once the marker cycle wraps; visually interchangeable figures
MARKERS = ["o", "s", "^", "D", "v", "x", "+", ">", "<", "p"]
LINESTYLES = ["-", "--", "-.", ":"]


def plot_tod_curves(ref: Dict, models: List[Dict], outdir: str,
                    time_grid: int = 5, start_time_min: int = 0,
                    colors: List[str] | None = None):
    plt = pyplot()
    os.makedirs(outdir, exist_ok=True)
    pm = ref["purpose_map"]
    P = len(pm)
    inv = {v: k for k, v in pm.items()}
    m_ref = tod_marginals(ref["Y"], P)
    all_m = [("ref", m_ref)] + [
        (m["name"], tod_marginals(m["Y"], P)) for m in models
    ]
    T = m_ref.shape[0]
    t_hours = (start_time_min + np.arange(T) * time_grid) / 60.0
    markevery = slice(0, None, max(T // 12, 1))
    for p in range(P):
        fig, ax = plt.subplots()
        for i, (name, mm) in enumerate(all_m):
            ax.plot(
                t_hours, mm[:, p],
                marker=MARKERS[i % len(MARKERS)],
                linestyle=LINESTYLES[(i // len(MARKERS)) % len(LINESTYLES)],
                markevery=markevery,
                color=colors[i] if colors is not None else "black",
                label=name,
            )
        ax.set_xlabel("Time of day (hours)")
        ax.set_ylabel(f"P(activity = {inv[p]})")
        ax.set_xlim(t_hours[0], t_hours[-1])
        y_max = max(1e-8, max(mm[:, p].max() for _, mm in all_m))
        ax.set_ylim(0.0, min(1.0, y_max * 1.05))
        ax.grid(True, alpha=0.3)
        ax.legend()
        fig.savefig(os.path.join(outdir, f"tod_{inv[p]}.png"))
        plt.close(fig)
