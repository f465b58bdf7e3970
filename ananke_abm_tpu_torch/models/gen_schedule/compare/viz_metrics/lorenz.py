"""Lorenz curves + Gini bars over schedule-count distributions (the port's
copy of ``ananke_abm_tpu/models/gen_schedule/compare/viz_metrics/
lorenz.py``; matplotlib imported when plotting)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    gini_from_count_array,
    schedule_count_arrays,
)
from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import pyplot


def lorenz_points(counts: np.ndarray):
    """Returns (x, y) Lorenz curve of the count distribution."""
    x = np.sort(counts.astype(np.float64))
    cum = np.cumsum(x)
    total = cum[-1] if cum.size else 1.0
    y = np.concatenate([[0.0], cum / max(total, 1e-12)])
    xs = np.linspace(0.0, 1.0, y.size)
    return xs, y


def plot_lorenz_gini(ref: Dict, models: List[Dict], outdir: str,
                     color_map: Dict[str, str] | None = None):
    plt = pyplot()
    os.makedirs(outdir, exist_ok=True)
    datasets = [("ref", ref["Y"])] + [(m["name"], m["Y"]) for m in models]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ginis, names = [], []
    for name, Y in datasets:
        _, counts = schedule_count_arrays(Y)
        xs, ys = lorenz_points(counts)
        color = (color_map or {}).get(name)
        ax1.plot(xs, ys, label=name, color=color)
        ginis.append(gini_from_count_array(counts))
        names.append(name)
    ax1.plot([0, 1], [0, 1], "k:", lw=0.8)
    ax1.set_title("Lorenz curves of schedule counts")
    ax1.set_xlabel("cumulative share of unique schedules")
    ax1.set_ylabel("cumulative share of persons")
    ax1.legend(fontsize=8)

    cycle = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    colors = [
        (color_map or {}).get(n) or cycle[i % len(cycle)]
        for i, n in enumerate(names)
    ]
    ax2.bar(names, ginis, color=colors)
    ax2.set_title("Gini coefficient")
    ax2.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    out = os.path.join(outdir, "lorenz_gini_overview.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
