"""Duration boxplots per activity across models (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/viz_metrics/duration.py``;
matplotlib imported when plotting)."""
from __future__ import annotations

import os
from typing import Dict, List

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    segments_run_length_fast,
)
from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import pyplot


def plot_duration_boxplots(ref: Dict, models: List[Dict], outdir: str):
    plt = pyplot()
    os.makedirs(outdir, exist_ok=True)
    pm = ref["purpose_map"]
    inv = {v: k for k, v in pm.items()}
    grid_min = ref.get("grid_min") or 5
    datasets = [("ref", ref["Y"])] + [(m["name"], m["Y"]) for m in models]

    for p, pname in inv.items():
        series, labels = [], []
        for name, Y in datasets:
            _, purpose, length = segments_run_length_fast(Y)
            durs = length[purpose == p] * grid_min
            if durs.size:
                series.append(durs)
                labels.append(name)
        if not series:
            continue
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.boxplot(series, tick_labels=labels, showfliers=False)
        ax.set_title(f"Segment durations: {pname}")
        ax.set_ylabel("minutes")
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"duration_{pname}.png"), dpi=110)
        plt.close(fig)
