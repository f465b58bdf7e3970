"""viz-population pipeline (the port's copy of
``ananke_abm_tpu/models/gen_schedule/pipeline/viz.py``): unaries mean±std,
minutes-share bars, ToD marginal curves, bigram-delta heatmap from a
sample-population npz (+ optional reference grid overlay)."""
from __future__ import annotations

import json
import os

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.evals.metrics import (
    bigram_matrix,
    minutes_share,
    tod_marginals,
)
from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import (
    plot_bigram_delta,
    plot_minutes_share,
    plot_tod_marginals,
    plot_unaries_mean_std,
)


def visualize(
    samples_npz: str,
    samples_meta: str,
    outdir: str,
    reference_grid: str = "",
    use_logits: bool = True,
):
    os.makedirs(outdir, exist_ok=True)
    with open(samples_meta, "r", encoding="utf-8") as f:
        meta = json.load(f)
    names = meta.get("purpose_names_ordered") or sorted(
        meta["purpose_map"], key=meta["purpose_map"].get
    )
    P = len(names)

    arr = np.load(samples_npz)
    Y = arr["Y_generated"].astype(np.int64)

    if use_logits and "U_mean_logits" in arr:
        plot_unaries_mean_std(
            arr["U_mean_logits"], arr["U_std_logits"], names,
            os.path.join(outdir, "unaries_mean_std.png"),
        )

    Y_ref = None
    if reference_grid:
        Y_ref = np.load(reference_grid)["Y"].astype(np.int64)

    plot_minutes_share(
        minutes_share(Y, P),
        minutes_share(Y_ref, P) if Y_ref is not None else None,
        names,
        os.path.join(outdir, "minutes_share.png"),
    )
    plot_tod_marginals(
        tod_marginals(Y, P),
        tod_marginals(Y_ref, P) if Y_ref is not None else None,
        names,
        os.path.join(outdir, "tod_marginals.png"),
    )
    if Y_ref is not None:
        plot_bigram_delta(
            bigram_matrix(Y, P), bigram_matrix(Y_ref, P), names,
            os.path.join(outdir, "bigram_delta.png"),
        )
    return outdir
