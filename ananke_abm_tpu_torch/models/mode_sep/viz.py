"""mode_sep trajectory plots (port of
``ananke_abm_tpu/models/mode_sep/viz.py``): a person's dense trajectory
with optional |v| and nearest-embedding-distance panels, stay intervals
shaded, threshold lines. matplotlib is imported inside the function, so
the module imports without it (the call then raises ImportError)."""
from __future__ import annotations

import os


def plot_person_trajectory(
    times,
    pred_zone_ids,
    zone_names,
    out_png,
    v_abs=None,
    emb_dist=None,
    stay_intervals=None,
    tau_stay: float | None = None,
    v_band: tuple | None = None,
    title: str = "",
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_sub = 1 + (v_abs is not None) + (emb_dist is not None)
    fig, axes = plt.subplots(
        n_sub, 1, figsize=(10, 2.8 * n_sub), sharex=True, squeeze=False
    )
    axes = [a[0] for a in axes]

    ax = axes[0]
    ax.step(times, pred_zone_ids, where="post")
    ax.set_yticks(range(len(zone_names)))
    ax.set_yticklabels(zone_names, fontsize=7)
    ax.set_ylabel("zone")
    if title:
        ax.set_title(title)

    k = 1
    if v_abs is not None:
        axv = axes[k]
        axv.plot(times, v_abs)
        axv.set_ylabel("|v|")
        if v_band:
            axv.axhline(v_band[0], color="g", ls=":", lw=0.8)
            axv.axhline(v_band[1], color="r", ls=":", lw=0.8)
        k += 1
    if emb_dist is not None:
        axd = axes[k]
        axd.plot(times, emb_dist)
        axd.set_ylabel("nearest emb dist")
        if tau_stay is not None:
            axd.axhline(tau_stay, color="r", ls=":", lw=0.8)

    if stay_intervals:
        for a in axes:
            for (t0, t1, *_rest) in stay_intervals:
                a.axvspan(t0, t1, alpha=0.12, color="green")

    axes[-1].set_xlabel("hour of day")
    d = os.path.dirname(out_png)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png
