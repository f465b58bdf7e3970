"""Trajectory share figures (port of
``ananke_abm_tpu/utils/traj_fig/figures.py``): proportional stacked area
over time with a fixed 7-purpose palette; zoomed line plots for primary
and discretionary purposes; a 10:00-14:00 lunch-window zoom. matplotlib
(Agg) is imported inside the functions that draw: the module imports
without it."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import pyplot

# fixed palette + legend order for the canonical 7 purposes — the exact
# values of reference fig_stacked_traj.py:29-38, so reference and repo
# figures are visually interchangeable
ORDERED_LABELS = ["Home", "Work", "Education", "Social", "Shopping",
                  "Accompanying", "Other"]
PURPOSE_PALETTE = {
    "Home": "#9ecae1",          # light blue
    "Work": "#3182bd",          # blue
    "Education": "#31a354",     # green
    "Social": "#756bb1",        # purple
    "Shopping": "#e6550d",      # orange
    "Accompanying": "#fd8d3c",  # light orange
    "Other": "#969696",         # grey
}


def _shares(Y: np.ndarray, P: int) -> np.ndarray:
    """(T, P) per-bin purpose shares across persons."""
    N, T = Y.shape
    flat = (np.arange(T)[None, :] * P + Y).ravel()
    counts = np.bincount(flat, minlength=T * P).reshape(T, P)
    return counts / max(N, 1)


def fig_stacked_traj(Y, purpose_map: Dict[str, int], out_png: str,
                     grid_min: int = 5):
    """Flipped stacked proportional distribution, cosmetics matching
    reference fig_stacked_traj.py:78-122: canonical label order with
    unknown purposes folded into "Other", stack order reversed so Home
    is the visual background, 12x6 figure, 2-hour ticks, white legend
    box in ORDERED_LABELS order."""
    from matplotlib.patches import Patch

    plt = pyplot()
    names = sorted(purpose_map, key=purpose_map.get)
    shares = _shares(Y, len(names))  # (T, P)
    # reorder columns into ORDERED_LABELS; unseen labels -> "Other"
    ordered = np.zeros((shares.shape[0], len(ORDERED_LABELS)))
    for i, n in enumerate(names):
        j = ORDERED_LABELS.index(n if n in ORDERED_LABELS else "Other")
        ordered[:, j] += shares[:, i]
    hours = np.arange(Y.shape[1]) * grid_min / 60.0

    fig = plt.figure(figsize=(12, 6), dpi=140)
    plt.stackplot(
        hours, ordered.T[::-1],
        colors=[PURPOSE_PALETTE[l] for l in ORDERED_LABELS[::-1]],
    )
    plt.title(
        "Stacked Proportional Distribution of Activities "
        "(Flipped, Hour Scale)"
    )
    plt.xlabel("Time (hours)")
    plt.ylabel("Proportion")
    plt.ylim(0, 1)
    plt.xlim(float(hours.min()), float(hours.max()))
    plt.xticks(range(int(np.floor(hours.min())),
                     int(np.ceil(hours.max())) + 1, 2))
    handles = [Patch(facecolor=PURPOSE_PALETTE[l], label=l)
               for l in ORDERED_LABELS]
    plt.legend(handles=handles, loc="upper left", frameon=True,
               facecolor="white", edgecolor="black")
    plt.tight_layout()
    fig.savefig(out_png, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return out_png


def fig_specific_trajs(Y, purpose_map: Dict[str, int], outdir: str,
                       grid_min: int = 5):
    """Zoomed line plots: primary (Work/Education) and discretionary
    (Social/Shopping/Accompanying) probability curves, auto-zoomed y."""
    plt = pyplot()
    os.makedirs(outdir, exist_ok=True)
    names = sorted(purpose_map, key=purpose_map.get)
    shares = _shares(Y, len(names))
    hours = np.arange(Y.shape[1]) * grid_min / 60.0
    groups = {
        "primary": [p for p in ("Work", "Education") if p in purpose_map],
        "discretionary": [
            p for p in ("Social", "Shopping", "Accompanying")
            if p in purpose_map
        ],
    }
    outs = []
    for gname, members in groups.items():
        if not members:
            continue
        fig, ax = plt.subplots(figsize=(9, 4))
        top = 0.0
        for p in members:
            y = shares[:, purpose_map[p]]
            ax.plot(hours, y, label=p, color=PURPOSE_PALETTE.get(p))
            top = max(top, float(y.max()))
        ax.set_ylim(0, max(top * 1.15, 1e-3))
        ax.set_xlabel("hour of day")
        ax.set_ylabel("share")
        ax.legend(fontsize=8)
        ax.set_title(f"{gname} activity shares (zoomed)")
        fig.tight_layout()
        out = os.path.join(outdir, f"traj_{gname}.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        outs.append(out)
    return outs


def fig_primary_lunch_time(Y, purpose_map: Dict[str, int], outdir: str,
                           grid_min: int = 5):
    """Zoomed stacked plots 10:00-14:00 for Work and Education."""
    plt = pyplot()
    os.makedirs(outdir, exist_ok=True)
    names = sorted(purpose_map, key=purpose_map.get)
    shares = _shares(Y, len(names))
    hours = np.arange(Y.shape[1]) * grid_min / 60.0
    window = (hours >= 10.0) & (hours <= 14.0)
    outs = []
    for p in ("Work", "Education"):
        if p not in purpose_map:
            continue
        fig, ax = plt.subplots(figsize=(7, 4))
        y = shares[window, purpose_map[p]]
        ax.fill_between(hours[window], y, color=PURPOSE_PALETTE.get(p), alpha=0.7)
        ax.plot(hours[window], y, color=PURPOSE_PALETTE.get(p))
        ax.set_xlabel("hour of day")
        ax.set_ylabel("share")
        ax.set_title(f"{p} share around lunch (10:00-14:00)")
        fig.tight_layout()
        out = os.path.join(outdir, f"lunch_{p}.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        outs.append(out)
    return outs
