"""Mock-data visualization (a copy of ``ananke_abm_tpu/data_generator/
data_visualization.py``; reference data_generator/data_visualization.py:
10-192): zone-graph plot, persona trajectory plots. matplotlib is imported
inside the functions: a machine without it can import this module."""
from __future__ import annotations

import os

import numpy as np

from ananke_abm_tpu_torch.data_generator.mock_world import (
    EDGES,
    ZONES,
    get_persona,
    persona_timeline,
    zone_names,
)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_zone_graph(out_png: str):
    """Zone graph with coordinates, node size ~ population, edges drawn."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    coords = {z: ZONES[z][7] for z in ZONES}
    pops = np.array([ZONES[z][2] for z in ZONES], dtype=float)
    sizes = 200 + 1200 * pops / pops.max()
    for a, b, *_ in EDGES:
        xa, ya = coords[a]
        xb, yb = coords[b]
        ax.plot([xa, xb], [ya, yb], "k-", lw=0.8, alpha=0.5, zorder=1)
    for z, (x, y) in coords.items():
        ax.scatter([x], [y], s=sizes[z - 1], zorder=2, alpha=0.8)
        ax.annotate(ZONES[z][0], (x, y), fontsize=7, ha="center",
                    textcoords="offset points", xytext=(0, 12))
    ax.set_title("Mock city zone graph")
    ax.set_xticks([])
    ax.set_yticks([])
    d = os.path.dirname(out_png)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_persona_trajectories(outdir: str, person_ids=(1, 2)):
    """Step plots of each persona's zone over the day."""
    plt = _pyplot()
    os.makedirs(outdir, exist_ok=True)
    names = zone_names()
    outs = []
    for pid in person_ids:
        tl = persona_timeline(get_persona(pid))
        fig, ax = plt.subplots(figsize=(9, 3.5))
        ax.step(tl["times"], tl["zone_ids"], where="post")
        anchors = tl["anchors"] == 1
        ax.scatter(tl["times"][anchors], tl["zone_ids"][anchors],
                   marker="*", s=90, color="red", label="anchor", zorder=3)
        ax.set_yticks(range(len(names)))
        ax.set_yticklabels(names, fontsize=7)
        ax.set_xlabel("hour of day")
        ax.set_title(f"{tl['person_name']} daily trajectory")
        ax.legend(fontsize=8)
        fig.tight_layout()
        out = os.path.join(outdir, f"trajectory_{tl['person_name']}.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        outs.append(out)
    return outs
