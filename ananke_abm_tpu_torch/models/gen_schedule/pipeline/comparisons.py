"""compare-samples pipeline (the port's copy of
``ananke_abm_tpu/models/gen_schedule/pipeline/comparisons.py``): evaluate
N sample sets against one reference grid — per-model report JSONs, an
aggregate CSV, and comparison plots (bigram L1, ToD JSD, all-home rate,
minutes-share errors, summary table; matplotlib imported when plotting)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.evals.report import (
    make_report,
    save_report,
)


def compare_samples(
    sample_specs: Sequence[Tuple[str, str, str]],
    reference_grid: str,
    outdir: str,
    make_plots: bool = True,
) -> List[Dict]:
    """sample_specs: (name, samples_npz, samples_meta_json) triples."""
    os.makedirs(outdir, exist_ok=True)
    Y_ref = np.load(reference_grid)["Y"].astype(np.int64)
    ref_tod = None
    tod_path = reference_grid.replace(".npz", "_tod.npy")
    if os.path.exists(tod_path):
        ref_tod = np.load(tod_path)

    reports = []
    for name, npz_path, meta_path in sample_specs:
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        Y = np.load(npz_path)["Y_generated"].astype(np.int64)
        report = make_report(Y, Y_ref, meta["purpose_map"], ref_tod=ref_tod)
        report["model"] = name
        save_report(report, os.path.join(outdir, f"report_{name}.json"))
        reports.append(report)

    # aggregate CSV
    import csv

    agg_path = os.path.join(outdir, "comparison_aggregate.csv")
    fields = [
        "model", "bigram_L1", "tod_jsd_macro", "all_home_rate",
        "start_home_rate", "end_home_rate", "diversity_ratio",
        "mean_minutes_share_abs_error",
    ]
    with open(agg_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in reports:
            w.writerow(
                {
                    "model": r["model"],
                    "bigram_L1": r["bigram"]["L1"],
                    "tod_jsd_macro": r["tod_jsd_macro"],
                    "all_home_rate": r["all_home_rate"],
                    "start_home_rate": r["start_home_rate"],
                    "end_home_rate": r["end_home_rate"],
                    "diversity_ratio": r["diversity_ratio"],
                    "mean_minutes_share_abs_error": float(
                        np.mean(r["minutes_share"]["abs_error"])
                    ),
                }
            )

    if make_plots and reports:
        _comparison_plots(reports, outdir)
    return reports


def _comparison_plots(reports: List[Dict], outdir: str):
    from ananke_abm_tpu_torch.models.gen_schedule.viz.plots import pyplot

    plt = pyplot()
    names = [r["model"] for r in reports]

    def bar(metric_fn, title, fname, ylabel):
        fig, ax = plt.subplots(figsize=(6, 3.5))
        vals = [metric_fn(r) for r in reports]
        ax.bar(names, vals)
        ax.set_title(title)
        ax.set_ylabel(ylabel)
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, fname), dpi=110)
        plt.close(fig)

    bar(lambda r: r["bigram"]["L1"], "Bigram L1 vs reference", "cmp_bigram_l1.png", "L1")
    bar(lambda r: r["tod_jsd_macro"], "Macro ToD JSD", "cmp_tod_jsd.png", "JSD (nats)")
    bar(lambda r: r["all_home_rate"], "All-home rate", "cmp_all_home.png", "rate")
    bar(
        lambda r: float(np.mean(r["minutes_share"]["abs_error"])),
        "Mean minutes-share abs error", "cmp_minutes_share_err.png", "abs error",
    )
    bar(
        lambda r: r["diversity_ratio"], "Diversity ratio",
        "cmp_diversity.png", "unique / N",
    )

    # summary table PNG
    fig, ax = plt.subplots(figsize=(8, 0.5 + 0.4 * len(reports)))
    ax.axis("off")
    cols = ["model", "bigram L1", "ToD JSD", "all-home", "diversity"]
    cells = [
        [
            r["model"],
            f"{r['bigram']['L1']:.4f}",
            f"{r['tod_jsd_macro']:.4f}",
            f"{r['all_home_rate']:.4f}",
            f"{r['diversity_ratio']:.4f}",
        ]
        for r in reports
    ]
    table = ax.table(cellText=cells, colLabels=cols, loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(8)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "cmp_table.png"), dpi=130)
    plt.close(fig)
