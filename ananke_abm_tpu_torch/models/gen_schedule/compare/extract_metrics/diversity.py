"""Diversity metrics (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/diversity.py``;
reference extract_metrics/diversity.py:19-273): Shannon entropy + Gini over
schedule / n-gram count distributions, with "confirmed" variants restricted
to cells present in the reference."""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    ensure_dir,
    entropy_from_count_array,
    gini_from_count_array,
    ngram_count_arrays,
    cached_schedule_counts,
)


def _pair_stats(counts_syn: np.ndarray, confirmed_mask: np.ndarray):
    return {
        "entropy_overall": entropy_from_count_array(counts_syn),
        "entropy_confirmed": entropy_from_count_array(
            counts_syn[confirmed_mask]
        ),
        "gini_overall": gini_from_count_array(counts_syn),
        "gini_confirmed": gini_from_count_array(counts_syn[confirmed_mask]),
    }


def _write(outdir, name, rows):
    fields = ["model", "entropy_overall", "entropy_confirmed",
              "gini_overall", "gini_confirmed"]
    with open(os.path.join(outdir, name), "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def metric_diversity_schedules(ref: Dict, models: List[Dict], outdir: str):
    """Writes diversity_schedules.csv."""
    ensure_dir(outdir)
    rows_r, counts_r = cached_schedule_counts(ref)
    ref_keys = {r.tobytes() for r in rows_r}
    H = entropy_from_count_array(counts_r)
    G = gini_from_count_array(counts_r)
    rows = [
        {"model": "ref", "entropy_overall": H, "entropy_confirmed": H,
         "gini_overall": G, "gini_confirmed": G}
    ]
    for m in models:
        rows_s, counts_s = cached_schedule_counts(m)
        confirmed = np.array(
            [r.tobytes() in ref_keys for r in rows_s], dtype=bool
        )
        rows.append({"model": m["name"], **_pair_stats(counts_s, confirmed)})
    _write(outdir, "diversity_schedules.csv", rows)


def metric_diversity_ngram(ref: Dict, models: List[Dict], outdir: str):
    """Writes diversity_ngram_n{n}.csv for n in 1..4."""
    ensure_dir(outdir)
    P = len(ref["purpose_map"])
    T = ref["Y"].shape[1]
    for n in (1, 2, 3, 4):
        if n > T:
            continue
        codes_r, counts_r = ngram_count_arrays(ref["Y"], n, P)
        H = entropy_from_count_array(counts_r)
        G = gini_from_count_array(counts_r)
        rows = [
            {"model": "ref", "entropy_overall": H, "entropy_confirmed": H,
             "gini_overall": G, "gini_confirmed": G}
        ]
        for m in models:
            codes_s, counts_s = ngram_count_arrays(m["Y"], n, P)
            confirmed = np.isin(codes_s, codes_r)
            rows.append(
                {"model": m["name"], **_pair_stats(counts_s, confirmed)}
            )
        _write(outdir, f"diversity_ngram_n{n}.csv", rows)


DIVERSITY_FUNCS = {
    "diversity_schedules": metric_diversity_schedules,
    "diversity_ngram": metric_diversity_ngram,
}
