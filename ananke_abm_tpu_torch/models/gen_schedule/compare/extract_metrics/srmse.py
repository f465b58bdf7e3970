"""SRMSE metrics over full schedules and n-grams (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/srmse.py``;
reference extract_metrics/srmse.py:68-129). Counting is array-based
(np.unique over base-P window codes / rows) instead of dict loops."""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    align_count_arrays,
    cached_schedule_counts,
    ensure_dir,
    ngram_count_arrays,
    srmse_from_count_arrays,
)


def _write(outdir, level_name, rows):
    path = os.path.join(outdir, f"srmse_{level_name}.csv")
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["model", "srmse"])
        w.writeheader()
        w.writerows(rows)


def _schedule_srmse(ref: Dict, syn: Dict) -> float:
    """Schedule cells are whole rows; union-align via row hashing."""
    rows_r, counts_r = cached_schedule_counts(ref)
    rows_s, counts_s = cached_schedule_counts(syn)
    key_r = {r.tobytes(): c for r, c in zip(rows_r, counts_r)}
    key_s = {r.tobytes(): c for r, c in zip(rows_s, counts_s)}
    keys = sorted(set(key_r) | set(key_s))
    ca = np.array([key_r.get(k, 0) for k in keys], dtype=np.float64)
    cb = np.array([key_s.get(k, 0) for k in keys], dtype=np.float64)
    return srmse_from_count_arrays(ca, cb)


def _ngram_srmse(Y_ref, Y_syn, n, P) -> float:
    cr, vr = ngram_count_arrays(Y_ref, n, P)
    cs, vs = ngram_count_arrays(Y_syn, n, P)
    _, ca, cb = align_count_arrays(cr, vr, cs, vs)
    return srmse_from_count_arrays(ca, cb)


def metric_srmse_schedule(ref: Dict, models: List[Dict], outdir: str):
    ensure_dir(outdir)
    rows = [{"model": "ref", "srmse": 0.0}]
    for m in models:
        rows.append(
            {"model": m["name"], "srmse": _schedule_srmse(ref, m)}
        )
    _write(outdir, "schedule", rows)


def _make_ngram_metric(level_name: str, n: int):
    def metric(ref: Dict, models: List[Dict], outdir: str):
        ensure_dir(outdir)
        P = len(ref["purpose_map"])
        rows = [{"model": "ref", "srmse": 0.0}]
        for m in models:
            rows.append(
                {
                    "model": m["name"],
                    "srmse": _ngram_srmse(ref["Y"], m["Y"], n, P),
                }
            )
        _write(outdir, level_name, rows)

    return metric


metric_srmse_bigram = _make_ngram_metric("bigram", 2)
metric_srmse_trigram = _make_ngram_metric("trigram", 3)
metric_srmse_quadgram = _make_ngram_metric("quadgram", 4)

SRMSE_FUNCS = {
    "srmse_schedule": metric_srmse_schedule,
    "srmse_bigram": metric_srmse_bigram,
    "srmse_trigram": metric_srmse_trigram,
    "srmse_quadgram": metric_srmse_quadgram,
}
