"""Raw counting metrics (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/raw_counts.py``;
reference extract_metrics/raw_counts.py:45-375): per-person
activity/bigram/trigram/quadgram segment counts; schedule confirmation vs
the reference universe (individual + unique level with coverage);
home-pattern statistics. All derived from the vectorized run-length
segmentation."""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    cached_schedule_counts,
    ensure_dir,
    segments_run_length_fast,
)


def _write(outdir, name, rows):
    with open(os.path.join(outdir, name), "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def metric_raw_cells(ref: Dict, models: List[Dict], outdir: str):
    """Writes raw_cells_counts.csv: segment-level n-gram totals + per-person
    averages (activities = runs of constant purpose)."""
    ensure_dir(outdir)

    def stats(name, Y):
        N = Y.shape[0]
        person, _, _ = segments_run_length_fast(Y)
        seg_per_person = np.bincount(person, minlength=N)
        k = seg_per_person
        total = int(k.sum())
        bi = int(np.maximum(k - 1, 0).sum())
        tri = int(np.maximum(k - 2, 0).sum())
        quad = int(np.maximum(k - 3, 0).sum())
        return {
            "model": name,
            "N_persons": int(N),
            "total_activities": total,
            "total_bigrams": bi,
            "total_trigrams": tri,
            "total_quadgrams": quad,
            "avg_activities_per_person": total / max(N, 1),
            "avg_bigrams_per_person": bi / max(N, 1),
            "avg_trigrams_per_person": tri / max(N, 1),
            "avg_quadgrams_per_person": quad / max(N, 1),
        }

    rows = [stats("ref", ref["Y"])] + [stats(m["name"], m["Y"]) for m in models]
    _write(outdir, "raw_cells_counts.csv", rows)


def metric_raw_schedules(ref: Dict, models: List[Dict], outdir: str):
    """Writes raw_counts_schedule_confirmation.csv: confirmed vs
    non-confirmed schedules at the individual and unique level + coverage
    of the reference's unique universe."""
    ensure_dir(outdir)
    rows_r, counts_r = cached_schedule_counts(ref)
    # membership keys over uint8-packed rows: 8x less bytes to hash
    # than int64 rows. The key dtype must be the SAME on both sides of
    # the set test, so each ref/model pair picks the cheapest VALUE-EXACT
    # common dtype: uint8 when both fit, int64 when both are integer,
    # float64 otherwise (an int cast would truncate float grids and
    # falsely "confirm" distinct rows, e.g. 1.2 vs 1.7).
    def _packable(rows):
        return bool(
            rows.size
            and np.issubdtype(rows.dtype, np.integer)
            and rows.min() >= 0
            and rows.max() <= 255
        )

    def _key_mode(rows_a, rows_b):
        if _packable(rows_a) and _packable(rows_b):
            return np.uint8
        if (np.issubdtype(rows_a.dtype, np.integer)
                and np.issubdtype(rows_b.dtype, np.integer)):
            return np.int64
        return np.float64  # exact for int values < 2^53 and any float32

    def _keys(rows, dtype):
        rows = np.ascontiguousarray(rows.astype(dtype))
        return [r.tobytes() for r in rows]

    key_sets = {}  # key dtype -> set of ref keys (built lazily)

    def _ref_keys(dtype):
        if dtype not in key_sets:
            key_sets[dtype] = set(_keys(rows_r, dtype))
        return key_sets[dtype]

    n_ref_unique = len(counts_r)

    def stats(name, dataset):
        Y = dataset["Y"]
        N = Y.shape[0]
        rows_u, counts_u = cached_schedule_counts(dataset)
        dtype = _key_mode(rows_r, rows_u)
        ref_keys = _ref_keys(dtype)
        confirmed_mask = np.fromiter(
            (k in ref_keys for k in _keys(rows_u, dtype)),
            dtype=bool, count=len(counts_u),
        )
        conf_ind = int(counts_u[confirmed_mask].sum())
        uniq_conf = int(confirmed_mask.sum())
        covered = uniq_conf  # distinct ref cells hit by this model
        return {
            "model": name,
            "N_persons": int(N),
            "confirmed_individual_count": conf_ind,
            "confirmed_individual_pct": conf_ind / max(N, 1),
            "non_confirmed_individual_count": int(N - conf_ind),
            "non_confirmed_individual_pct": (N - conf_ind) / max(N, 1),
            "unique_confirmed_count": uniq_conf,
            "unique_non_confirmed_count": int(len(rows_u) - uniq_conf),
            "unique_confirmed_pct_of_ref_unique": uniq_conf / max(n_ref_unique, 1),
            "ref_coverage_by_confirmed_unique": covered / max(n_ref_unique, 1),
        }

    rows = [stats("ref", ref)] + [stats(m["name"], m) for m in models]
    _write(outdir, "raw_counts_schedule_confirmation.csv", rows)


def metric_raw_home_patterns(ref: Dict, models: List[Dict], outdir: str):
    """Writes raw_counts_home_patterns.csv: start/end/bound/all-day home
    counts and rates (home index from the reference purpose_map)."""
    ensure_dir(outdir)
    pm = ref["purpose_map"]
    if "Home" not in pm:
        raise ValueError("'Home' not found in ref purpose_map.")
    home = int(pm["Home"])

    def stats(name, Y):
        N = Y.shape[0]
        if N == 0 or Y.shape[1] == 0:
            raise ValueError(f"Dataset {name} is empty.")
        start = Y[:, 0] == home
        end = Y[:, -1] == home
        bound = start & end
        all_day = (Y == home).all(axis=1)
        return {
            "model": name,
            "N_persons": int(N),
            "start_home_count": int(start.sum()),
            "start_home_pct": float(start.mean()),
            "end_home_count": int(end.sum()),
            "end_home_pct": float(end.mean()),
            "home_bound_count": int(bound.sum()),
            "home_bound_pct": float(bound.mean()),
            "non_home_bound_count": int((~bound).sum()),
            "non_home_bound_pct": float((~bound).mean()),
            "home_all_day_count": int(all_day.sum()),
            "home_all_day_pct": float(all_day.mean()),
        }

    rows = [stats("ref", ref["Y"])] + [stats(m["name"], m["Y"]) for m in models]
    _write(outdir, "raw_counts_home_patterns.csv", rows)


RAW_COUNTS_FUNCS = {
    "raw_cells": metric_raw_cells,
    "raw_schedules": metric_raw_schedules,
    "raw_home": metric_raw_home_patterns,
}
