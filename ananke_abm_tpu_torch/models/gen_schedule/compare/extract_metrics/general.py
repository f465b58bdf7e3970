"""General comparison metrics (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/general.py``;
reference extract_metrics/general.py:59-233): minutes-share levels +
abs-error CSVs, macro ToD JSD, bigram L1."""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.losses.jsd import jsd
from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import ensure_dir
from ananke_abm_tpu_torch.models.gen_schedule.evals.metrics import (
    bigram_matrix,
    l1_distance,
    minutes_share,
    tod_marginals,
)


def _write_csv(path: str, rows: List[dict]):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def _purpose_order(purpose_map: Dict[str, int]):
    inv = {v: k for k, v in purpose_map.items()}
    idxs = sorted(inv)
    return idxs, [inv[i] for i in idxs]


def metric_minutes_share(ref: Dict, models: List[Dict], outdir: str):
    """Writes minutes_share_levels.csv (model, share_<purpose>...) and
    minutes_share_abs_error.csv (model, abs_error_<purpose>..., mean_abs_error)."""
    ensure_dir(outdir)
    P = len(ref["purpose_map"])
    idxs, names = _purpose_order(ref["purpose_map"])
    share_ref = minutes_share(ref["Y"], P)

    rows_levels = [
        {"model": "ref", **{f"share_{n}": float(share_ref[i]) for i, n in zip(idxs, names)}}
    ]
    rows_err = []
    for m in models:
        share = minutes_share(m["Y"], P)
        rows_levels.append(
            {"model": m["name"], **{f"share_{n}": float(share[i]) for i, n in zip(idxs, names)}}
        )
        errs = {f"abs_error_{n}": float(abs(share[i] - share_ref[i])) for i, n in zip(idxs, names)}
        rows_err.append(
            {"model": m["name"], **errs,
             "mean_abs_error": float(np.mean(list(errs.values())))}
        )
    _write_csv(os.path.join(outdir, "minutes_share_levels.csv"), rows_levels)
    if rows_err:
        _write_csv(os.path.join(outdir, "minutes_share_abs_error.csv"), rows_err)


def metric_tod_jsd_macro(ref: Dict, models: List[Dict], outdir: str):
    """Writes tod_jsd.csv (model, tod_jsd_macro) — mean over bins of the
    JSD between per-bin purpose marginals."""
    ensure_dir(outdir)
    P = len(ref["purpose_map"])
    m_ref = tod_marginals(ref["Y"], P)
    rows = [{"model": "ref", "tod_jsd_macro": 0.0}]
    for m in models:
        m_syn = tod_marginals(m["Y"], P)
        vals = [jsd(m_ref[t], m_syn[t]) for t in range(m_ref.shape[0])]
        rows.append({"model": m["name"], "tod_jsd_macro": float(np.mean(vals))})
    _write_csv(os.path.join(outdir, "tod_jsd.csv"), rows)


def metric_bigram_l1(ref: Dict, models: List[Dict], outdir: str):
    """Writes bigram_L1.csv (model, bigram_L1)."""
    ensure_dir(outdir)
    P = len(ref["purpose_map"])
    b_ref = bigram_matrix(ref["Y"], P)
    rows = [{"model": "ref", "bigram_L1": 0.0}]
    for m in models:
        rows.append(
            {
                "model": m["name"],
                "bigram_L1": l1_distance(bigram_matrix(m["Y"], P), b_ref),
            }
        )
    _write_csv(os.path.join(outdir, "bigram_L1.csv"), rows)


GENERAL_FUNCS = {
    "minutes_share": metric_minutes_share,
    "tod_jsd_macro_bins": metric_tod_jsd_macro,
    "bigram_L1": metric_bigram_l1,
}
