"""Start-time JSD per n-gram (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/tod_jsd.py``;
reference extract_metrics/tod_jsd.py:9-189): for each n in {1..4}, per-key histograms over start bins t=0..T-n, JSD
between ref and model per key, macro + reference-support-weighted averages,
plus n=1 per-key detail.

Vectorized: the (key, start-bin) histogram is one bincount over
``code_index * Tn + t`` after np.unique over window codes.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.losses.jsd import jsd
from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    ensure_dir,
    ngram_code_matrix,
)


# dense (P^n, Tn) table budget for the native path: 2^24 int64 entries
# (128 MB); P=8, n<=4, T=288 uses at most ~9 MB
_DENSE_HIST_MAX = 2**24


def _start_hist_matrix(Y: np.ndarray, n: int, P: int):
    """Returns (codes (K,), hists (K, Tn)) of n-gram start-time counts.

    Native C++ dense-table pass when built and P^n * Tn fits the budget
    (50-200x over the unique+bincount path at 100k x 288, identical
    outputs); numpy otherwise.
    """
    from ananke_abm_tpu_torch.ops import native  # lazy: avoids import cycle

    native.check_labels(Y, P)  # uniform across both branches
    Tn = Y.shape[1] - n + 1
    if Tn > 0 and 0 < P**n * Tn <= _DENSE_HIST_MAX:
        if native.available():
            dense = native.ngram_start_hist_dense(Y, n, P)  # (P^n, Tn)
            codes = np.nonzero(dense.sum(axis=1))[0]
            return codes, dense[codes].astype(np.float64)
    code_mat = ngram_code_matrix(Y, n, P)  # (N, Tn)
    N, Tn = code_mat.shape
    if Tn == 0:
        return np.zeros(0, np.int64), np.zeros((0, 0))
    codes, inv = np.unique(code_mat.ravel(), return_inverse=True)
    t_idx = np.tile(np.arange(Tn), N)
    flat = inv * Tn + t_idx
    hists = np.bincount(flat, minlength=len(codes) * Tn).reshape(
        len(codes), Tn
    )
    return codes, hists.astype(np.float64)


def _norm_rows(h: np.ndarray, eps: float = 1e-12):
    s = h.sum(axis=1, keepdims=True)
    return np.divide(h, s, out=np.zeros_like(h), where=s > eps)


def _tod_jsd_core(Y_ref, Y_syn, n, P):
    codes_r, h_r = _start_hist_matrix(Y_ref, n, P)
    codes_s, h_s = _start_hist_matrix(Y_syn, n, P)
    Tn = Y_ref.shape[1] - n + 1
    keys = np.union1d(codes_r, codes_s)
    if keys.size == 0:
        return 0.0, 0.0, keys, np.zeros(0)

    HR = np.zeros((keys.size, Tn))
    HS = np.zeros((keys.size, Tn))
    if codes_r.size:
        HR[np.searchsorted(keys, codes_r)] = h_r[:, :Tn]
    if codes_s.size:
        HS[np.searchsorted(keys, codes_s), : h_s.shape[1]] = h_s[:, :Tn]

    support = HR.sum(axis=1)
    PR = _norm_rows(HR)
    PS = _norm_rows(HS)
    vals = np.array([jsd(PR[k], PS[k]) for k in range(keys.size)])
    macro = float(vals.mean()) if vals.size else 0.0
    tot = support.sum()
    weighted = float((support / tot * vals).sum()) if tot > 0 else macro
    return macro, weighted, keys, vals


def metric_tod_jsd_ngram(ref: Dict, models: List[Dict], outdir: str):
    """Writes tod_jsd_macro.csv [n, model, tod_jsd_macro],
    tod_jsd_weighted.csv [n, model, tod_jsd_weighted],
    tod_jsd_detail_n1.csv [model, key, jsd]."""
    ensure_dir(outdir)
    Y_ref = ref["Y"]
    P = len(ref["purpose_map"])
    inv_pm = {v: k for k, v in ref["purpose_map"].items()}
    T = Y_ref.shape[1]
    ns = [n for n in (1, 2, 3, 4) if n <= T]

    macro_rows, weighted_rows, detail_rows = [], [], []
    for n in ns:
        for m in models:
            macro, weighted, keys, vals = _tod_jsd_core(Y_ref, m["Y"], n, P)
            macro_rows.append(
                {"n": n, "model": m["name"], "tod_jsd_macro": macro}
            )
            weighted_rows.append(
                {"n": n, "model": m["name"], "tod_jsd_weighted": weighted}
            )
            if n == 1:
                for k, v in zip(keys, vals):
                    detail_rows.append(
                        {
                            "model": m["name"],
                            "key": inv_pm.get(int(k), str(int(k))),
                            "jsd": float(v),
                        }
                    )

    def _write(name, rows, fields):
        with open(os.path.join(outdir, name), "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)

    _write("tod_jsd_macro.csv", macro_rows, ["n", "model", "tod_jsd_macro"])
    _write(
        "tod_jsd_weighted.csv", weighted_rows, ["n", "model", "tod_jsd_weighted"]
    )
    if detail_rows:
        _write("tod_jsd_detail_n1.csv", detail_rows, ["model", "key", "jsd"])


TOD_JSD_FUNCS = {"tod_jsd_ngram": metric_tod_jsd_ngram}
