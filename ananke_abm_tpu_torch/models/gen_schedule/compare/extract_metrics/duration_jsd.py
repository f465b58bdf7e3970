"""Duration-distribution JSD (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/
duration_jsd.py``; reference extract_metrics/duration_jsd.py:11-217):
run-length segments -> duration distributions per activity (n=1)
or per segment-n-gram (n=2..4, duration = total span of the window), fixed
grid_min-wide histogram bins to 1440 minutes; macro + ref-support-weighted
JSD per n; per-key detail for n=1.

Segmentation runs through compare.utils.segments_run_length_fast (native
C++ kernel when built, vectorized numpy otherwise); windowing is base-P
code windows over per-person segment purpose sequences.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.losses.jsd import jsd
from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    ensure_dir,
    segments_run_length_fast,
)

HORIZON_MIN = 1440


def _segment_windows(Y: np.ndarray, n: int, P: int, grid_min: int):
    """Per-person windows of n consecutive segments.

    Returns (codes (W,), durations_min (W,)): code = base-P encoding of the
    window's purposes; duration = total minutes spanned by the window.
    """
    person, purpose, length = segments_run_length_fast(Y)
    dur_min = length * grid_min
    if n == 1:
        return purpose.astype(np.int64), dur_min

    # windows must stay within one person
    S = person.shape[0]
    if S < n:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    same = person[: S - n + 1] == person[n - 1 :]
    codes = np.zeros(S - n + 1, dtype=np.int64)
    total = np.zeros(S - n + 1, dtype=np.int64)
    for i in range(n):
        codes = codes * P + purpose[i : S - n + 1 + i]
        total = total + dur_min[i : S - n + 1 + i]
    return codes[same], total[same]


def _duration_hists(codes, durations, grid_min: int, num_codes=None):
    """(keys (K,), hists (K, B)) histogram of durations per key with
    grid_min-wide bins up to HORIZON_MIN.

    With ``num_codes`` (= P**n: codes live in [0, num_codes)) and a
    dense table within budget, one bincount replaces the np.unique
    sort over all window codes (~10M at 1M persons)."""
    nbins = HORIZON_MIN // grid_min
    bin_idx = np.clip(durations // grid_min - 1, 0, nbins - 1)
    if (
        num_codes is not None
        and 0 < num_codes * nbins <= 2**24
        # labels outside the purpose_map (codes >= P^n) keep the unique
        # path, which simply counts the extra keys like the reference
        and (codes.size == 0 or (codes.min() >= 0
                                 and codes.max() < num_codes))
    ):
        flat = codes * nbins + bin_idx
        dense = np.bincount(flat, minlength=num_codes * nbins).reshape(
            num_codes, nbins
        )
        keys = np.nonzero(dense.sum(axis=1))[0]
        return keys, dense[keys].astype(np.float64)
    keys, inv = np.unique(codes, return_inverse=True)
    flat = inv * nbins + bin_idx
    hists = np.bincount(flat, minlength=keys.size * nbins).reshape(
        keys.size, nbins
    )
    return keys, hists.astype(np.float64)


def _norm_rows(h, eps=1e-12):
    s = h.sum(axis=1, keepdims=True)
    return np.divide(h, s, out=np.zeros_like(h), where=s > eps)


def metric_duration_jsd_ngram_specific(
    ref: Dict, models: List[Dict], outdir: str, n: int = 1
):
    """Writes duration_jsd_macro_n{n}.csv [model, macro_jsd, weighted_jsd,
    K_keys]; duration_jsd_n1.csv [model, key, count_ref, count_model, jsd]
    for n == 1 only."""
    ensure_dir(outdir)
    P = len(ref["purpose_map"])
    grid_min = ref.get("grid_min") or 5
    inv_pm = {v: k for k, v in ref["purpose_map"].items()}

    codes_r, durs_r = _segment_windows(ref["Y"], n, P, grid_min)
    keys_r, h_r = _duration_hists(codes_r, durs_r, grid_min, P**n)

    macro_rows, detail_rows = [], []
    for m in models:
        codes_s, durs_s = _segment_windows(m["Y"], n, P, grid_min)
        keys_s, h_s = _duration_hists(codes_s, durs_s, grid_min, P**n)
        keys = np.union1d(keys_r, keys_s)
        nb = h_r.shape[1] if h_r.size else (HORIZON_MIN // grid_min)
        HR = np.zeros((keys.size, nb))
        HS = np.zeros((keys.size, nb))
        if keys_r.size:
            HR[np.searchsorted(keys, keys_r)] = h_r
        if keys_s.size:
            HS[np.searchsorted(keys, keys_s)] = h_s
        support = HR.sum(axis=1)
        PR, PS = _norm_rows(HR), _norm_rows(HS)
        vals = np.array([jsd(PR[k], PS[k]) for k in range(keys.size)])
        macro = float(vals.mean()) if vals.size else 0.0
        tot = support.sum()
        weighted = float((support / tot * vals).sum()) if tot > 0 else macro
        macro_rows.append(
            {
                "model": m["name"],
                "macro_jsd": macro,
                "weighted_jsd": weighted,
                "K_keys": int(keys.size),
            }
        )
        if n == 1:
            for i, k in enumerate(keys):
                detail_rows.append(
                    {
                        "model": m["name"],
                        "key": inv_pm.get(int(k), str(int(k))),
                        "count_ref": int(HR[i].sum()),
                        "count_model": int(HS[i].sum()),
                        "jsd": float(vals[i]),
                    }
                )

    with open(
        os.path.join(outdir, f"duration_jsd_macro_n{n}.csv"), "w",
        newline="", encoding="utf-8",
    ) as f:
        w = csv.DictWriter(
            f, fieldnames=["model", "macro_jsd", "weighted_jsd", "K_keys"]
        )
        w.writeheader()
        w.writerows(macro_rows)
    if n == 1 and detail_rows:
        with open(
            os.path.join(outdir, "duration_jsd_n1.csv"), "w",
            newline="", encoding="utf-8",
        ) as f:
            w = csv.DictWriter(
                f,
                fieldnames=["model", "key", "count_ref", "count_model", "jsd"],
            )
            w.writeheader()
            w.writerows(detail_rows)


def metric_duration_jsd_ngram(ref: Dict, models: List[Dict], outdir: str):
    for n in (1, 2, 3, 4):
        metric_duration_jsd_ngram_specific(ref, models, outdir, n=n)


DURATION_JSD_FUNCS = {"duration_jsd_ngram": metric_duration_jsd_ngram}
