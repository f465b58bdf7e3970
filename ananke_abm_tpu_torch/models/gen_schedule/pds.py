"""Purpose Distribution Space (PDS) statistics, numpy host code (a copy of
``ananke_abm_tpu/models/gen_schedule/pds.py``, which the port does not
import).

Artifacts:
``<out>_pds.npz`` with m_tod (P,T), start_rate (P,T), presence_rate (P,),
first/last-occurrence mean/std minutes (P,), purpose_names_ordered,
grid_min, T, N_persons; plus ``<out>_pds_summary.json``.

All per-purpose Python loops are replaced by one-hot/bincount numpy
(O(N*T) total instead of O(P*N*T)).
"""
from __future__ import annotations

import json
import os

import numpy as np


def compute_time_of_day_marginal(Y: np.ndarray, P: int) -> np.ndarray:
    """m_tod[p, t] = Pr(y_t == p). Shape (P, T)."""
    N, T = Y.shape
    flat = (np.arange(T)[None, :] * P + Y).ravel()
    counts = np.bincount(flat, minlength=T * P).reshape(T, P)
    return (counts.astype(np.float64) / N).T


def compute_start_rate(Y: np.ndarray, P: int) -> np.ndarray:
    """start_rate[p, t] = Pr(a new segment of p starts at t). Shape (P, T)."""
    N, T = Y.shape
    starts = np.ones_like(Y, dtype=bool)
    starts[:, 1:] = Y[:, 1:] != Y[:, :-1]
    flat = (np.arange(T)[None, :] * P + Y)[starts]
    counts = np.bincount(flat.ravel(), minlength=T * P).reshape(T, P)
    return (counts.astype(np.float64) / N).T


def compute_presence_rate(Y: np.ndarray, P: int) -> np.ndarray:
    """presence_rate[p] = Pr(person ever does p). Shape (P,)."""
    N, _ = Y.shape
    present = np.zeros((N, P), dtype=bool)
    present[np.arange(N)[:, None], Y] = True
    return present.mean(axis=0)


def summarize_first_last_minutes(Y: np.ndarray, P: int, grid_min: int):
    """Mean/std (minutes) of first and last occurrence per purpose, over the
    persons who ever perform it. NaN where a purpose never occurs."""
    N, T = Y.shape
    onehot = Y[:, :, None] == np.arange(P)[None, None, :]  # (N, T, P)
    has = onehot.any(axis=1)  # (N, P)

    first_idx = np.argmax(onehot, axis=1)  # (N, P), 0 when absent
    last_idx = T - 1 - np.argmax(onehot[:, ::-1, :], axis=1)

    def stats(idx):
        mins = idx.astype(np.float64) * grid_min
        mean = np.full(P, np.nan)
        std = np.full(P, np.nan)
        for p in range(P):  # P is tiny (7); rows are vectorized
            v = mins[has[:, p], p]
            if v.size:
                mean[p] = v.mean()
                std[p] = v.std(ddof=0)
        return mean, std

    start_mean, start_std = stats(first_idx)
    end_mean, end_std = stats(last_idx)
    return start_mean, start_std, end_mean, end_std


def compute_pds(
    grid_npz: str,
    out_prefix: str,
    grid_min: int,
    purpose_json: str | None = None,
):
    """Compute and save PDS artifacts; returns the summary dict."""
    d = os.path.dirname(out_prefix)
    if d:
        os.makedirs(d, exist_ok=True)

    data = np.load(grid_npz)
    if "Y" not in data:
        raise RuntimeError("Expected 'Y' in grid npz.")
    Y = data["Y"].astype(np.int64)
    N, T = Y.shape

    if purpose_json and os.path.exists(purpose_json):
        with open(purpose_json, "r", encoding="utf-8") as f:
            pm = json.load(f)
        inv = {idx: name for name, idx in pm.items()}
        P = len(inv)
        names = [inv[i] for i in range(P)]
    else:
        P = int(Y.max()) + 1
        names = [f"p{p}" for p in range(P)]

    m_tod = compute_time_of_day_marginal(Y, P)
    start_rate = compute_start_rate(Y, P)
    presence_rate = compute_presence_rate(Y, P)
    sm, ss, em, es = summarize_first_last_minutes(Y, P, grid_min)

    npz_path = f"{out_prefix}_pds.npz"
    np.savez_compressed(
        npz_path,
        m_tod=m_tod.astype(np.float32),
        start_rate=start_rate.astype(np.float32),
        presence_rate=presence_rate.astype(np.float32),
        start_mean_min=sm.astype(np.float32),
        start_std_min=ss.astype(np.float32),
        end_mean_min=em.astype(np.float32),
        end_std_min=es.astype(np.float32),
        purpose_names_ordered=np.array(names, dtype=object),
        grid_min=np.int32(grid_min),
        T=np.int32(T),
        N_persons=np.int32(N),
    )

    summary = {
        "N_persons": int(N),
        "T": int(T),
        "grid_min": int(grid_min),
        "purposes": [
            {
                "purpose": names[p],
                "presence_rate": float(presence_rate[p]),
                "start_mean_min": None if np.isnan(sm[p]) else float(sm[p]),
                "start_std_min": None if np.isnan(ss[p]) else float(ss[p]),
            }
            for p in range(P)
        ],
        "npz_path": npz_path,
    }
    with open(f"{out_prefix}_pds_summary.json", "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
    return summary
