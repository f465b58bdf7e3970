"""Evaluation report, numpy (a copy of
``ananke_abm_tpu/models/gen_schedule/evals/report.py``): P, L, home_idx,
minutes_share {synth, ref, abs_error}, bigram {L1}, tod_jsd_macro,
all_home_rate, start/end_home_rate, diversity_ratio."""
from __future__ import annotations

import json
import os

import numpy as np

from ananke_abm_tpu_torch.losses.jsd import jsd
from ananke_abm_tpu_torch.models.gen_schedule.evals.metrics import (
    bigram_matrix,
    l1_distance,
    minutes_share,
    tod_marginals,
)


def compute_all_home_rate(Y, home_idx) -> float:
    return float(np.mean((Y == home_idx).all(axis=1)))


def start_end_home_stats(Y, home_idx):
    return float(np.mean(Y[:, 0] == home_idx)), float(np.mean(Y[:, -1] == home_idx))


def diversity_ratio(Y) -> float:
    """unique schedules / N: each row viewed as one void scalar, so
    ``np.unique`` compares rows with memcmp (ids below 256 as a byte each)."""
    rows = np.ascontiguousarray(Y)
    if rows.size and rows.min() >= 0 and rows.max() < 256:
        rows = rows.astype(np.uint8)
    rows = rows.view(np.dtype((np.void, rows.itemsize * rows.shape[1])))
    return float(np.unique(rows).size) / float(len(Y))


def make_report(Y_synth, Y_ref, purpose_map, ref_tod=None) -> dict:
    P = len(purpose_map)
    L = Y_synth.shape[1]
    home_idx = purpose_map.get("Home")
    if home_idx is None:
        vals, counts = np.unique(Y_ref[:, 0], return_counts=True)
        home_idx = int(vals[np.argmax(counts)])

    share_syn = minutes_share(Y_synth, P)
    share_ref = minutes_share(Y_ref, P)

    m_syn = tod_marginals(Y_synth, P)
    m_ref = ref_tod if ref_tod is not None else tod_marginals(Y_ref, P)

    b_l1 = l1_distance(bigram_matrix(Y_synth, P), bigram_matrix(Y_ref, P))
    start_home, end_home = start_end_home_stats(Y_synth, home_idx)
    jsds = [jsd(m_ref[t], m_syn[t]) for t in range(L)]

    return {
        "P": P,
        "L": int(L),
        "home_idx": int(home_idx),
        "minutes_share": {
            "synth": share_syn.tolist(),
            "ref": share_ref.tolist(),
            "abs_error": np.abs(share_syn - share_ref).tolist(),
        },
        "bigram": {"L1": b_l1},
        "tod_jsd_macro": float(np.mean(jsds)),
        "all_home_rate": compute_all_home_rate(Y_synth, home_idx),
        "start_home_rate": start_home,
        "end_home_rate": end_home,
        "diversity_ratio": diversity_ratio(Y_synth),
    }


def save_report(report: dict, out_json: str):
    d = os.path.dirname(out_json)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
