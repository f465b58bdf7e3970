"""mode_sep evaluation -> metrics.json (port of
``ananke_abm_tpu/models/mode_sep/evaluate.py``):
- snap accuracy and mean expected distance at GT snaps,
- ROC-AUC of |v| separating stay vs travel points (Mann–Whitney U
  formulation, computed via rank statistics),
- transition sharpness around zone changes,
- stay-detection confusion (nearest-class-embedding distance <= tau on
  non-GT points) with precision/recall/F1.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ananke_abm_tpu_torch.models.mode_sep.batching import build_union_batch
from ananke_abm_tpu_torch.models.mode_sep.data import load_trajectory_csvs
from ananke_abm_tpu_torch.models.mode_sep.inference import load_model, rollout


def rank_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """AUC = P(pos > neg) via the rank-sum (Mann–Whitney) statistic."""
    if pos.size == 0 or neg.size == 0:
        return float("nan")
    all_v = np.concatenate([pos, neg])
    order = all_v.argsort(kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    sorted_v = all_v[order]
    ranks[order] = np.arange(1, all_v.size + 1)
    _, inv, counts = np.unique(sorted_v, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg = (cum - (counts - 1) / 2.0)
    ranks[order] = avg[inv]
    r_pos = ranks[: pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


def evaluate(
    ckpt_path: str,
    periods_csv: str,
    snaps_csv: str,
    outdir: str,
    zones_csv: str | None = None,
    persons_csv: str | None = None,
    dist_mat_csv: str | None = None,
    *,
    device="cuda",
) -> dict:
    os.makedirs(outdir, exist_ok=True)
    model, config, _ = load_model(ckpt_path, device=device)
    people, shared = load_trajectory_csvs(
        periods_csv, snaps_csv, zones_csv, persons_csv, dist_mat_csv
    )
    union = build_union_batch(people, config.K_internal, config.time_match_tol)

    pred_emb, logits, v = rollout(
        model, config,
        union.times_union, union.home_idx, union.work_idx, union.traits,
    )
    pred = logits.argmax(-1)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    v_abs = np.linalg.norm(v, axis=-1)

    is_gt = union.is_gt
    y = union.y_union

    # snap accuracy + expected distance
    correct = ((pred == y) & is_gt).sum()
    acc = float(correct / max(1, is_gt.sum()))
    gt_rows = shared.dist_mat[np.maximum(y, 0)]  # (B, T, Z)
    exp_d = (gt_rows * probs).sum(-1)
    mean_exp_dist = float(exp_d[is_gt].mean()) if is_gt.any() else float("nan")

    # |v| stay-vs-travel separation AUC
    stay_pts = v_abs[union.stay_non_gt]
    travel_pts = v_abs[union.travel_mask]
    auc = rank_auc(travel_pts, stay_pts)

    # transition sharpness: |v| near zone-change midpoints vs stay baseline
    sharp = (
        float(travel_pts.mean() / (stay_pts.mean() + 1e-8))
        if travel_pts.size and stay_pts.size
        else float("nan")
    )

    # stay detection by embedding distance <= tau on non-GT points
    table = model.class_table.detach().cpu().numpy()
    d_all = np.linalg.norm(
        pred_emb[:, :, None, :] - table[None, None, :, :], axis=-1
    ).min(-1)
    detected_stay = d_all <= config.tau_stay_embed
    non_gt = ~is_gt
    tp = int((detected_stay & union.stay_mask & non_gt).sum())
    fp = int((detected_stay & ~union.stay_mask & non_gt).sum())
    fn = int((~detected_stay & union.stay_mask & non_gt).sum())
    tn = int((~detected_stay & ~union.stay_mask & non_gt).sum())
    precision = tp / max(1, tp + fp)
    recall = tp / max(1, tp + fn)
    f1 = 2 * precision * recall / max(1e-9, precision + recall)

    metrics = {
        "snap_accuracy": acc,
        "mean_expected_distance_km": mean_exp_dist,
        "velocity_stay_travel_auc": auc,
        "transition_sharpness": sharp,
        "stay_detection": {
            "tp": tp, "fp": fp, "fn": fn, "tn": tn,
            "precision": precision, "recall": recall, "f1": f1,
            "tau": config.tau_stay_embed,
        },
        "n_persons": len(people),
        "n_union_times": int(union.times_union.shape[0]),
    }
    with open(os.path.join(outdir, "metrics.json"), "w", encoding="utf-8") as f:
        json.dump(metrics, f, indent=2)
    return metrics
