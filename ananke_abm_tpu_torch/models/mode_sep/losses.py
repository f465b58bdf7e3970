"""mode_sep losses (port of ``ananke_abm_tpu/models/mode_sep/losses.py``).
Every term is a masked mean, so shapes stay fixed whatever the number of
union points that carry supervision. The ``+ 1e-12`` inside both square
roots keeps the gradients finite at v = 0, where the zero-initialised
drift starts."""
from __future__ import annotations

import torch

from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig

# the components, in the reference's order (the columns of curves.csv)
COMPONENTS = ("loss", "ce", "mse", "dist", "travel_margin", "travel_mono",
              "stay_aux", "stay_vel", "move_vel", "acc")


def _masked_mean(values, mask):
    m = mask.to(values.dtype)
    return torch.sum(values * m) / torch.sum(m).clamp_min(1.0)


def ce_at_mask(logits, y, mask):
    """CE of logits against labels y over masked positions (y may be -1
    outside)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y.clamp_min(0)[..., None])[..., 0]
    return _masked_mean(nll, mask)


def mse_at_mask(pred_emb, y, class_table, mask):
    target = class_table[y.clamp_min(0)]  # junk rows masked away
    return _masked_mean(torch.sum((pred_emb - target) ** 2, -1), mask)


def expected_distance_at_mask(logits, y, dist_mat, mask):
    probs = torch.softmax(logits, dim=-1)
    gt_rows = dist_mat[y.clamp_min(0)]  # (B, T, Z)
    return _masked_mean(torch.sum(gt_rows * probs, -1), mask)


def _dist_to_classes(pred_emb, table, idx):
    target = table[idx.clamp_min(0)]
    return torch.sqrt(torch.sum((pred_emb - target) ** 2, -1) + 1e-12)


def travel_margin_loss(pred_emb, table, travel_mask, prev_idx, dest_idx, m):
    d_prev = _dist_to_classes(pred_emb, table, prev_idx)
    d_dest = _dist_to_classes(pred_emb, table, dest_idx)
    hinge = torch.clamp_min(m - (d_prev - d_dest), 0.0)
    return _masked_mean(hinge, travel_mask)


def travel_monotonicity_loss(pred_emb, table, travel_mask, prev_idx,
                             dest_idx, eps):
    """Finite differences: move away from prev and toward dest inside a
    travel segment (the same prev / dest on consecutive points)."""
    d_prev = _dist_to_classes(pred_emb, table, prev_idx)
    d_dest = _dist_to_classes(pred_emb, table, dest_idx)
    pair = (travel_mask[:, :-1] & travel_mask[:, 1:]
            & (prev_idx[:, :-1] == prev_idx[:, 1:])
            & (dest_idx[:, :-1] == dest_idx[:, 1:]))
    away = torch.clamp_min(d_prev[:, :-1] - d_prev[:, 1:] + eps, 0.0)
    toward = torch.clamp_min(d_dest[:, 1:] - d_dest[:, :-1] + eps, 0.0)
    return 0.5 * (_masked_mean(away, pair) + _masked_mean(toward, pair))


def total_loss(config: ModeSepConfig, logits, pred_emb, v, class_table,
               dist_mat, batch):
    """The training objective and its components. ``batch``: the
    UnionBatch fields as tensors (``train.BATCH_FIELDS``)."""
    y = batch["y_union"]
    is_gt = batch["is_gt"]

    ce = ce_at_mask(logits, y, is_gt)
    mse = mse_at_mask(pred_emb, y, class_table, is_gt)
    dist = expected_distance_at_mask(logits, y, dist_mat, is_gt)
    t_margin = travel_margin_loss(
        pred_emb, class_table, batch["travel_mask"], batch["prev_zone"],
        batch["dest_zone"], config.m_travel)
    t_mono = travel_monotonicity_loss(
        pred_emb, class_table, batch["travel_mask"], batch["prev_zone"],
        batch["dest_zone"], config.epsilon_mono)

    # aux supervision inside stays at non-snap points
    stay_aux_mask = batch["stay_non_gt"]
    y_stay = batch["stay_loc_ids"]
    aux = (ce_at_mask(logits, y_stay, stay_aux_mask)
           + mse_at_mask(pred_emb, y_stay, class_table, stay_aux_mask)
           + expected_distance_at_mask(logits, y_stay, dist_mat,
                                       stay_aux_mask))

    # velocity regularisation; eps inside the sqrt (|v| has a 0/0
    # gradient at v == 0)
    v_abs = torch.sqrt(torch.sum(v * v, -1) + 1e-12)  # (B, T)
    stay_vel = _masked_mean(v_abs ** 2, stay_aux_mask)
    low = torch.clamp_min(config.v_min_move - v_abs, 0.0)
    high = torch.clamp_min(v_abs - config.v_max_move, 0.0)
    move_vel = _masked_mean(low ** 2 + high ** 2, batch["gt_interior"])

    total = (config.w_ce * ce
             + config.w_mse * mse
             + config.w_dist * dist
             + config.w_travel_margin * t_margin
             + config.w_travel_mono * t_mono
             + config.w_stay_aux * aux
             + config.w_stay_vel_core * stay_vel
             + config.w_move_vel_hinge * move_vel)

    # GT-snap accuracy diagnostic
    pred_idx = torch.argmax(logits, dim=-1)
    correct = ((pred_idx == y) & is_gt).sum()
    acc = correct / is_gt.sum().clamp_min(1)

    comps = dict(zip(COMPONENTS, (total, ce, mse, dist, t_margin, t_mono,
                                  config.w_stay_aux * aux, stay_vel,
                                  move_vel, acc)))
    return total, comps
