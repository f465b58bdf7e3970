"""latent_ode data processing: persona timelines -> per-person samples and
the unified-timeline batch (port of
``ananke_abm_tpu/models/latent_ode/data.py``, numpy as it is):
- per-person arrays: event times, zone observations, purpose/mode ids +
  rich feature vectors, anchor-importance weights (x anchor_loss_weight),
  zone features, distance matrix;
- unified timeline: union of all event times; dense (B, T_u) targets with
  -1 padding; loss mask only at real points (unless
  train_on_interpolated_points) scaled by importance; prev/next real-point
  indices (searchsorted) for time-weighted embedding targets; "intelligent
  fill" of purpose (travel id when endpoints differ) and mode between real
  points.

The fill is computed from the prev/next index arrays in O(B*T) numpy.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ananke_abm_tpu_torch.data_generator.features import (
    MODE_ID_MAP,
    MODE_TABLE,
    PURPOSE_ID_MAP,
    PURPOSE_TABLE,
)
from ananke_abm_tpu_torch.data_generator.mock_world import get_persona, persona_timeline
from ananke_abm_tpu_torch.models.latent_ode.config import GenerativeODEConfig

TRAVEL_ID = PURPOSE_ID_MAP["travel"]
STAY_MODE_ID = MODE_ID_MAP["stay"]


def get_person_sample(person_id: int, config: GenerativeODEConfig) -> Dict:
    """One person's training sample (reference DataProcessor.get_data)."""
    tl = persona_timeline(get_persona(person_id))
    imp = np.where(
        tl["anchors"] == 1, config.anchor_loss_weight, 1.0
    ).astype(np.float32)
    return {
        "person_id": person_id,
        "person_name": tl["person_name"],
        "person_features": tl["person_attrs"],
        "times": tl["times"],
        "trajectory_y": tl["zone_ids"],
        "target_purpose_ids": tl["purpose_ids"],
        "target_mode_ids": tl["mode_ids"],
        "target_purpose_features": PURPOSE_TABLE[tl["purpose_ids"]],
        "target_mode_features": MODE_TABLE[tl["mode_ids"]],
        "importance_weights": imp,
        "home_zone_id": tl["home_zone_id"],
        "work_zone_id": tl["work_zone_id"],
        "zone_features": tl["zone_features"],
        "distance_matrix": tl["distance_matrix"],
    }


def unify_and_interpolate_batch(
    samples: List[Dict], config: GenerativeODEConfig
) -> Dict:
    """Collate samples onto the unified timeline. All outputs numpy."""
    t_unified = np.unique(np.concatenate([s["times"] for s in samples]))
    T = t_unified.shape[0]
    B = len(samples)
    pf = config.purpose_feature_dim
    mf = config.mode_feature_dim

    y_loc = np.full((B, T), -1, np.int64)
    y_purp = np.full((B, T), -1, np.int64)
    y_mode = np.full((B, T), -1, np.int64)
    y_purp_feat = np.zeros((B, T, pf), np.float32)
    y_mode_feat = np.zeros((B, T, mf), np.float32)
    loss_mask = np.ones((B, T), np.float32) if config.train_on_interpolated_points else np.zeros((B, T), np.float32)
    importance = np.ones((B, T), np.float32)
    prev_idx = np.zeros((B, T), np.int64)
    next_idx = np.zeros((B, T), np.int64)

    for i, s in enumerate(samples):
        pos = np.searchsorted(t_unified, s["times"])
        y_loc[i, pos] = s["trajectory_y"]
        y_purp[i, pos] = s["target_purpose_ids"]
        y_mode[i, pos] = s["target_mode_ids"]
        y_purp_feat[i, pos] = s["target_purpose_features"]
        y_mode_feat[i, pos] = s["target_mode_features"]
        importance[i, pos] = s["importance_weights"]
        if not config.train_on_interpolated_points:
            loss_mask[i, pos] = 1.0

        # prev/next real indices on the unified axis
        ar = np.arange(T)
        nxt = np.clip(np.searchsorted(pos, ar, side="right"), 0, pos.size - 1)
        prv = np.clip(np.searchsorted(pos, ar, side="left") - 1, 0, pos.size - 1)
        prev_idx[i] = pos[prv]
        next_idx[i] = pos[nxt]

        # intelligent fill between real points, vectorized from prev/next
        interp = y_loc[i] < 0
        p_prev = y_purp[i, prev_idx[i]]
        p_next = y_purp[i, next_idx[i]]
        m_prev = y_mode[i, prev_idx[i]]
        m_next = y_mode[i, next_idx[i]]
        same = p_prev == p_next
        fill_purp = np.where(same, p_prev, TRAVEL_ID)
        trans_mode = np.where(m_prev != STAY_MODE_ID, m_prev, m_next)
        fill_mode = np.where(same, m_prev, trans_mode)
        y_purp[i] = np.where(interp, fill_purp, y_purp[i])
        y_mode[i] = np.where(interp, fill_mode, y_mode[i])

    return {
        "t_unified": t_unified.astype(np.float32),
        "y_loc_dense": y_loc,
        "y_purp_dense": y_purp,
        "y_mode_dense": y_mode,
        "y_purp_feat_dense": y_purp_feat,
        "y_mode_feat_dense": y_mode_feat,
        "loss_mask": loss_mask * importance,
        "prev_real_indices": prev_idx,
        "next_real_indices": next_idx,
        "person_features": np.stack([s["person_features"] for s in samples]),
        "home_zone_ids": np.array([s["home_zone_id"] for s in samples], np.int64),
        "work_zone_ids": np.array([s["work_zone_id"] for s in samples], np.int64),
        "all_zone_features": samples[0]["zone_features"],
        "distance_matrix": samples[0]["distance_matrix"],
        "person_names": [s["person_name"] for s in samples],
        "initial_purpose_features": np.stack(
            [s["target_purpose_features"][0] for s in samples]
        ),
        "initial_mode_features": np.stack(
            [s["target_mode_features"][0] for s in samples]
        ),
    }
