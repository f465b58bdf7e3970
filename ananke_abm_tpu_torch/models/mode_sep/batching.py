"""Union time-grid batching for the trajectory models, host-side numpy
(port of ``ananke_abm_tpu/models/mode_sep/batching.py``):

- times_union: sorted union of every person's snap times + K internal
  points strictly inside each gap.
- is_gt (B,T): union time matches one of the person's snap times (tol).
- snap_indices (B,T): index into the person's snap arrays, -1 elsewhere.
- stay_mask / stay_loc_ids: union times inside the person's stay segments.
- gt_interior: GT snaps excluding each person's first and last.
- stay_non_gt: inside stays but not at snaps.
- travel_mask / prev_zone / dest_zone / progress: interior points of
  segments between consecutive GT snaps with a zone change.

The per-time interval tests are vectorized with searchsorted; the remaining
loops are per person and per segment (small host-side preparation, run
once per dataset).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ananke_abm_tpu_torch.models.mode_sep.data import PersonData


@dataclasses.dataclass
class UnionBatch:
    times_union: np.ndarray  # (T,) float32
    is_gt: np.ndarray  # (B, T) bool
    snap_indices: np.ndarray  # (B, T) int64, -1 where not GT
    y_union: np.ndarray  # (B, T) int64 zone id at GT snaps, -1 elsewhere
    stay_mask: np.ndarray  # (B, T) bool
    stay_loc_ids: np.ndarray  # (B, T) int64, -1 outside stays
    gt_interior: np.ndarray  # (B, T) bool
    stay_non_gt: np.ndarray  # (B, T) bool
    travel_mask: np.ndarray  # (B, T) bool
    prev_zone: np.ndarray  # (B, T) int64
    dest_zone: np.ndarray  # (B, T) int64
    progress: np.ndarray  # (B, T) float32
    home_idx: np.ndarray  # (B,)
    work_idx: np.ndarray  # (B,)
    traits: np.ndarray  # (B, 2)
    min_dt: float


def insert_internal_points(sorted_times: np.ndarray, K: int) -> np.ndarray:
    """K points strictly inside each gap of a sorted unique time vector."""
    if sorted_times.size <= 1 or K <= 0:
        return sorted_times
    t0 = sorted_times[:-1, None]
    t1 = sorted_times[1:, None]
    frac = (np.arange(1, K + 1) / (K + 1))[None, :]
    internal = t0 + (t1 - t0) * frac  # (G, K)
    return np.unique(np.concatenate([sorted_times, internal.ravel()]))


def build_union_batch(
    persons: List[PersonData],
    K_internal: int = 8,
    tol: float = 1e-6,
) -> UnionBatch:
    if not persons:
        raise ValueError("No persons in batch.")
    all_times = np.concatenate(
        [p.times_snap for p in persons if p.times_snap.size]
    )
    if all_times.size == 0:
        raise ValueError("No snap times found for any person in the batch.")
    base = np.unique(all_times.astype(np.float32))
    # snap times within tol are the same instant (the snap matcher below
    # uses the same tolerance); merging them here keeps the union grid
    # strictly increasing even for pathological near-duplicate inputs
    if base.size > 1:
        base = base[np.concatenate([[True], np.diff(base) > tol])]
    times = insert_internal_points(base, K_internal).astype(np.float32)
    # internal points of a micro-interval can collapse in float32
    times = np.unique(times)
    B, T = len(persons), times.shape[0]

    is_gt = np.zeros((B, T), bool)
    snap_idx = np.full((B, T), -1, np.int64)
    y_union = np.full((B, T), -1, np.int64)
    stay_mask = np.zeros((B, T), bool)
    stay_loc = np.full((B, T), -1, np.int64)
    gt_interior = np.zeros((B, T), bool)
    travel_mask = np.zeros((B, T), bool)
    prev_zone = np.full((B, T), -1, np.int64)
    dest_zone = np.full((B, T), -1, np.int64)
    progress = np.zeros((B, T), np.float32)

    for i, p in enumerate(persons):
        if p.times_snap.size:
            # match union times to snap times within tol (both sorted)
            pos = np.searchsorted(p.times_snap, times)
            for cand in (pos - 1, pos):
                c = np.clip(cand, 0, p.times_snap.size - 1)
                hit = np.abs(p.times_snap[c] - times) <= tol
                snap_idx[i] = np.where(hit & (snap_idx[i] < 0), c, snap_idx[i])
            is_gt[i] = snap_idx[i] >= 0
            y_union[i, is_gt[i]] = p.loc_ids[snap_idx[i][is_gt[i]]]

        for (t0, t1, loc) in p.stay_segments:
            in_seg = (times >= t0 - tol) & (times <= t1 + tol)
            stay_mask[i] |= in_seg
            stay_loc[i, in_seg] = loc

        gt_pos = np.nonzero(is_gt[i])[0]
        if gt_pos.size >= 3:
            gt_interior[i, gt_pos[1:-1]] = True

        if gt_pos.size >= 2:
            z_seq = p.loc_ids[snap_idx[i][gt_pos]]
            for a in range(gt_pos.size - 1):
                j0, j1 = int(gt_pos[a]), int(gt_pos[a + 1])
                z0, z1 = int(z_seq[a]), int(z_seq[a + 1])
                if z0 != z1 and j1 - j0 > 1:
                    sl = slice(j0 + 1, j1)
                    travel_mask[i, sl] = True
                    prev_zone[i, sl] = z0
                    dest_zone[i, sl] = z1
                    denom = max(times[j1] - times[j0], 1e-8)
                    progress[i, sl] = np.clip(
                        (times[j0 + 1 : j1] - times[j0]) / denom, 0.0, 1.0
                    )

    stay_non_gt = stay_mask & ~is_gt
    diffs = np.diff(times)
    return UnionBatch(
        times_union=times,
        is_gt=is_gt,
        snap_indices=snap_idx,
        y_union=y_union,
        stay_mask=stay_mask,
        stay_loc_ids=stay_loc,
        gt_interior=gt_interior,
        stay_non_gt=stay_non_gt,
        travel_mask=travel_mask,
        prev_zone=prev_zone,
        dest_zone=dest_zone,
        progress=progress,
        home_idx=np.array([p.home_zone_idx for p in persons], np.int64),
        work_idx=np.array([p.work_zone_idx for p in persons], np.int64),
        traits=np.stack([p.traits_raw for p in persons]).astype(np.float32),
        min_dt=float(diffs.min()) if diffs.size else 1.0,
    )
