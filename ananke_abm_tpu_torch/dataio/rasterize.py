"""Activities CSV -> (N, L) purpose-id grid, numpy (a copy of
``ananke_abm_tpu/dataio/rasterize.py`` without pandas; the numpy branch of
its rasterizer, not the native one).

- purpose map = sorted unique purpose names -> contiguous ids.
- per person (activities ordered by ``stopno``): every positive-duration
  activity gets >= ceil(duration/grid) bins starting at
  ``max(starttime // grid, end of previous activity)``, truncated at the
  horizon; unfilled bins default to purpose id 0.
- home-bound post-process: days must end at Home — shift a trailing
  non-home segment back one bin when the preceding Home run can spare it,
  else force the final bin to Home.
- hard error if any person is all-Home all day.
- artifacts: ``<out>.npz{Y}``, ``<out>_meta.json``, ``<out>_tod.npy``,
  ``<out>_purpose_map.json``, ``<out>_splits.npz{train_idx, val_idx}``.

The activities are a dict of equal-length numpy columns (``read_csv``).
Bin assignment is the closed-form prefix recurrence

    start_i = cumbins_i + running_max_j<=i (nominal_j - cumbins_j)

with the per-person cumsum / cummax taken over contiguous person runs.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np

from ananke_abm_tpu_torch.dataio.splits import seeded_split

PURPOSE_COL = "purpose"
HOME_NAME = "Home"


def _column(values: list) -> np.ndarray:
    """A CSV column as int64, else float64, else str (as pandas infers)."""
    for dtype in (np.int64, np.float64):
        try:
            return np.array(values, dtype=dtype)
        except ValueError:
            pass
    return np.array(values)


def read_csv(path: str) -> dict:
    """A CSV with a header row as {name: numpy column}."""
    with open(path, "r", newline="", encoding="utf-8") as f:
        rows = csv.reader(f)
        names = next(rows)
        cols = list(zip(*rows)) or [()] * len(names)
    return {n: _column(list(c)) for n, c in zip(names, cols)}


def build_purpose_map(purposes) -> dict:
    uniq = np.unique(np.asarray(purposes)).tolist()
    return {p: i for i, p in enumerate(uniq)}


def _purpose_ids(names: np.ndarray, purpose_map: dict) -> np.ndarray:
    """Map purpose names to their ids; raises KeyError on a name the map
    lacks."""
    keys = np.array(sorted(purpose_map))
    ids = np.array([purpose_map[k] for k in keys.tolist()], dtype=np.int64)
    pos = np.clip(np.searchsorted(keys, names), 0, max(len(keys) - 1, 0))
    unknown = keys[pos] != names if names.size else np.zeros(0, bool)
    if unknown.any():
        raise KeyError(f"purposes not in the map: "
                       f"{sorted(set(names[unknown].tolist()))}")
    return ids[pos]


def _run_starts(keys: np.ndarray) -> np.ndarray:
    """For each element of a grouped array, the index where its run of
    equal keys starts."""
    n = keys.size
    new = np.ones(n, dtype=bool)
    new[1:] = keys[1:] != keys[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0))


def _segmented_cumsum(x, starts):
    c = np.cumsum(x)
    return c - (c - x)[starts]


def _segmented_cummax(x, run_id):
    """Running max of x restarted on every run (run_id non-decreasing):
    each run is lifted above the one before it."""
    if x.size == 0:
        return x
    span = int(x.max() - x.min()) + 1
    lifted = x + run_id * span
    return np.maximum.accumulate(lifted) - run_id * span


def rasterize_frame(
    cols: dict, purpose_map: dict, grid_min: int, horizon_min: int = 1440
):
    """Rasterize the whole activities table.

    Args:
        cols: numpy columns persid, stopno, purpose, starttime (min),
            total_duration (min). One row per activity.
        purpose_map: {purpose_name: id}.
        grid_min: minutes per bin.
        horizon_min: day horizon in minutes.

    Returns:
        (Y, persids): Y (N, L) int64 grid, persids list of person ids in
        row order.
    """
    L = horizon_min // grid_min
    order = np.lexsort((cols["stopno"], cols["persid"]))  # stable

    dur = cols["total_duration"][order]
    keep = dur > 0
    order, dur = order[keep], dur[keep].astype(np.int64)

    persid = cols["persid"][order]
    uniq_pers, person_row = np.unique(persid, return_inverse=True)
    n_persons = len(uniq_pers)

    start = np.maximum(cols["starttime"][order].astype(np.int64), 0)
    nominal = start // grid_min
    bins = np.maximum(1, -(-dur // grid_min))  # ceil

    pid = _purpose_ids(cols[PURPOSE_COL][order], purpose_map)

    # prefix recurrence per person: start_i = max(nominal_i, end_{i-1}),
    # end_i = start_i + bins_i (pre-clip): grouped cumsum and cummax over
    # each person's contiguous run of rows
    cumbins = _segmented_cumsum(bins, _run_starts(person_row)) - bins
    runmax = _segmented_cummax(nominal - cumbins, person_row)
    a = cumbins + runmax
    b = a + bins

    # horizon truncation: clip; activities fully past the horizon vanish
    a_c = np.minimum(a, L)
    b_c = np.minimum(b, L)
    lengths = b_c - a_c
    valid = lengths > 0

    Y = np.zeros((n_persons, L), dtype=np.int64)
    if valid.any():
        av, lv, rows, pv = a_c[valid], lengths[valid], person_row[valid], pid[valid]
        total = int(lv.sum())
        starts_flat = rows * L + av
        offsets = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(lv)[:-1]]), lv
        )
        Y.reshape(-1)[np.repeat(starts_flat, lv) + offsets] = np.repeat(pv, lv)

    home_idx = purpose_map.get(HOME_NAME, 0)
    Y = ensure_homebound(Y, home_idx, copy=False)
    return Y, uniq_pers.tolist()


def ensure_homebound(
    Y: np.ndarray, home_idx: int, buffer_size: int = 1, copy: bool = True
):
    """Home-bound post-process. For rows not ending at Home: locate the
    trailing non-home run; if the Home run immediately before it is longer
    than ``buffer_size``, shift the trailing run back by ``buffer_size``
    bins and fill the end with Home; otherwise force the final
    ``buffer_size`` bins to Home. ``copy=False`` mutates Y in place."""
    if copy:
        Y = Y.copy()
    N, L = Y.shape
    bad = Y[:, -1] != home_idx
    if not bad.any():
        return Y

    rows = np.nonzero(bad)[0]
    sub = Y[rows]  # (M, L)
    is_home = sub == home_idx

    has_home = is_home.any(axis=1)
    # last position of home (only meaningful where has_home)
    rev_first = np.argmax(is_home[:, ::-1], axis=1)
    last_home = L - 1 - rev_first

    # length of the home run ending at last_home: scan back for non-home
    col = np.arange(L)
    before_mask = (~is_home) & (col[None, :] <= last_home[:, None])
    any_nonhome_before = before_mask.any(axis=1)
    # last non-home position at-or-before last_home
    rev_nb = np.argmax(before_mask[:, ::-1], axis=1)
    last_nonhome_before = np.where(any_nonhome_before, L - 1 - rev_nb, -1)
    homerun_len = last_home - last_nonhome_before

    shiftable = has_home & (homerun_len > buffer_size)

    # shifted variant: every col >= last_home takes the value of col+shift
    shift = buffer_size
    src = np.minimum(col[None, :] + shift, L - 1)
    taken = np.take_along_axis(sub, src, axis=1)
    shifted = np.where(col[None, :] >= last_home[:, None], taken, sub)
    shifted[:, L - buffer_size :] = home_idx

    forced = sub.copy()
    forced[:, L - buffer_size :] = home_idx

    out = np.where(shiftable[:, None], shifted, forced)
    Y[rows] = out
    return Y


def compute_empirical_tod(Y: np.ndarray, P: int) -> np.ndarray:
    """(L, P) empirical time-of-day marginal, Pr(y_t = p), via bincount."""
    N, L = Y.shape
    flat = (np.arange(L)[None, :] * P + Y).ravel()
    counts = np.bincount(flat, minlength=L * P).reshape(L, P)
    return counts.astype(np.float64) / N


def prepare_from_csv(
    csv_path: str,
    out_path: str,
    grid_min: int = 5,
    horizon_min: int = 1440,
    val_frac: float = 0.1,
    seed: int = 42,
):
    """Full prepare pipeline: CSV -> grid npz + splits + meta + tod (the
    reference's artifacts; splits as ``<out>_splits.npz`` holding
    ``train_idx`` / ``val_idx``)."""
    cols = read_csv(csv_path)
    if "startime" in cols and "starttime" not in cols:
        cols["starttime"] = cols.pop("startime")

    purpose_map = build_purpose_map(cols[PURPOSE_COL])
    inv_map = {v: k for k, v in purpose_map.items()}
    L = horizon_min // grid_min

    Y, persids = rasterize_frame(cols, purpose_map, grid_min, horizon_min)

    home_idx = purpose_map.get(HOME_NAME, 0)
    all_home = (Y == home_idx).all(axis=1)
    n_all_home = int(all_home.sum())
    if n_all_home:
        raise AssertionError(
            f"{n_all_home} persons have all activities as Home"
        )

    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(out_path, Y=Y.astype(np.int64))

    train_idx, val_idx = seeded_split(Y.shape[0], val_frac, seed)
    np.savez(
        out_path.replace(".npz", "_splits.npz"),
        train_idx=train_idx,
        val_idx=val_idx,
    )

    meta = {
        "grid_min": grid_min,
        "horizon_min": horizon_min,
        "L": int(L),
        "purpose_map": purpose_map,
        "inv_purpose_map": inv_map,
        "N": int(Y.shape[0]),
    }
    with open(out_path.replace(".npz", "_meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)

    np.save(
        out_path.replace(".npz", "_tod.npy"),
        compute_empirical_tod(Y, P=len(purpose_map)),
    )
    with open(
        out_path.replace(".npz", "_purpose_map.json"), "w", encoding="utf-8"
    ) as f:
        json.dump(purpose_map, f, indent=2)
    return out_path, meta
