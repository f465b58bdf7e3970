"""Profile-based synthetic weekday populations, numpy (a copy of
``ananke_abm_tpu/data_generator/population.py`` without pandas).

Profile-conditioned weekday schedules (standard 9-5 / late shift /
student / flexible part-time), home at the start and the end of the day,
non-overlapping ordered segments, deterministic given the seed, in the
7 canonical VISTA purposes. The activities are numpy columns (persid,
stopno, purpose, starttime, total_duration; minutes), the rasterizer's
contract; the CSVs are written with the ``csv`` module.
"""
from __future__ import annotations

import csv
import os

import numpy as np

PURPOSES = [
    "Accompanying",
    "Education",
    "Home",
    "Other",
    "Shopping",
    "Social",
    "Work",
]

# (name, prob, main_purpose, start_mu, start_sd, dur_mu, dur_sd)
PROFILES = [
    ("standard_9_5", 0.45, "Work", 8.5, 0.6, 8.0, 1.0),
    ("late_shift", 0.15, "Work", 13.0, 0.8, 7.5, 1.0),
    ("student", 0.20, "Education", 8.8, 0.5, 6.0, 1.0),
    ("flex_part", 0.20, "Work", 9.5, 1.0, 4.0, 1.2),
]

# discretionary slots: (purpose, prob, offset_after_main_mu, dur_mu, dur_sd)
SIDE_SLOTS = [
    ("Shopping", 0.35, 0.5, 0.8, 0.3),
    ("Social", 0.30, 1.2, 1.5, 0.5),
    ("Accompanying", 0.15, 0.2, 0.6, 0.2),
    ("Other", 0.20, 0.8, 0.7, 0.3),
]

COLUMNS = ("persid", "stopno", "purpose", "starttime", "total_duration")


def generate_population_activities(
    n_persons: int, seed: int = 12345, grid_min: int = 5
) -> dict:
    """Returns the activities as numpy columns {persid, stopno, purpose,
    starttime, total_duration} in minutes, home-bound both ends, sorted by
    person and start (the reference's frame, column by column)."""
    rng = np.random.default_rng(seed)
    probs = np.array([p for _, p, *_ in PROFILES])
    prof_idx = rng.choice(len(PROFILES), size=n_persons, p=probs / probs.sum())

    main_purpose = np.array([PROFILES[i][2] for i in prof_idx])
    start_mu = np.array([PROFILES[i][3] for i in prof_idx])
    start_sd = np.array([PROFILES[i][4] for i in prof_idx])
    dur_mu = np.array([PROFILES[i][5] for i in prof_idx])
    dur_sd = np.array([PROFILES[i][6] for i in prof_idx])

    main_start = np.clip(rng.normal(start_mu, start_sd), 5.0, 15.0)
    main_dur = np.clip(rng.normal(dur_mu, dur_sd), 1.0, 11.0)
    main_end = np.minimum(main_start + main_dur, 22.0)

    # person, purpose, start(h), dur(h) tuples accumulated column-wise
    pers, purp, st, du = [], [], [], []
    idx = np.arange(n_persons)

    # morning home block: 0 .. main_start
    pers.append(idx)
    purp.append(np.full(n_persons, "Home"))
    st.append(np.zeros(n_persons))
    du.append(main_start)

    # main activity
    pers.append(idx)
    purp.append(main_purpose)
    st.append(main_start)
    du.append(main_end - main_start)

    # discretionary side activities after the main block
    cursor = main_end.copy()
    for purpose, prob, off_mu, d_mu, d_sd in SIDE_SLOTS:
        present = rng.random(n_persons) < prob
        gap = np.clip(rng.normal(off_mu, 0.3, n_persons), 0.05, 2.0)
        dur = np.clip(rng.normal(d_mu, d_sd, n_persons), 0.2, 3.0)
        start = cursor + gap
        ok = present & (start + dur < 23.5)
        pers.append(idx[ok])
        purp.append(np.full(int(ok.sum()), purpose))
        st.append(start[ok])
        du.append(dur[ok])
        cursor = np.where(ok, start + dur, cursor)

    # evening home block: cursor .. 24
    pers.append(idx)
    purp.append(np.full(n_persons, "Home"))
    st.append(cursor)
    du.append(np.maximum(24.0 - cursor, 0.25))

    persid = np.concatenate(pers)
    purpose = np.concatenate(purp)
    starttime = np.round(np.concatenate(st) * 60).astype(np.int64)
    total_duration = np.maximum(
        np.round(np.concatenate(du) * 60).astype(np.int64), grid_min)

    # stable sort by (persid, starttime); stopno counts within a person
    order = np.lexsort((starttime, persid))
    persid, purpose = persid[order], purpose[order]
    starttime, total_duration = starttime[order], total_duration[order]
    first = np.searchsorted(persid, persid, side="left")
    stopno = np.arange(persid.size) - first
    return {"persid": persid, "stopno": stopno, "purpose": purpose,
            "starttime": starttime, "total_duration": total_duration}


def write_csv(path: str, columns: dict) -> str:
    """Write equal-length numpy columns as a CSV with a header row."""
    names = list(columns)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(names)
        w.writerows(zip(*(columns[n].tolist() for n in names)))
    return path


def write_population_csvs(outdir: str, n_persons: int, seed: int = 12345):
    """Write activities.csv + persons.csv + purposes.csv (the reference's
    mock-data trio, with activities in rasterizer schema)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    acts = generate_population_activities(n_persons, seed)
    write_csv(os.path.join(outdir, "activities.csv"),
              {k: acts[k] for k in COLUMNS})

    write_csv(os.path.join(outdir, "persons.csv"), {
        "persid": np.arange(n_persons),
        "age": np.clip(rng.normal(40, 12, n_persons).round(), 18, 75
                       ).astype(int),
        "hh_size": np.clip(rng.normal(2.6, 1.0, n_persons).round(), 1, 6
                           ).astype(int),
        "n_cars": np.clip(rng.normal(1.0, 0.7, n_persons).round(), 0, 3
                          ).astype(int),
        "home_zone": rng.integers(1, 101, n_persons),
    })

    names, inverse = np.unique(acts["purpose"], return_inverse=True)
    counts = np.bincount(inverse, minlength=len(names))
    write_csv(os.path.join(outdir, "purposes.csv"), {
        "purpose": names,
        "occurrences": counts,
        "mean_duration_min": np.bincount(
            inverse, acts["total_duration"], len(names)) / counts,
        "mean_start_min": np.bincount(
            inverse, acts["starttime"], len(names)) / counts,
    })
    return os.path.join(outdir, "activities.csv")
