"""The mock world's trajectory CSV family (a numpy and ``csv`` copy of
``ananke_abm_tpu/data_generator/export_csvs.py``, no pandas): persona
schedules -> periods.csv (stay / travel runs), snaps.csv (stay endpoints,
first and last marked as anchors), segments.csv (travel legs with origin
and destination), zones.csv, dist_mat.csv, persons.csv and id_maps.json,
the family that mode_sep and ``configs/data_paths.yml`` read.

The files are byte-equal to the pandas writer's: tables are {column:
values}, each column typed as pandas infers it (``utils.make_purposes.
Column``), floats written by their shortest repr (the float32 distance
matrix by float32's), ``None`` as an empty cell, no rows as one empty
line. Within a person, rows are ordered by numpy's quicksort of their
start times, the argsort that pandas' ``sort_values`` calls.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ananke_abm_tpu_torch.data_generator.mock_world import (
    ZONES,
    Persona,
    distance_matrix,
    get_persona,
    zone_names,
)
from ananke_abm_tpu_torch.utils.make_purposes import Column, write_table

TRAVEL_GAP_H = 0.5  # travel time inserted between consecutive stays


def _frame(rows: list) -> dict:
    """``pd.DataFrame(rows)`` of dict records as {column: list}."""
    return {k: [r[k] for r in rows] for k in (rows[0] if rows else {})}


def _take(frame: dict, idx) -> dict:
    return {k: [v[i] for i in idx] for k, v in frame.items()}


def _sorted_by(frame: dict, col: str) -> list:
    """Row order of ``sort_values(col)``: numpy's quicksort argsort."""
    return np.argsort(np.asarray(frame[col], np.float64),
                      kind="quicksort").tolist()


def _groups(frame: dict, col: str):
    """``groupby(col)``: (key, rows of the group in frame order), keys
    ascending."""
    keys = frame[col]
    for k in sorted(set(keys)):
        yield k, _take(frame, [i for i, v in enumerate(keys) if v == k])


def build_person_periods(persona: Persona) -> dict:
    """Stay / travel period rows from the persona's event list."""
    names = zone_names()
    rows = []
    ev = persona.events
    for i, (t, z, purpose, mode, anchor) in enumerate(ev):
        if i + 1 < len(ev):
            t_next, z_next = ev[i + 1][0], ev[i + 1][1]
        else:
            t_next, z_next = 24.0, z
        if z_next != z:
            travel_start = max(t, t_next - TRAVEL_GAP_H)
            rows.append(
                dict(person_id=persona.person_id, start_time=t,
                     end_time=travel_start, type="stay",
                     location=names[z - 1], purpose=purpose, mode="stay"))
            rows.append(
                dict(person_id=persona.person_id, start_time=travel_start,
                     end_time=t_next, type="travel", location="travel",
                     purpose="travel", mode=ev[i + 1][3]))
        else:
            rows.append(
                dict(person_id=persona.person_id, start_time=t,
                     end_time=t_next, type="stay", location=names[z - 1],
                     purpose=purpose, mode="stay"))
    # drop zero / negative-length periods
    return _frame([r for r in rows if r["end_time"] > r["start_time"]])


def build_snaps_from_periods(periods: dict) -> dict:
    """Stay endpoints -> snaps with the first and last marked as
    anchors."""
    rows = []
    stays = _take(periods, [i for i, t in enumerate(periods["type"])
                            if t == "stay"])
    for pid, g in _groups(stays, "person_id"):
        recs = []
        for i in _sorted_by(g, "start_time"):
            recs.append((g["start_time"][i], g["location"][i],
                         g["purpose"][i]))
            recs.append((g["end_time"][i], g["location"][i],
                         g["purpose"][i]))
        # dedupe consecutive same-time records
        seen = []
        for t, loc, purp in recs:
            if seen and abs(seen[-1][0] - t) < 1e-9 and seen[-1][1] == loc:
                continue
            seen.append((t, loc, purp))
        for i, (t, loc, purp) in enumerate(seen):
            rows.append(dict(person_id=pid, timestamp=t, location=loc,
                             purpose=purp,
                             anchor=int(i == 0 or i == len(seen) - 1)))
    return _frame(rows)


def build_segments_from_periods(periods: dict) -> dict:
    """Travel rows with their origin and destination stay locations."""
    rows = []
    for pid, g in _groups(periods, "person_id"):
        g = _take(g, _sorted_by(g, "start_time"))
        n = len(g["type"])
        for i in range(n):
            if g["type"][i] != "travel":
                continue
            rows.append(dict(
                person_id=pid, start_time=g["start_time"][i],
                end_time=g["end_time"][i], mode=g["mode"][i],
                origin=g["location"][i - 1] if i > 0 else None,
                destination=g["location"][i + 1] if i + 1 < n else None))
    return _frame(rows)


def write_frame(frame: dict, path: str) -> None:
    """{column: list of values, or a float32 array} as
    ``DataFrame.to_csv(index=False)`` writes it."""
    if not frame:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n")
        return
    table = {}
    for k, v in frame.items():
        if isinstance(v, np.ndarray) and v.dtype == np.float32:
            table[k] = Column("str", list(v.astype(str)))
        else:
            table[k] = Column.infer(list(v))
    write_table(table, path)


def write_mock_world_csvs(outdir: str, person_ids=(1, 2)) -> dict:
    """Write the whole CSV family; returns {file name: path}."""
    os.makedirs(outdir, exist_ok=True)
    personas = [get_persona(p) for p in person_ids]

    parts = [build_person_periods(p) for p in personas]
    periods = {k: [v for part in parts for v in part[k]] for k in parts[0]}
    snaps = build_snaps_from_periods(periods)
    segments = build_segments_from_periods(periods)

    names = zone_names()
    zrows = []
    for z in range(1, len(ZONES) + 1):
        name, ztype, pop, jobs, retail, transit, attract, (x, y) = ZONES[z]
        zrows.append(
            dict(zone_id=z, name=name, type=ztype, x_coord=x, y_coord=y,
                 population=pop, job_opportunities=jobs,
                 retail_accessibility=retail,
                 transit_accessibility=transit, attractiveness=attract))
    zones = _frame(zrows)

    dm = distance_matrix()
    dist = {"loc_id": list(names)}
    dist.update({n: dm[:, j] for j, n in enumerate(names)})

    persons = _frame([
        dict(person_id=p.person_id, name=p.name, age=p.age,
             income=p.income, home_zone_id=p.home_zone,
             work_zone_id=p.work_zone)
        for p in personas
    ])

    paths = {}
    for fname, frame in (
        ("periods.csv", periods), ("snaps.csv", snaps),
        ("segments.csv", segments), ("zones.csv", zones),
        ("dist_mat.csv", dist), ("persons.csv", persons),
    ):
        p = os.path.join(outdir, fname)
        write_frame(frame, p)
        paths[fname] = p

    id_maps = {
        "zone_name_to_index": {n: i for i, n in enumerate(names)},
        "zone_id_to_index": {str(z): z - 1 for z in range(1, len(ZONES) + 1)},
    }
    p = os.path.join(outdir, "id_maps.json")
    with open(p, "w", encoding="utf-8") as f:
        json.dump(id_maps, f, indent=2)
    paths["id_maps.json"] = p
    return paths
