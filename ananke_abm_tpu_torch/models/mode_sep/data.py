"""The trajectory-data CSV family and the person / shared data structures
(port of ``ananke_abm_tpu/models/mode_sep/data.py``, in numpy and ``csv``:
no pandas).

Schema: snaps (person_id, timestamp, location, purpose, anchor), periods
(person_id, start_time, end_time, type, location, purpose, mode), zones,
persons, and a labeled symmetric zero-diagonal distance matrix whose row
and column order must match zones.csv. Cells are typed as
``pandas.read_csv`` types them, and the required columns are coerced as
the reference's ``pd.to_numeric`` / ``astype`` do; validation failures
raise the reference's errors with the offending field named. Within a
person, snaps are ordered by numpy's quicksort of their timestamps, the
argsort pandas' ``sort_values`` calls, so ties fall as they do there.

Minimal mode (periods + snaps only): the zone universe is the sorted
location names, distances are 1 off the diagonal, home is the first snap's
zone and work the most visited other one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ananke_abm_tpu_torch.utils.make_purposes import Column, read_table

SNAPS_COLS = {"person_id": int, "timestamp": float, "location": str,
              "purpose": str, "anchor": int}
PERIODS_COLS = {"person_id": int, "start_time": float, "end_time": float,
                "type": str, "location": str, "purpose": str, "mode": str}
ZONES_COLS = {"zone_id": int, "name": str, "type": str, "x_coord": float,
              "y_coord": float, "population": float,
              "job_opportunities": float, "retail_accessibility": float,
              "transit_accessibility": float, "attractiveness": float}
PERSONS_COLS = {"person_id": int, "name": str, "age": float, "income": float,
                "home_zone_id": int, "work_zone_id": int}

TRAVEL_TOKEN = "travel"


@dataclasses.dataclass
class IdMaps:
    Z: int
    zone_name_to_index: Dict[str, int]
    zone_index_to_name: Dict[int, str]
    zone_id_to_index: Dict[int, int]


@dataclasses.dataclass
class PersonData:
    person_id: int
    person_name: str
    times_snap: np.ndarray  # (S,) float32
    loc_ids: np.ndarray  # (S,) int64
    stay_segments: List[Tuple[float, float, int]]  # (t0, t1, loc_idx)
    home_zone_idx: int
    work_zone_idx: int
    traits_raw: np.ndarray  # (2,) [age/100, income/1e5]


@dataclasses.dataclass
class SharedData:
    dist_mat: np.ndarray  # (Z, Z) float32
    zone_names: List[str]
    id_maps: IdMaps
    zone_features: Optional[np.ndarray] = None  # (Z, F) when zones.csv given


def _numeric(col: Column) -> np.ndarray:
    """``pd.to_numeric(errors="raise")`` of a typed column, as float64
    (NaN where missing)."""
    out = np.empty(len(col.values), np.float64)
    for i, v in enumerate(col.values):
        if v is None:
            out[i] = np.nan
        elif isinstance(v, (bool, int, float)):
            out[i] = float(v)
        else:
            try:
                out[i] = float(v)
            except ValueError:
                raise ValueError(
                    f'Unable to parse string "{v}" at position {i}') from None
    return out


def _validate_columns(table: dict, required: dict, name: str) -> dict:
    """{column: typed values}: the required columns coerced (int ->
    int64 array, float -> float64 array, str -> list of str)."""
    missing = [c for c in required if c not in table]
    if missing:
        raise ValueError(
            f"{name} is missing required columns: {missing}. "
            f"Expected columns: {list(required)}.")
    out = {}
    for col, typ in required.items():
        if typ in (int, float):
            vals = (np.array(table[col].values, np.int64)
                    if table[col].kind == "int" else _numeric(table[col]))
            if typ is int and vals.dtype != np.int64:
                if not np.isfinite(vals).all():
                    raise ValueError("Cannot convert non-finite values (NA "
                                     "or inf) to integer")
                vals = vals.astype(np.int64)
            out[col] = vals
        else:
            out[col] = ["nan" if v is None else
                        (repr(v) if isinstance(v, float) else str(v))
                        for v in table[col].values]
    return out


def _rows(table: dict, keep: np.ndarray) -> dict:
    return {k: (v[keep] if isinstance(v, np.ndarray)
                else [v[i] for i in np.flatnonzero(keep)])
            for k, v in table.items()}


def validate_dist_mat(raw: dict, zone_names: List[str]) -> np.ndarray:
    """The (Z, Z) float32 matrix of a dist_mat.csv read as {name:
    :class:`Column`} (``read_table``), checked against the zone order."""
    names = list(raw)
    if names[0].lower() not in {"loc_id", "location", "name"}:
        raise ValueError(
            "dist_mat.csv: first column must be named "
            "'loc_id'/'location'/'name'.")
    header = names[1:]
    if header != zone_names:
        raise ValueError(
            f"dist_mat.csv header {header} does not match zone order "
            f"{zone_names}.")
    rows = raw[names[0]].values
    if rows != zone_names:
        raise ValueError(
            f"dist_mat.csv row labels {rows} do not match zone order "
            f"{zone_names}.")
    mat = np.stack([_numeric(raw[n]) for n in header], axis=1) \
        .astype(np.float32) if header else np.zeros((len(rows), 0),
                                                    np.float32)
    if mat.shape[0] != mat.shape[1]:
        raise ValueError(f"dist_mat.csv must be square; got {mat.shape}.")
    if not np.allclose(mat, mat.T, atol=1e-6):
        raise ValueError("dist_mat.csv must be symmetric (within 1e-6).")
    if not np.all(np.abs(np.diag(mat)) <= 1e-6):
        raise ValueError("dist_mat.csv diagonal must be ~0.")
    return mat


def load_trajectory_csvs(
    periods_csv: str,
    snaps_csv: str,
    zones_csv: Optional[str] = None,
    persons_csv: Optional[str] = None,
    dist_mat_csv: Optional[str] = None,
) -> Tuple[List[PersonData], SharedData]:
    """Load and validate the trajectory-data CSV family: full mode with all
    five files, minimal mode with periods and snaps."""
    periods = _validate_columns(read_table(periods_csv), PERIODS_COLS,
                                "periods.csv")
    snaps = _validate_columns(read_table(snaps_csv), SNAPS_COLS, "snaps.csv")

    ptype = [t.lower() for t in periods["type"]]
    bad_types = set(ptype) - {"stay", "travel"}
    if bad_types:
        raise ValueError(
            f"periods.csv: unknown period types {sorted(bad_types)}")
    is_stay = np.array([t == "stay" for t in ptype], bool)
    stay_locs = {loc for loc, s in zip(periods["location"], is_stay) if s}

    if zones_csv:
        zones = _validate_columns(read_table(zones_csv), ZONES_COLS,
                                  "zones.csv")
        order = np.argsort(zones["zone_id"], kind="quicksort")
        zone_names = [zones["name"][i] for i in order]
        if len(set(zone_names)) != len(zone_names):
            raise ValueError("zones.csv: zone names must be unique.")
        zone_id_to_index = {int(zones["zone_id"][j]): i
                            for i, j in enumerate(order)}
        feat_cols = ["x_coord", "y_coord", "population", "job_opportunities",
                     "retail_accessibility", "transit_accessibility",
                     "attractiveness"]
        zone_features = np.stack([zones[c][order] for c in feat_cols],
                                 axis=1).astype(np.float32)
    else:
        names = set(snaps["location"]) | stay_locs
        names.discard(TRAVEL_TOKEN)
        zone_names = sorted(names)
        zone_id_to_index = {i: i for i in range(len(zone_names))}
        zone_features = None

    name_to_idx = {n: i for i, n in enumerate(zone_names)}
    idx_to_name = {i: n for n, i in name_to_idx.items()}
    Z = len(zone_names)
    id_maps = IdMaps(Z, name_to_idx, idx_to_name, zone_id_to_index)

    unknown = ((set(snaps["location"]) | stay_locs) - set(zone_names)
               - {TRAVEL_TOKEN})
    if unknown:
        raise ValueError(
            f"Locations not present in the zone universe: {sorted(unknown)}")

    if dist_mat_csv:
        dist_mat = validate_dist_mat(read_table(dist_mat_csv), zone_names)
    else:
        dist_mat = (np.ones((Z, Z)) - np.eye(Z)).astype(np.float32)

    persons = None
    if persons_csv:
        persons = _validate_columns(read_table(persons_csv), PERSONS_COLS,
                                    "persons.csv")

    people: List[PersonData] = []
    for pid in sorted(np.unique(snaps["person_id"]).tolist()):
        s = _rows(snaps, snaps["person_id"] == pid)
        order = np.argsort(s["timestamp"], kind="quicksort")
        times = s["timestamp"][order].astype(np.float32)
        locs = np.array([name_to_idx[s["location"][i]] for i in order],
                        dtype=np.int64)
        p = _rows(periods, (periods["person_id"] == pid) & is_stay)
        stay_segments = [
            (float(t0), float(t1), name_to_idx[loc])
            for t0, t1, loc in zip(p["start_time"], p["end_time"],
                                   p["location"])
        ]

        if persons is not None:
            hit = np.flatnonzero(persons["person_id"] == pid)
            if hit.size == 0:
                raise ValueError(f"persons.csv missing person_id {pid}")
            r = int(hit[0])
            for zid_col in ("home_zone_id", "work_zone_id"):
                if int(persons[zid_col][r]) not in zone_id_to_index:
                    raise ValueError(
                        f"Person {pid}: {zid_col}="
                        f"{int(persons[zid_col][r])} not in zones.csv")
            home_idx = zone_id_to_index[int(persons["home_zone_id"][r])]
            work_idx = zone_id_to_index[int(persons["work_zone_id"][r])]
            traits = np.array([float(persons["age"][r]) / 100.0,
                               float(persons["income"][r]) / 1e5],
                              dtype=np.float32)
            pname = persons["name"][r]
        else:
            home_idx = int(locs[0])
            nonhome = locs[locs != home_idx]
            work_idx = (int(np.bincount(nonhome).argmax()) if nonhome.size
                        else home_idx)
            traits = np.array([0.35, 0.5], dtype=np.float32)
            pname = str(pid)

        people.append(PersonData(
            person_id=int(pid),
            person_name=pname,
            times_snap=times,
            loc_ids=locs,
            stay_segments=stay_segments,
            home_zone_idx=home_idx,
            work_zone_idx=work_idx,
            traits_raw=traits,
        ))

    shared = SharedData(dist_mat=dist_mat, zone_names=zone_names,
                        id_maps=id_maps, zone_features=zone_features)
    return people, shared


def load_data_paths_yaml(path: str) -> dict:
    """Resolve a data-paths YAML: keys {snaps,periods,zones,dist_mat,
    persons}_csv, relative to the YAML file. PyYAML is imported here, so
    the module imports without it."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    base = os.path.dirname(os.path.abspath(path))
    out = {}
    for k in ("snaps_csv", "periods_csv", "zones_csv", "dist_mat_csv",
              "persons_csv"):
        v = raw.get(k)
        if v is None:
            out[k] = None
            continue
        p = v if os.path.isabs(v) else os.path.join(base, v)
        if not os.path.exists(p):
            raise FileNotFoundError(f"{k} -> {p} does not exist")
        out[k] = p
    return out
