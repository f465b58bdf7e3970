"""VISTA travel-survey cleaning: raw stops CSV -> activities CSV (a numpy
and ``csv`` copy of ``ananke_abm_tpu/dataio/vista.py``, no pandas).

Library-code port of the reference's cleaning notebook
(src/ananke_abm/utils/clean_vista.ipynb), reproducing its full behavioral
contract, in notebook order:

1.  keep weighted rows (``wdstopwgt_sa3`` non-null when present);
2.  keep persons whose stop sequence includes stopno 1;
3.  keep home-bound persons only: first origin place and last destination
    place both "Accommodation" (notebook cell 5);
4.  group detailed purposes into {Home, Transit, Work, Education,
    Shopping, Social, Accompanying, Other} — "Change Mode" maps to
    Transit, which is folded away in step 11 (cells 7, 19-20);
5.  drop persons whose last stop is their only stop or is not Home
    (cell 8 — this runs *before* durations are computed);
6.  last stop's duration is refilled to run to the 1440-min day end;
    rows with negative duration are dropped (cell 9);
7.  activity duration = stop duration + travel time; a missing travel
    time propagates NaN and the person falls out at step 9 (cell 10);
8.  a stopno-0 Home activity covering [0, first start) is prepended,
    kept even when zero-length (cell 12);
9.  persons whose activity durations do not sum to exactly 1440 minutes
    are dropped (cells 15-16);
10. stopno is renumbered contiguously from 0 (cell 17);
11. Transit blocks are folded into the *following* activity: its start
    moves back to the first transit's start and its duration absorbs the
    whole block; trailing transit with no following activity is dropped
    (cell 20);
12. consecutive same-purpose activities are merged, summing durations
    (cell 21);
13. full-day (exactly 1440-min) activity rows are dropped, and persons
    left with fewer than two activities go with them (cells 23-24);
14. persons whose day does not both start and end at Home, or whose day
    is all-Home, are dropped (cells 25, 27).

Output columns: persid, hhid, stopno, purpose, startime, total_duration.

Tables are dicts of numpy columns, as ``pandas.read_csv`` types them
(``utils.make_purposes.Column``): int64, float64 with NaN where missing,
str, or object with NaN where missing. Every step keeps the reference's
pandas semantics: ``fillna`` fills every missing duration from its row's
``arrtime`` (a row whose ``arrtime`` is missing too drops out at
``duration >= 0``); groupby ``first`` / ``last`` / ``min`` skip missing
values; sums are pandas' Kahan-compensated group sums; persons are
ordered by the sort of ``persid`` (numeric for an int column,
lexicographic for strings) and rows within a person by a stable sort;
the last ``astype(int64, errors="ignore")`` casts each of ``startime``
and ``total_duration`` on its own, keeping float where a NaN is left (and
``to_csv`` then writes ``480.0``). The one order pandas does not define,
that of step 3's unstable sort among stops of one person with the same
stopno, is taken as the stable one.

:func:`filter_vista_persons` and :func:`sample_population` cover the
notebook's person-attribute subset (cells 33-34) and the 0.1-0.9
fraction sampling outputs (cells 38-39); the sample is pandas'
``sample(frac, random_state)``, numpy's ``RandomState`` permutation.
"""
from __future__ import annotations

import os

import numpy as np

from ananke_abm_tpu_torch.utils.make_purposes import (
    Column,
    read_table,
    write_table,
)

PURPOSE_GROUPS = {
    "At or Go Home": "Home",
    "Change Mode": "Transit",
    "Work Related": "Work",
    "Education": "Education",
    "Buy Something": "Shopping",
    "Personal Business": "Shopping",
    "Pick-up or Deliver Something": "Shopping",
    "Social": "Social",
    "Recreational": "Social",
    "Pick-up or Drop-off Someone": "Accompanying",
    "Accompany Someone": "Accompanying",
    "Other Purpose": "Other",
    "Not Stated": "Other",
    "Unknown Purpose": "Other",
}

REQUIRED = ["persid", "stopno", "destpurp1", "startime", "arrtime",
            "duration", "travtime"]
PERSON_COLS = ["persid", "hhid", "age", "sex", "persinc", "nolicence",
               "fulltimework", "parttimework", "casualwork", "anywork",
               "studying", "worktype"]
OUT_COLS = ["persid", "hhid", "stopno", "purpose", "startime",
            "total_duration"]
DAY_END_MIN = 1440


# ---- columns ----------------------------------------------------------------

def _column(values) -> np.ndarray:
    """A column as numpy: arrays as they are, lists typed as pandas infers
    them (None and NaN missing)."""
    if isinstance(values, np.ndarray):
        return values
    return Column.infer(list(values)).to_numpy()


def _isna(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return np.isnan(a)
    if a.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in a], dtype=bool)
    return np.zeros(len(a), dtype=bool)


def _take(table: dict, idx) -> dict:
    return {k: v[idx] for k, v in table.items()}


def _equals(a: np.ndarray, value) -> np.ndarray:
    """``Series.eq(value)``: missing values are never equal."""
    if a.dtype == object:
        return np.array([v == value for v in a], dtype=bool)
    if a.dtype.kind in "US":
        return a == value
    return np.zeros(len(a), dtype=bool)


def _isin(a: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``Series.isin`` for the persid columns of two tables."""
    if a.dtype != object and values.dtype != object \
            and (a.dtype.kind in "US") == (values.dtype.kind in "US"):
        return np.isin(a, values)
    keep = set(values.tolist())
    return np.array([v in keep for v in a.tolist()], dtype=bool)


# ---- groups of contiguous rows ---------------------------------------------

def _starts(keys: np.ndarray) -> np.ndarray:
    """The first row of each run of equal ``keys`` (an int array)."""
    if len(keys) == 0:
        return np.zeros(0, dtype=np.int64)
    return np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])


def _group_ids(keys: np.ndarray) -> np.ndarray:
    return np.cumsum(np.r_[False, keys[1:] != keys[:-1]]) if len(keys) \
        else np.zeros(0, dtype=np.int64)


def _first_valid(a: np.ndarray, gid: np.ndarray, n_groups: int,
                 last: bool = False):
    """groupby ``first`` (or ``last``) of ``a`` over contiguous groups
    ``gid``, skipping missing values: (the values, a mask of groups that
    have one)."""
    ok = ~_isna(a)
    rows = np.flatnonzero(ok)
    if last:
        rows = rows[::-1]
    g, at = np.unique(gid[rows], return_index=True)
    pick = np.zeros(n_groups, dtype=np.int64)
    pick[g] = rows[at]
    has = np.zeros(n_groups, dtype=bool)
    has[g] = True
    return a[pick], has


def _agg_first(a: np.ndarray, gid: np.ndarray, n_groups: int,
               last: bool = False) -> np.ndarray:
    """groupby ``first`` / ``last`` as pandas returns it: a group without
    a value is NaN (an int column of such groups turns float, a str one
    object)."""
    vals, has = _first_valid(a, gid, n_groups, last)
    if has.all():
        return vals
    if a.dtype.kind in "iubf":
        out = vals.astype(np.float64)
        out[~has] = np.nan
        return out
    out = vals.astype(object)
    out[~has] = np.nan
    return out


def _agg_min(a: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """groupby ``min`` over contiguous groups, skipping NaN."""
    if len(starts) == 0:
        return a[:0]
    if a.dtype.kind == "f":
        return np.fmin.reduceat(a, starts)
    return np.minimum.reduceat(a, starts)


def _kahan_sums(a: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """pandas' groupby ``sum`` of a float column over contiguous groups:
    Kahan-compensated, in row order, skipping NaN (an all-NaN group sums
    to 0)."""
    a = np.asarray(a, dtype=np.float64)
    n = len(a)
    lengths = np.diff(np.r_[starts, n])
    total = np.zeros(len(starts))
    comp = np.zeros(len(starts))
    for k in range(int(lengths.max()) if len(lengths) else 0):
        g = np.flatnonzero(lengths > k)
        v = a[starts[g] + k]
        ok = ~np.isnan(v)
        g, v = g[ok], v[ok]
        y = v - comp[g]
        t = total[g] + y
        c = t - total[g] - y
        comp[g] = np.where(np.isnan(c), 0.0, c)
        total[g] = t
    return total


def _ends(starts: np.ndarray, n: int) -> np.ndarray:
    """The last row of each group that starts at ``starts``."""
    return np.r_[starts[1:], n] - 1 if len(starts) else starts


def _order(persons: np.ndarray, key: np.ndarray) -> np.ndarray:
    """``sort_values([persid, key])``: a stable sort by the persons' sort
    rank, then by ``key`` ascending with NaN last."""
    k = np.asarray(key)
    if k.dtype.kind == "f":
        nan = np.isnan(k)
        return np.lexsort((np.where(nan, 0.0, k), nan, persons))
    return np.lexsort((k, persons))


def _cumcount(gid: np.ndarray) -> np.ndarray:
    starts = _starts(gid)
    lengths = np.diff(np.r_[starts, len(gid)])
    return np.arange(len(gid)) - np.repeat(starts, lengths)


# ---- the cleaning -----------------------------------------------------------

def _fold_transit(t: dict) -> dict:
    """Fold each contiguous Transit block into the following activity
    (start moves back to the block start, duration absorbs the block);
    trailing Transit with no receiver is dropped (notebook cell 20). Rows
    come sorted by person and contiguous stopno."""
    pg = _group_ids(t["_rank"])
    non_transit = t["purpose"] != "Transit"
    # receiver id: non-transit rows at or after this row, within the
    # person; rows sharing one form {leading transit block, receiver}
    rev = non_transit[::-1].astype(np.int64)
    csum = np.cumsum(rev)
    gstart_rev = _starts(pg[::-1])
    base = np.repeat(csum[gstart_rev] - rev[gstart_rev],
                     np.diff(np.r_[gstart_rev, len(rev)]))
    rid = (csum - base)[::-1]
    t = _take(t, rid > 0)
    rid = rid[rid > 0]
    key = np.cumsum(np.r_[False, (t["_rank"][1:] != t["_rank"][:-1])
                          | (rid[1:] != rid[:-1])]) if len(rid) else rid
    starts = _starts(key)
    n = len(starts)
    out = {
        "_rank": t["_rank"][starts],
        "persid": t["persid"][starts],
        "hhid": _agg_first(t["hhid"], key, n),
        "purpose": _agg_first(t["purpose"], key, n, last=True),
        "startime": _agg_min(t["startime"], starts),
        "total_duration": _kahan_sums(t["total_duration"], starts),
    }
    out = _take(out, _order(out["_rank"], out["startime"]))
    out["stopno"] = _cumcount(out["_rank"])
    return out


def _fold_duplicates(t: dict) -> dict:
    """Merge consecutive same-purpose activities, summing durations
    (notebook cell 21)."""
    r, p = t["_rank"], t["purpose"]
    key = np.cumsum(np.r_[True, (r[1:] != r[:-1]) | (p[1:] != p[:-1])]) - 1 \
        if len(r) else r
    starts = _starts(key)
    n = len(starts)
    out = {
        "_rank": r[starts],
        "persid": t["persid"][starts],
        "hhid": _agg_first(t["hhid"], key, n),
        "purpose": p[starts],
        "startime": _agg_first(t["startime"], key, n),
        "total_duration": _kahan_sums(t["total_duration"], starts),
    }
    out["stopno"] = _cumcount(out["_rank"])
    return out


def _keep_persons(t: dict, keep_group: np.ndarray) -> dict:
    """Rows of the persons (contiguous groups of ``_rank``) kept."""
    gid = _group_ids(t["_rank"])
    return _take(t, keep_group[gid])


def _as_int64(a: np.ndarray) -> np.ndarray:
    """``astype(np.int64, errors="ignore")``: a float column without NaN or
    inf is cast (by truncation), else kept."""
    if a.dtype.kind == "f":
        return a.astype(np.int64) if np.isfinite(a).all() else a
    if a.dtype == object:
        try:
            return a.astype(np.int64)
        except (TypeError, ValueError, OverflowError):
            return a
    return a.astype(np.int64)


def clean_vista_stops(stops: dict, home_place: str = "Accommodation",
                      purpose_groups: dict | None = None) -> dict:
    """Clean a raw VISTA stops table ({column: values}) into the
    activities contract ({OUT_COLS column: numpy array})."""
    pg = purpose_groups or PURPOSE_GROUPS
    t = {k: _column(v) for k, v in stops.items()}
    missing = [c for c in REQUIRED if c not in t]
    if missing:
        raise ValueError(f"VISTA stops missing columns: {missing}")
    if "hhid" not in t:
        t["hhid"] = np.full(len(t["persid"]), "", dtype=object)
    # groupby drops missing persids; the others take their sort rank
    t = _take(t, ~_isna(t["persid"]))
    ranks, inverse = np.unique(t["persid"], return_inverse=True)
    t["_rank"] = inverse.reshape(-1)
    n_ranks = len(ranks)

    if "wdstopwgt_sa3" in t:
        t = _take(t, ~_isna(t["wdstopwgt_sa3"]))

    # persons must start at stopno 1
    low = np.full(n_ranks, np.inf)
    np.fmin.at(low, t["_rank"], t["stopno"].astype(np.float64))
    t = _take(t, (low == 1)[t["_rank"]])

    # home-bound persons: first orig and last dest are Accommodation
    if "origplace1" in t and "destplace1" in t:
        s = _take(t, np.lexsort((t["stopno"], t["_rank"])))
        gid = _group_ids(s["_rank"])
        starts = _starts(s["_rank"])
        first, has_f = _first_valid(s["origplace1"], gid, len(starts))
        last, has_l = _first_valid(s["destplace1"], gid, len(starts),
                                   last=True)
        home = np.zeros(n_ranks, dtype=bool)
        home[s["_rank"][starts]] = (has_f & has_l & _equals(first, home_place)
                                    & _equals(last, home_place))
        t = _take(t, home[t["_rank"]])

    t["purpose"] = np.array([pg.get(v, "Other") if isinstance(v, str)
                             else "Other" for v in t["destpurp1"].tolist()],
                            dtype=object)
    t = _take(t, np.lexsort((t["stopno"], t["_rank"])))

    # drop persons whose last stop is their only stop or is not Home
    # (notebook cell 8 — runs before durations are computed)
    starts = _starts(t["_rank"])
    ends = _ends(starts, len(t["_rank"]))
    bad = (t["stopno"][ends] == 1) | (t["purpose"][ends] != "Home")
    t = _keep_persons(t, ~bad)

    # last stop: duration runs to the end of the day; fillna fills every
    # missing duration, and rows whose arrtime is missing too drop out
    gid = _group_ids(t["_rank"])
    starts = _starts(t["_rank"])
    top = np.maximum.reduceat(t["stopno"], starts) if len(starts) \
        else t["stopno"][:0]
    duration = t["duration"].astype(np.float64)
    duration[t["stopno"] == top[gid]] = np.nan
    duration = np.where(np.isnan(duration),
                        DAY_END_MIN - t["arrtime"].astype(np.float64),
                        duration)
    keep = duration >= 0
    t = _take(t, keep)

    # activity duration includes its leading travel time; NaN travtime
    # propagates so the person is dropped by the day-sum filter below
    t["total_duration"] = duration[keep] + t["travtime"].astype(np.float64)
    t = {k: t[k] for k in ("_rank", "persid", "hhid", "stopno", "purpose",
                           "startime", "total_duration")}

    # prepend a stopno-0 Home activity covering [0, first starttime),
    # kept even when zero-length (notebook cell 12)
    gid = _group_ids(t["_rank"])
    starts = _starts(t["_rank"])
    low = np.minimum.reduceat(t["stopno"], starts) if len(starts) \
        else t["stopno"][:0]
    zero = _take(t, t["stopno"] == low[gid])
    n0 = len(zero["stopno"])
    zero["stopno"] = np.zeros(n0, dtype=np.int64)
    zero["purpose"] = np.full(n0, "Home", dtype=object)
    zero["total_duration"] = zero["startime"]
    zero["startime"] = np.zeros(n0, dtype=np.int64)
    both = {k: np.concatenate([zero[k], t[k]]) for k in t}
    t = _take(both, np.lexsort((both["stopno"], both["_rank"])))

    # persons whose activities don't tile the full day exactly are out
    starts = _starts(t["_rank"])
    gid = _group_ids(t["_rank"])
    td = t["total_duration"].astype(np.float64)
    sums = _kahan_sums(td, starts)
    has_nan = np.zeros(len(starts), dtype=bool)
    np.logical_or.at(has_nan, gid, np.isnan(td))
    keep = (sums == DAY_END_MIN) & ~has_nan
    t = _keep_persons(t, keep)

    # contiguous stopno from 0
    t["stopno"] = _cumcount(_group_ids(t["_rank"]))

    t = _fold_duplicates(_fold_transit(t))

    # full-day single-activity rows go, and so do persons left with < 2
    # activities (notebook cells 23-24)
    t = _take(t, t["total_duration"] != DAY_END_MIN)
    starts = _starts(t["_rank"])
    sizes = np.diff(np.r_[starts, len(t["_rank"])])
    t = _keep_persons(t, sizes > 1)

    # day must start and end at Home, and not be all-Home
    starts = _starts(t["_rank"])
    ends = _ends(starts, len(t["_rank"]))
    home = t["purpose"] == "Home"
    all_home = np.ones(len(starts), dtype=bool)
    np.logical_and.at(all_home, _group_ids(t["_rank"]), home)
    t = _keep_persons(t, home[starts] & home[ends] & ~all_home)

    out = {k: t[k] for k in OUT_COLS}
    out["stopno"] = out["stopno"].astype(np.int64)
    out["purpose"] = out["purpose"].astype(str)
    out["startime"] = _as_int64(out["startime"])
    out["total_duration"] = _as_int64(out["total_duration"])
    return out


def filter_vista_persons(persons: dict, activities: dict) -> dict:
    """Person-attribute subset for the cleaned population (cells 33-34):
    the notebook's chosen columns (those present), restricted to persons
    that survived cleaning."""
    cols = [c for c in PERSON_COLS if c in persons]
    out = {c: _column(persons[c]) for c in cols}
    keep = _isin(out["persid"], _column(activities["persid"]))
    return _take(out, keep)


def sample_population(persons: dict, activities: dict, frac: float,
                      random_state: int = 42) -> tuple[dict, dict]:
    """Fraction-sample persons and their activities (cells 38-39):
    pandas' ``sample(frac=frac, random_state=random_state)``, the first
    ``round(frac * n)`` rows of numpy's ``RandomState(random_state)``
    permutation of the n persons, in that order."""
    persons = {k: _column(v) for k, v in persons.items()}
    n = len(persons["persid"])
    rows = np.random.RandomState(random_state).permutation(n)[
        :round(frac * n)]
    samp_persons = _take(persons, rows)
    acts = {k: _column(v) for k, v in activities.items()}
    samp_acts = _take(acts, _isin(acts["persid"], samp_persons["persid"]))
    return samp_persons, samp_acts


def read_csv(path: str) -> dict:
    """A CSV as {column: numpy array}, typed as ``pandas.read_csv`` types
    it."""
    return {k: c.to_numpy() for k, c in read_table(path).items()}


def write_csv(table: dict, path: str) -> None:
    """{column: numpy array} as ``DataFrame.to_csv(index=False)`` writes
    it: floats by their shortest repr, missing values as empty cells."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_table({k: Column.infer(np.asarray(v).tolist())
                 for k, v in table.items()}, path)


def clean_vista_csv(stops_csv: str, out_csv: str | None = None,
                    persons_csv: str | None = None,
                    persons_out_csv: str | None = None) -> dict:
    """Clean a raw VISTA stops CSV; write the activities (and, given both
    persons paths, the persons subset) as pandas' ``to_csv`` writes them."""
    acts = clean_vista_stops(read_csv(stops_csv))
    if out_csv:
        write_csv(acts, out_csv)
    if persons_csv and persons_out_csv:
        write_csv(filter_vista_persons(read_csv(persons_csv), acts),
                  persons_out_csv)
    return acts
