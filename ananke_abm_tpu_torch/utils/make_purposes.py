"""Purposes catalog builder (a copy of ``ananke_abm_tpu/utils/make_purposes.py``
without pandas: numpy and ``csv``).

VISTA-like activities CSV -> purposes.csv with the reference's output
schema (one row per distinct purpose label):

    purpose, is_primary (1/0), can_open_close_day (1/0),
    person_day_participation_rate, skip_probability,
    n_occurrences, n_person_days_with_purpose,
    mean/median/p10/p90/iqr/std duration (min), duration_cv,
    mean/median/p10/p90/std start (min), start_circ_var,
    flexibility, notes

plus any extra override columns. The CSV has the text that the JAX
package's ``DataFrame.to_csv(index=False)`` writes, so the statistics are
computed as pandas computes them: group means with Kahan-compensated sums,
standard deviations by Welford's update (ddof 1), medians as the mean of
the two middle values (``np.median``), quantiles by ``np.quantile``'s
linear interpolation. The columns of the CSVs read here are typed as pandas types
them (int, float, bool, else str; empty and pandas' NA spellings missing),
since that decides both how a value prints and how the person-day key
``persid||day`` is spelt (``1`` against ``1.0``). Floats print as Python's
shortest round-trip ``repr``; missing values as empty cells.
"""
from __future__ import annotations

import csv
import math
import os
import re
from typing import Optional

import numpy as np

MINUTES_PER_DAY = 1440.0

# Output schema contract (column names + lead ordering). Any column the
# catalog produces that is not listed here is appended after these.
LEAD_COLUMNS = [
    "purpose",
    "is_primary",
    "can_open_close_day",
    "person_day_participation_rate",
    "skip_probability",
    "n_occurrences",
    "n_person_days_with_purpose",
    "mean_duration_min", "median_duration_min", "p10_duration_min",
    "p90_duration_min", "iqr_duration_min", "std_duration_min",
    "duration_cv",
    "mean_start_min", "median_start_min", "p10_start_min", "p90_start_min",
    "std_start_min", "start_circ_var",
    "flexibility",
    "notes",
]

_PRIMARY_DEFAULTS = {"home", "work", "education", "school", "uni",
                     "university"}

# column-alias tables for the VISTA-ish inputs we accept
_ALIASES = {
    "purpose": ("purpose", "activity", "activity_type", "act"),
    "start": ("startime", "starttime", "start_time", "start", "start_min",
              "start_minutes"),
    "duration": ("total_duration", "duration", "dur", "dur_min",
                 "duration_minutes"),
    "person": ("persid", "person_id", "pid", "person"),
    "day": ("day", "date", "diary_day", "day_id"),
}

_FLAG_WORDS = {
    "y": True, "yes": True, "true": True, "1": True,
    "n": False, "no": False, "false": False, "0": False,
}

# the cells pandas' read_csv reads as missing
_NA_CELLS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
             "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
             "None", "n/a", "nan", "null"}
_BOOL_CELLS = {"True": True, "TRUE": True, "true": True,
               "False": False, "FALSE": False, "false": False}
_INT_CELL = re.compile(r"^[+-]?\d+$")


# ---- typed columns ----------------------------------------------------------

def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


class Column:
    """A typed column as pandas holds it: ``kind`` in {"int", "float",
    "bool", "str", "object"} and its values as Python objects, None where
    missing (only "float", "str" and "object" columns hold missing
    values)."""

    def __init__(self, kind: str, values: list):
        self.kind, self.values = kind, values

    @classmethod
    def infer(cls, values: list) -> "Column":
        """The kind pandas infers for a list of Python values (None or NaN
        missing)."""
        vals = [None if _missing(v) else v for v in values]
        present = [v for v in vals if v is not None]
        gap = len(present) < len(vals)
        if present and all(isinstance(v, bool) for v in present):
            return cls("object" if gap else "bool", vals)
        if all(isinstance(v, int) and not isinstance(v, bool)
               for v in present) and present and not gap:
            return cls("int", vals)
        if present and all(isinstance(v, (int, float))
                           and not isinstance(v, bool) for v in present):
            return cls("float", [None if v is None else float(v)
                                 for v in vals])
        if all(isinstance(v, str) for v in present):
            return cls("str", vals)
        return cls("object", vals)

    @classmethod
    def parse(cls, cells: list) -> "Column":
        """A CSV column's text cells typed as ``pandas.read_csv`` types
        them."""
        vals = [None if c in _NA_CELLS else c for c in cells]
        present = [c for c in vals if c is not None]
        if present and all(_INT_CELL.match(c) for c in present):
            return cls.infer([None if c is None else int(c) for c in vals])
        try:
            return cls.infer([None if c is None else float(c) for c in vals])
        except ValueError:
            pass
        if present and all(c in _BOOL_CELLS for c in present):
            return cls.infer([None if c is None else _BOOL_CELLS[c]
                              for c in vals])
        return cls("str", vals)

    def as_str(self) -> list:
        """``Series.astype(str)``: missing values stay missing."""
        return [None if v is None else _text(v) for v in self.values]

    def to_numpy(self) -> np.ndarray:
        if self.kind == "int":
            return np.array(self.values, dtype=np.int64)
        if self.kind == "float":
            return np.array([np.nan if v is None else v
                             for v in self.values], dtype=np.float64)
        if self.kind == "bool":
            return np.array(self.values, dtype=bool)
        if self.kind == "str" and None not in self.values:
            return np.array(self.values, dtype=str)
        out = np.empty(len(self.values), dtype=object)  # NaN where missing
        out[:] = [np.nan if v is None else v for v in self.values]
        return out


def _text(v) -> str:
    """A value as pandas prints it: floats by their shortest round-trip
    repr, ints and strings as they are."""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _common(a: str, b: str) -> str:
    """The kind of a column that mixes values of kinds a and b."""
    if a == b:
        return a
    if {a, b} <= {"int", "float"}:
        return "float"
    return "object"


def _with_missing(kind: str) -> str:
    """The kind a column takes when rows without a value are added."""
    return {"int": "float", "bool": "object"}.get(kind, kind)


def read_table(path: str, columns=None) -> dict:
    """A CSV with a header row as {name: :class:`Column`}, in file order;
    only the columns named in ``columns``, where given (the others are not
    typed)."""
    with open(path, "r", newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    return {n: Column.parse([r[i] for r in rows[1:]])
            for i, n in enumerate(rows[0])
            if columns is None or n in columns}


def read_catalog(path: str) -> dict:
    """A purposes CSV as {name: numpy column} (float columns NaN where
    empty), the form :func:`build_purposes_catalog` returns."""
    return {k: c.to_numpy() for k, c in read_table(path).items()}


# ---- the reference's helpers ------------------------------------------------

def _resolve_column(names, requested: str, role: str) -> str:
    """Map a requested column name (or any known alias for ``role``) onto
    the table's actual spelling, ignoring case."""
    by_lower = {c.lower(): c for c in names}
    candidates = (requested,) if requested else ()
    for cand in (*candidates, *_ALIASES[role]):
        hit = by_lower.get(cand.lower())
        if hit is not None:
            return hit
    wanted = [requested, *_ALIASES[role]]
    raise KeyError(
        f"activities CSV has no {role} column: tried {wanted}, "
        f"columns present are {sorted(names)}"
    )


def _parse_flag(value) -> Optional[bool]:
    """Loose bool parsing for override cells; unrecognized -> None."""
    if value is None:
        return None
    return _FLAG_WORDS.get(_text(value).strip().lower())


def _titleize(values: list) -> list:
    """Purpose-label normalization: trim, collapse whitespace, Title
    Case."""
    return [None if v is None else re.sub(r"\s+", " ", v.strip()).title()
            for v in values]


def _to_number(v) -> float:
    """``pd.to_numeric(errors="coerce")`` of one value, as a float."""
    if v is None:
        return math.nan
    try:
        return float(v)
    except ValueError:
        return math.nan


def _unit_rescale(x: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1]; a (near-)constant series maps to 0.5
    where it is finite (neutral dispersion); an all-NaN one stays."""
    finite = x[~np.isnan(x)]
    if finite.size == 0:
        return x
    span = float(finite.max() - finite.min())
    if not np.isfinite(span) or span < 1e-12:
        return np.where(np.isnan(x), x, 0.5)
    return (x - finite.min()) / span


def _kahan_mean(values) -> float:
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / len(values)


def _welford_std(values) -> float:
    """ddof 1; NaN for one value (filled with 0 by the caller)."""
    n, mean, m2 = 0, 0.0, 0.0
    for v in values:
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (n - 1)) if n > 1 else math.nan


def _group_stats(dur, start, pday):
    """The per-purpose statistics of one group's rows."""
    d, s = np.asarray(dur), np.asarray(start)
    q = lambda a, p: float(np.quantile(a, p, method="linear"))
    return {
        "n_occurrences": len(dur),
        "n_person_days_with_purpose": len({k for k in pday if k is not None}),
        "mean_duration_min": _kahan_mean(dur),
        "median_duration_min": float(np.median(d)),
        "p10_duration_min": q(d, 0.10),
        "p90_duration_min": q(d, 0.90),
        "_q25_dur": q(d, 0.25),
        "_q75_dur": q(d, 0.75),
        "std_duration_min": _welford_std(dur),
        "mean_start_min": _kahan_mean(start),
        "median_start_min": float(np.median(s)),
        "p10_start_min": q(s, 0.10),
        "p90_start_min": q(s, 0.90),
        "std_start_min": _welford_std(start),
    }


# ---- overrides --------------------------------------------------------------

def _frame_from_records(records: list) -> dict:
    names = []
    for r in records:
        names += [k for k in r if k not in names]
    return {n: Column.infer([r.get(n) for r in records]) for n in names}


def _read_override_frames(overrides: Optional[str],
                          override_csv: Optional[str]) -> list:
    frames = []
    if overrides and os.path.exists(overrides):
        if overrides.endswith((".yml", ".yaml")):
            import yaml

            with open(overrides, "r", encoding="utf-8") as f:
                doc = yaml.safe_load(f) or {}
            if isinstance(doc, dict) and not ({"purpose", "items"} & set(doc)):
                # mapping keyed by purpose: value is a row dict or a note
                frames.append(_frame_from_records([
                    {"purpose": name, **val} if isinstance(val, dict)
                    else {"purpose": name, "notes": str(val)}
                    for name, val in doc.items()
                ]))
            elif isinstance(doc, dict):  # a mapping of columns
                frames.append({k: Column.infer(list(v))
                               for k, v in doc.items()})
            else:
                frames.append(_frame_from_records(list(doc)))
        else:
            frames.append(read_table(overrides))
    if override_csv and os.path.exists(override_csv):
        frames.append(read_table(override_csv))
    return frames


def _concat(frames: list) -> dict:
    """``pd.concat(frames, ignore_index=True)``: the union of the columns,
    missing where a frame lacks one."""
    names = []
    for fr in frames:
        names += [k for k in fr if k not in names]
    sizes = [len(next(iter(fr.values())).values) if fr else 0
             for fr in frames]
    out = {}
    for n in names:
        kind, vals, gap = None, [], False
        for fr, size in zip(frames, sizes):
            col = fr.get(n)
            if col is None:
                vals += [None] * size
                gap = gap or size > 0
            else:
                vals += col.values
                kind = col.kind if kind is None else _common(kind, col.kind)
        kind = _with_missing(kind) if gap else kind
        out[n] = Column(kind, [None if v is None else float(v) for v in vals]
                        if kind == "float" else vals)
    return out


def _load_overrides(overrides: Optional[str],
                    override_csv: Optional[str]) -> Optional[dict]:
    """Combine YAML (mapping keyed by purpose, or list of rows) and/or CSV
    overrides into one table, last writer wins per purpose."""
    frames = _read_override_frames(overrides, override_csv)
    if not frames:
        return None
    ov = _concat(frames) if len(frames) > 1 else frames[0]
    if "purpose" not in ov:
        raise ValueError(
            "override table needs a 'purpose' key: give the CSV a 'purpose' "
            "column, or key the YAML mapping by purpose name"
        )
    for flag_col in ("is_primary", "can_open_close_day"):
        if flag_col in ov:
            vals = [_parse_flag(v) for v in ov[flag_col].values]
            ov[flag_col] = Column("object", vals)
    # normalize labels BEFORE dedup so case/whitespace spelling variants
    # of the same purpose collapse (last writer wins)
    ov["purpose"] = Column("str", _titleize(ov["purpose"].as_str()))
    last = {p: i for i, p in enumerate(ov["purpose"].values)}
    keep = sorted(last.values())
    return {k: Column(c.kind, [c.values[i] for i in keep])
            for k, c in ov.items()}


# ---- the catalog ------------------------------------------------------------

def build_purposes_catalog(
    activities_csv: str,
    out_csv: Optional[str] = None,
    overrides: Optional[str] = None,
    home_name: str = "Home",
    *,
    override_csv: Optional[str] = None,
    persons_csv: Optional[str] = None,
    purpose_col: str = "purpose",
    start_col: str = "startime",
    dur_col: str = "total_duration",
    person_col: str = "persid",
    day_col: Optional[str] = None,
    day_horizon_minutes: float = MINUTES_PER_DAY,
) -> dict:
    """Compute the per-purpose statistics table (reference output schema)
    as ordered {name: numpy column}, and write it to ``out_csv`` if given.

    ``persons_csv``: when given, the person-day denominator counts every
    person in it (x distinct days), so purposes absent from some persons'
    days get participation < 1 even if every *observed* day has them.
    """
    act = read_table(activities_csv)
    p_col = _resolve_column(act, purpose_col, "purpose")
    s_col = _resolve_column(act, start_col, "start")
    d_col = _resolve_column(act, dur_col, "duration")
    pid_col = _resolve_column(act, person_col, "person")
    n_rows = len(act[p_col].values)
    if day_col:
        day = act[_resolve_column(act, day_col, "day")]
    else:
        day = Column("int", [1] * n_rows)  # pseudo-day: one diary day

    purpose = _titleize(act[p_col].as_str())
    start = [_to_number(v) for v in act[s_col].values]
    dur = [_to_number(v) for v in act[d_col].values]
    pday = [None if a is None or b is None else f"{a}||{b}"
            for a, b in zip(act[pid_col].as_str(), day.as_str())]
    keep = [i for i in range(n_rows) if purpose[i] is not None
            and not math.isnan(start[i]) and not math.isnan(dur[i])]

    denom = len({pday[i] for i in keep if pday[i] is not None})
    if persons_csv and os.path.exists(persons_csv):
        persons = read_table(persons_csv)
        ppid = persons[_resolve_column(persons, person_col, "person")]
        # count days among the rows that survived parsing: a day whose
        # rows are all unparseable must not inflate the denominator
        n_days = max(1, len({day.values[i] for i in keep
                             if day.values[i] is not None}))
        n_persons = len({v for v in ppid.values if v is not None})
        denom = max(denom, n_persons * n_days)

    # the groups in order of first appearance (groupby(sort=False))
    groups = {}
    for i in keep:
        groups.setdefault(purpose[i], []).append(i)
    names = list(groups)
    stats = [_group_stats([dur[i] for i in rows], [start[i] for i in rows],
                          [pday[i] for i in rows])
             for rows in groups.values()]
    col = lambda k: np.array([s[k] for s in stats], dtype=np.float64)
    out = {"purpose": Column("str", names)}
    for k in ("n_occurrences", "n_person_days_with_purpose"):
        out[k] = Column("int", [s[k] for s in stats])
    for k in ("mean_duration_min", "median_duration_min", "p10_duration_min",
              "p90_duration_min", "std_duration_min", "mean_start_min",
              "median_start_min", "p10_start_min", "p90_start_min",
              "std_start_min"):
        values = col(k)
        if k.startswith("std_"):
            values = np.where(np.isnan(values), 0.0, values)  # size-1 groups
        out[k] = values
    out["iqr_duration_min"] = col("_q75_dur") - col("_q25_dur")
    mean_dur = out["mean_duration_min"]
    with np.errstate(divide="ignore", invalid="ignore"):
        out["duration_cv"] = np.where(np.abs(mean_dur) < 1e-9, np.nan,
                                      out["std_duration_min"] / mean_dur)
    # circular variance per group: 1 - |mean e^{i theta}|, the cos and sin
    # taken over all rows at once, as the reference does
    theta = 2 * np.pi * (np.array([start[i] for i in keep])
                         % day_horizon_minutes) / day_horizon_minutes
    at = {name: [] for name in names}
    for k, i in enumerate(keep):
        at[purpose[i]].append(k)
    cos, sin = np.cos(theta), np.sin(theta)
    mean_cs = np.array([[_kahan_mean(cos[at[n]].tolist()),
                         _kahan_mean(sin[at[n]].tolist())] for n in names])
    out["start_circ_var"] = 1.0 - np.hypot(mean_cs[:, 0], mean_cs[:, 1])

    n_pd = np.array(out["n_person_days_with_purpose"].values, np.int64)
    out["person_day_participation_rate"] = (
        n_pd / denom if denom > 0 else np.full(len(names), np.nan))
    out["flexibility"] = (0.6 * _unit_rescale(out["start_circ_var"])
                          + 0.4 * _unit_rescale(out["duration_cv"]))
    out["skip_probability"] = 1.0 - _unit_rescale(
        out["person_day_participation_rate"])
    lowered = [n.lower() for n in names]
    out["is_primary"] = Column("bool", [n in _PRIMARY_DEFAULTS
                                        for n in lowered])
    out["can_open_close_day"] = Column(
        "bool", [n == home_name.lower() for n in lowered])
    out = {k: (v if isinstance(v, Column) else Column(
        "float", [None if math.isnan(x) else float(x) for x in v]))
        for k, v in out.items()}

    ov = _load_overrides(overrides, override_csv)
    if ov is not None:
        row = {p: i for i, p in enumerate(ov["purpose"].values)}
        at = [row.get(n) for n in names]
        for c, ocol in ov.items():
            if c == "purpose":
                continue
            vals = [None if i is None else ocol.values[i] for i in at]
            kind = ocol.kind if None not in at else _with_missing(ocol.kind)
            if c in out:
                base = out[c]
                filled = [b if _missing(v) else v
                          for v, b in zip(vals, base.values)]
                out[c] = Column(_common(kind, base.kind), filled)
            else:
                out[c] = Column(kind, vals)
            if out[c].kind == "float":
                out[c].values = [None if _missing(v) else float(v)
                                 for v in out[c].values]

    if "notes" not in out:
        out["notes"] = Column("str", [""] * len(names))

    ordered = [c for c in LEAD_COLUMNS if c in out]
    out = {c: out[c] for c in ordered + [c for c in out if c not in ordered]}

    # participation descending (missing last), then purpose; stable
    rate = out["person_day_participation_rate"].values
    order = sorted(range(len(names)), key=lambda i: (
        rate[i] is None or math.isnan(rate[i]),
        -(rate[i] or 0.0) if rate[i] is not None else 0.0,
        out["purpose"].values[i]))
    out = {k: Column(c.kind, [c.values[i] for i in order])
           for k, c in out.items()}
    for flag_col in ("is_primary", "can_open_close_day"):
        vals = [None if _missing(v) else int(bool(v))
                for v in out[flag_col].values]
        out[flag_col] = Column.infer(vals)

    if out_csv:
        parent = os.path.dirname(out_csv)
        if parent:
            os.makedirs(parent, exist_ok=True)
        write_table(out, out_csv)
    return {k: c.to_numpy() for k, c in out.items()}


def write_table(table: dict, path: str) -> None:
    """{name: :class:`Column`} as ``DataFrame.to_csv(index=False)`` writes
    it: missing values as empty cells, floats by repr, CRLF-free."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        for row in zip(*(c.values for c in table.values())):
            w.writerow(["" if _missing(v) else _text(v) for v in row])
