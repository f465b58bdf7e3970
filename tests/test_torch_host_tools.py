"""The port's host tools against the JAX package's, on the same inputs:
VISTA cleaning (``dataio/vista.py``: the 14 rules and pandas' semantics
step by step, CSVs byte-equal), the persons subset and the fraction
samples, sample coverage (``utils/sample_coverage.py``: exact fractions,
the table's CSV byte-equal), the mock-data loader, the transition
analyzer and the mock-data plots; and the sha256 of ``chip_smoke.py``'s
phase-64 cleaned CSV, derived here from the JAX package (pandas) at the
smoke's seed and size."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ananke_abm_tpu.data_generator import analyze_transitions as janalyze
from ananke_abm_tpu.data_generator import load_data as jload
from ananke_abm_tpu.dataio import vista as jvista
from ananke_abm_tpu.utils import sample_coverage as jcov
from ananke_abm_tpu_torch.data_generator import analyze_transitions as tanalyze
from ananke_abm_tpu_torch.data_generator import load_data as tload
from ananke_abm_tpu_torch.dataio import vista as tvista
from ananke_abm_tpu_torch.utils import sample_coverage as tcov
from test_vista import _raw_stops

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _same_columns(port: dict, frame: pd.DataFrame):
    """The port's {column: array} holds the frame's columns, in its order,
    value for value (NaN where the frame has NaN)."""
    assert list(port) == list(frame.columns)
    for c in frame.columns:
        got, want = list(port[c]), frame[c].tolist()
        assert len(got) == len(want), c
        for g, w in zip(got, want):
            if isinstance(w, float) and w != w:
                assert isinstance(g, float) and g != g, (c, g, w)
            else:
                assert g == w, (c, g, w)


def _bytes(path) -> bytes:
    return Path(path).read_bytes()


def _table(frame: pd.DataFrame) -> dict:
    return {c: frame[c].tolist() for c in frame.columns}


# ---- VISTA cleaning ---------------------------------------------------------

def _variants():
    raw = _raw_stops()
    no_hhid = raw.drop(columns=["hhid"])
    int_ids = raw.assign(persid=raw["persid"].str[1:].astype(int) * 7 % 10)
    no_places = raw.drop(columns=["origplace1", "destplace1"])
    unweighted = raw.drop(columns=["wdstopwgt_sa3"])
    shuffled = raw.sample(frac=1.0, random_state=3).reset_index(drop=True)
    return {"raw": raw, "no_hhid": no_hhid, "int_persid": int_ids,
            "no_places": no_places, "no_weights": unweighted,
            "shuffled": shuffled}


@pytest.mark.parametrize("name", list(_variants()))
def test_clean_vista_stops_matches_the_reference(name, tmp_path):
    """tests/test_vista.py's frame and its variants (no hhid column: ""
    for every row; int persids: numeric order; no place columns: step 3
    skipped; no weights; rows shuffled): columns and CSV equal."""
    raw = _variants()[name]
    want = jvista.clean_vista_stops(raw)
    got = tvista.clean_vista_stops(_table(raw))
    _same_columns(got, want)
    want.to_csv(tmp_path / "j.csv", index=False)
    tvista.write_csv(got, str(tmp_path / "t.csv"))
    assert _bytes(tmp_path / "t.csv") == _bytes(tmp_path / "j.csv")


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """chip_smoke's raw-table generator at 3,000 persons with a missing
    last startime among the traits, written as CSV; both packages clean
    the same file."""
    d = tmp_path_factory.mktemp("vista")
    stops, persons, _ = chip_smoke.vista_raw_tables(3_000, 7,
                                                    startime_missing=True)
    chip_smoke.write_raw_csv(stops, str(d / "stops.csv"))
    chip_smoke.write_raw_csv(persons, str(d / "persons.csv"))
    want = jvista.clean_vista_csv(str(d / "stops.csv"), str(d / "j.csv"),
                                  str(d / "persons.csv"), str(d / "jp.csv"))
    got = tvista.clean_vista_csv(str(d / "stops.csv"), str(d / "t.csv"),
                                 str(d / "persons.csv"), str(d / "tp.csv"))
    return d, want, got


def test_seeded_tables_clean_to_the_reference_bytes(seeded):
    """Every trap in one table: fillna of every missing duration, rows
    without an arrtime dropped, first / last skipping NaN (a missing first
    origin, hhid missing on a first stop), purposes outside the groups or
    missing, unpadded string persids in shuffled rows, and a missing last
    startime that leaves the startime column float (``480.0``) while
    total_duration is cast to int on its own."""
    d, want, got = seeded
    _same_columns(got, want)
    assert _bytes(d / "t.csv") == _bytes(d / "j.csv")
    assert _bytes(d / "tp.csv") == _bytes(d / "jp.csv")
    assert want["startime"].dtype == np.float64
    assert want["startime"].isna().any()
    assert want["total_duration"].dtype == np.int64
    assert got["startime"].dtype == np.float64
    text = _bytes(d / "t.csv").decode()
    assert ",0.0," in text and ",," in text


def test_seeded_tables_exercise_every_rule():
    """The smoke's generator makes every one of the 14 rules drop or
    change some persons: each kind that a rule drops is gone from the
    output, each trait that a rule folds or changes stays on some persons,
    and the kinds and traits reach all 14 rules."""
    stops, _, labels = chip_smoke.vista_raw_tables(3_000, 7)
    out = tvista.clean_vista_stops(stops)
    report, faults = chip_smoke.vista_rule_report(labels,
                                                  out["persid"].tolist())
    assert not faults, faults
    assert {r for r, *_ in report} == set(range(1, 15))
    assert all(made > 0 for _, _, made, _ in report), report


def test_pandas_semantics_case_by_case(tmp_path):
    """Small frames, one trap each, against the reference: a middle stop's
    missing duration filled from its own arrtime; a missing arrtime
    dropping the row; a NaN total dropping the person; a missing hhid
    taken from a later stop by ``first``; fractional startimes cast to int
    by truncation."""
    raw = _raw_stops()
    cases = []
    a = raw.copy()
    a.loc[(a.persid == "P1") & (a.stopno == 2), "duration"] = np.nan
    cases.append(a)
    b = raw.copy()
    b.loc[(b.persid == "P6") & (b.stopno == 3), "arrtime"] = np.nan
    cases.append(b)
    c = raw.copy()
    c.loc[(c.persid == "P5") & (c.stopno == 4), "travtime"] = np.nan
    cases.append(c)
    e = raw.copy()
    e.loc[(e.persid == "P1") & (e.stopno == 1), "hhid"] = np.nan
    cases.append(e)
    f = raw.assign(startime=raw["startime"].astype(float))
    f.loc[f.persid == "P6", "startime"] += 0.5  # cast by truncation
    cases.append(f)
    for i, frame in enumerate(cases):
        want = jvista.clean_vista_stops(frame)
        got = tvista.clean_vista_stops(_table(frame))
        _same_columns(got, want)
        want.to_csv(tmp_path / f"j{i}.csv", index=False)
        tvista.write_csv(got, str(tmp_path / f"t{i}.csv"))
        assert _bytes(tmp_path / f"t{i}.csv") == \
            _bytes(tmp_path / f"j{i}.csv"), i


def test_missing_columns_raise_as_the_reference():
    raw = _table(_raw_stops().drop(columns=["travtime"]))
    with pytest.raises(ValueError, match="travtime"):
        tvista.clean_vista_stops(raw)


@pytest.mark.parametrize("frac", [0.1, 0.37, 0.9])
def test_persons_and_samples_match_the_reference(seeded, frac):
    """``filter_vista_persons`` and ``sample_population``: pandas'
    ``sample(frac, random_state=42)`` (numpy's RandomState permutation,
    round-half-even sizes), both tables equal."""
    d, want, got = seeded
    jp = jvista.filter_vista_persons(pd.read_csv(d / "persons.csv"), want)
    tp = tvista.filter_vista_persons(tvista.read_csv(str(d / "persons.csv")),
                                     got)
    _same_columns(tp, jp)
    js, ja = jvista.sample_population(jp, want, frac)
    ts, ta = tvista.sample_population(tp, got, frac)
    _same_columns(ts, js)
    _same_columns(ta, ja)
    assert len(ts["persid"]) == round(frac * len(tp["persid"]))


def test_phase_64_constant_is_the_reference_output(tmp_path):
    """The sha256 of the cleaned CSV that chip_smoke's phase 64 holds the
    port to on the card: the JAX package's pandas cleaning of the smoke's
    raw table at its seed and size, and at least VISTA_KEPT_MIN persons
    kept."""
    stops, _, _ = chip_smoke.vista_raw_tables(chip_smoke.VISTA_RAW_PERSONS,
                                              chip_smoke.VISTA_SEED)
    chip_smoke.write_raw_csv(stops, str(tmp_path / "stops.csv"))
    out = jvista.clean_vista_csv(str(tmp_path / "stops.csv"),
                                 str(tmp_path / "acts.csv"))
    assert out["persid"].nunique() >= chip_smoke.VISTA_KEPT_MIN
    digest = hashlib.sha256(_bytes(tmp_path / "acts.csv")).hexdigest()
    assert digest == chip_smoke.VISTA_CLEAN_SHA256


# ---- sample coverage --------------------------------------------------------

def _coverage_frames():
    rng = np.random.default_rng(5)
    n = 800
    pers = np.repeat(rng.permutation(n) * 3 + 1, rng.integers(1, 5, n))
    strs = rng.choice(["Home", "Work", "Shopping", "Education"], len(pers))
    missing = strs.astype(object)
    missing[::97] = np.nan
    return {"str": pd.DataFrame({"persid": pers, "purpose": strs}),
            "int": pd.DataFrame({"persid": pers,
                                 "purpose": rng.integers(0, 3, len(pers))}),
            "missing": pd.DataFrame({"persid": pers, "purpose": missing})}


@pytest.mark.parametrize("kind", ["str", "int", "missing"])
def test_sample_coverage_matches_the_reference(kind, tmp_path):
    """``sequence_counts`` (the same keys, counts and order, string, int
    and missing purposes read from CSV), ``coverage_vs_full`` and
    ``sample_coverage_table`` with its fractions exactly equal and its
    CSV byte-equal."""
    from ananke_abm_tpu_torch.utils.make_purposes import read_table

    full = _coverage_frames()[kind]
    full.to_csv(tmp_path / "full.csv", index=False)
    j = jcov.sequence_counts(pd.read_csv(tmp_path / "full.csv"))
    t = tcov.sequence_counts(read_table(str(tmp_path / "full.csv")))
    assert list(t.items()) == list(j.items())
    sampled = []
    persons = full["persid"].unique()
    for frac in (0.37, 0.1, 0.9):
        keep = np.random.default_rng(int(frac * 100)).permutation(
            persons)[:int(frac * len(persons))]
        p = tmp_path / f"s{frac}.csv"
        full[full["persid"].isin(keep)].to_csv(p, index=False)
        sampled.append((frac, str(p)))
        sj = jcov.sequence_counts(pd.read_csv(p))
        st = tcov.sequence_counts(read_table(str(p)))
        assert tcov.coverage_vs_full(t, st) == jcov.coverage_vs_full(j, sj)
    jt = jcov.sample_coverage_table(str(tmp_path / "full.csv"), sampled,
                                    out_csv=str(tmp_path / "jt.csv"))
    tt = tcov.sample_coverage_table(str(tmp_path / "full.csv"), sampled,
                                    out_csv=str(tmp_path / "tt.csv"))
    _same_columns(tt, jt)
    assert _bytes(tmp_path / "tt.csv") == _bytes(tmp_path / "jt.csv")


def test_sequence_counts_of_a_table_in_memory():
    """The reference's own small case (tests/test_aux.py) as a dict of
    columns: three sequences, Home-Work twice."""
    acts = {"persid": [1, 1, 2, 2, 3, 3, 4, 4],
            "purpose": ["Home", "Work", "Home", "Work", "Home", "Shop",
                        "Home", "Edu"]}
    want = jcov.sequence_counts(pd.DataFrame(acts))
    assert list(tcov.sequence_counts(acts).items()) == list(want.items())


def test_coverage_plot_is_written(tmp_path):
    pytest.importorskip("matplotlib")
    table = {"sample_rate": np.array([0.0, 0.5, 1.0]),
             "sampled_unique_sequences": np.array([0.0, 0.6, 1.0]),
             "sampled_sequence_coverage": np.array([0.0, 0.8, 1.0])}
    tcov.plot_sample_coverage(table, str(tmp_path / "cov.png"))
    assert (tmp_path / "cov.png").stat().st_size > 0


# ---- the mock-data tools ----------------------------------------------------

def test_load_mock_data_matches_the_reference():
    want = jload.load_mock_data()
    got = tload.load_mock_data()
    assert list(got) == list(want)
    for key in ("people", "zones"):
        _same_columns(got[key], want[key])
        for c in want[key].columns:
            assert got[key][c].dtype.kind == want[key][c].dtype.kind or \
                want[key][c].dtype == object or \
                str(want[key][c].dtype).startswith("str"), (key, c)
    for key in ("adjacency", "distance_matrix", "zone_features"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["zone_names"] == want["zone_names"]
    assert list(got["trajectories"]) == list(want["trajectories"])
    for pid, tl in want["trajectories"].items():
        assert list(got["trajectories"][pid]) == list(tl)
        for k, v in tl.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got["trajectories"][pid][k], v)
            else:
                assert got["trajectories"][pid][k] == v


def test_analyze_transitions_matches_the_reference(capsys):
    want = janalyze.analyze_transitions()
    printed = capsys.readouterr().out
    got = tanalyze.analyze_transitions()
    assert capsys.readouterr().out == printed
    assert got == want
    assert tanalyze.analyze_transitions((2,), verbose=False) == \
        janalyze.analyze_transitions((2,), verbose=False)


def test_phase_65_constants_are_the_reference_outputs():
    """The digests chip_smoke's phase 65 holds the port to on the card: the
    JAX package's ``load_mock_data`` and ``analyze_transitions``, equal to
    the port's here."""
    import hashlib

    for load in (jload.load_mock_data, tload.load_mock_data):
        assert chip_smoke.mock_data_digest(load()) == \
            chip_smoke.MOCK_DATA_SHA256
    for analyze in (janalyze.analyze_transitions,
                    tanalyze.analyze_transitions):
        digest = hashlib.sha256(
            repr(analyze(verbose=False)).encode()).hexdigest()
        assert digest == chip_smoke.TRANSITIONS_SHA256


def test_mock_data_plots_are_written(tmp_path):
    """The same file names as the reference's, written."""
    pytest.importorskip("matplotlib")
    from ananke_abm_tpu.data_generator import data_visualization as jviz
    from ananke_abm_tpu_torch.data_generator import (
        data_visualization as tviz,
    )

    out = tviz.plot_zone_graph(str(tmp_path / "t" / "zones.png"))
    assert Path(out).stat().st_size > 0
    want = jviz.plot_persona_trajectories(str(tmp_path / "j"))
    got = tviz.plot_persona_trajectories(str(tmp_path / "t"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert all(Path(p).stat().st_size > 0 for p in got)
