"""The port's comparison harness (``ananke_abm_tpu_torch/models/
gen_schedule/compare``) against the JAX package's on the same seeded
inputs, on the CPU: the counters, SRMSE and diversity statistics, the
hash-grouped row unique and its collision cases, the label checks, and
``metric_tables`` of both packages writing the same CSV files with equal
text, through the port's native counters and through its numpy
branches."""
import json
import os

import numpy as np
import pytest

import ananke_abm_tpu.models.gen_schedule.compare.utils as jcu
from _schedule_port import host_branch  # noqa: F401
import ananke_abm_tpu_torch.models.gen_schedule.compare.utils as tcu
from ananke_abm_tpu.models.gen_schedule.compare.extract_metrics import (
    METRIC_FUNCS as JFUNCS,
)
from ananke_abm_tpu.models.gen_schedule.compare.extract_metrics import (
    duration_jsd as jdur,
)
from ananke_abm_tpu.models.gen_schedule.compare.extract_metrics import (
    raw_counts as jraw,
)
from ananke_abm_tpu.models.gen_schedule.compare.tables import (
    metric_tables as jtables,
)
from ananke_abm_tpu.models.gen_schedule.evals import metrics as jmetrics
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics import (
    METRIC_FUNCS as TFUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics import (
    duration_jsd as tdur,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics import (
    raw_counts as traw,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.tables import (
    metric_tables as ttables,
)
from ananke_abm_tpu_torch.models.gen_schedule.evals import metrics as tmetrics


def _as_dict(rows, counts):
    return {r.tobytes(): int(c) for r, c in zip(rows, counts)}


def _labels(seed, shape, P):
    return np.random.default_rng(seed).integers(0, P, size=shape)


# ---- counters ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram_counts_equal_jax(n, host_branch):
    Y = _labels(0, (30, 12), 4)
    assert tcu.ngram_counts(Y, n) == jcu.ngram_counts(Y, n)
    for got, want in zip(tcu.ngram_count_arrays(Y, n, 4),
                         jcu.ngram_count_arrays(Y, n, 4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcu.ngram_code_matrix(Y, n, 4),
                                  jcu.ngram_code_matrix(Y, n, 4))
    assert tcu.decode_ngram(57, n, 4) == jcu.decode_ngram(57, n, 4)


def test_schedule_and_segment_counters_equal_jax(host_branch):
    Y = np.array([[0, 1], [0, 1], [1, 1]])
    assert tcu.schedule_counts(Y) == jcu.schedule_counts(Y) == {
        (0, 1): 2, (1, 1): 1}
    Y = _labels(1, (50, 20), 3)
    for fn in ("segments_run_length", "segments_run_length_fast"):
        for got, want in zip(getattr(tcu, fn)(Y), getattr(jcu, fn)(Y)):
            np.testing.assert_array_equal(got, want)
    Y = np.array([[0, 0, 1, 1, 1, 0], [2, 2, 2, 2, 2, 2]])
    person, purpose, length = tcu.segments_run_length_fast(Y)
    np.testing.assert_array_equal(person, [0, 0, 0, 1])
    np.testing.assert_array_equal(purpose, [0, 1, 0, 2])
    np.testing.assert_array_equal(length, [2, 3, 1, 6])


# ---- SRMSE and diversity statistics ------------------------------------------

def test_srmse_forms_equal_jax():
    rng = np.random.default_rng(2)
    p, q = rng.random(17), rng.random(17)
    p, q = p / p.sum(), q / q.sum()
    for fn in ("compute_srmse_from_probs", "compute_basic_srmse_from_probs"):
        assert getattr(tcu, fn)(p, q) == getattr(jcu, fn)(p, q)
    assert tcu.compute_srmse_from_probs(np.array([0.5, 0.5]),
                                       np.array([1.0, 0.0])) == 1.0
    assert tcu.compute_srmse_from_probs(np.zeros(0), np.zeros(0)) == 0.0
    ca, cb = rng.integers(0, 9, 11).astype(float), rng.integers(0, 9, 11)
    assert tcu.srmse_from_count_arrays(ca, cb.astype(float)) == \
        jcu.srmse_from_count_arrays(ca, cb.astype(float))
    Y1, Y2 = _labels(3, (20, 10), 3), _labels(4, (20, 10), 3)
    c1, c2 = tcu.ngram_counts(Y1, 2), tcu.ngram_counts(Y2, 2)
    assert tcu.compute_srmse_from_counts(c1, c2) == \
        jcu.compute_srmse_from_counts(c1, c2)
    assert tcu.compute_srmse_from_counts(c1, c1) == 0.0
    got = tcu.align_count_arrays(np.array([1, 3]), np.array([10, 5]),
                                 np.array([2, 3]), np.array([7, 2]))
    want = jcu.align_count_arrays(np.array([1, 3]), np.array([10, 5]),
                                  np.array([2, 3]), np.array([7, 2]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], [10, 0, 5])


@pytest.mark.parametrize("counts", [[5, 5, 5, 5], [0, 0, 0, 100], [3, 3, 3],
                                    [1, 7, 0, 2, 9, 4], []])
def test_entropy_and_gini_equal_jax(counts):
    c = np.array(counts, dtype=np.int64)
    for fn in ("entropy_from_count_array", "gini_from_count_array"):
        assert getattr(tcu, fn)(c) == getattr(jcu, fn)(c)
    assert tcu.counts_to_probs({"a": 1, "b": 3}) == jcu.counts_to_probs(
        {"a": 1, "b": 3})


# ---- the hash-grouped row unique ---------------------------------------------

def test_row_hashes_equal_jax():
    Y = _labels(5, (100, 21), 9)  # 21 bytes: a padded last word
    packed = np.ascontiguousarray(Y.astype(np.uint8))
    for alt in (False, True):
        np.testing.assert_array_equal(tcu._hash_rows_u64(packed, alt=alt),
                                      jcu._hash_rows_u64(packed, alt=alt))
    assert not np.array_equal(tcu._hash_rows_u64(packed),
                              tcu._hash_rows_u64(packed, alt=True))


def test_schedule_count_arrays_equal_np_unique_and_jax():
    Y = _labels(6, (500, 7), 4)
    want = _as_dict(*np.unique(Y, axis=0, return_counts=True))
    assert _as_dict(*tcu.schedule_count_arrays(Y)) == want == \
        _as_dict(*jcu.schedule_count_arrays(Y))


@pytest.mark.parametrize("collide", ["primary", "both"])
def test_hash_collisions_stay_exact(collide, monkeypatch):
    """Every primary hash equal: the second hash detects it and the exact
    sort path runs. Both hashes equal (a double collision) would merge
    rows: shown the same in both packages."""
    Y = _labels(7, (200, 5), 3)
    results = []
    for cu in (tcu, jcu):
        real = cu._hash_rows_u64

        def fake(p, alt=False, real=real):
            if alt and collide == "primary":
                return real(p, alt=True)
            return np.zeros(p.shape[0], np.uint64)

        monkeypatch.setattr(cu, "_hash_rows_u64", fake)
        results.append(_as_dict(*cu.schedule_count_arrays(Y)))
    assert results[0] == results[1]
    if collide == "primary":
        assert results[0] == _as_dict(*np.unique(Y, axis=0,
                                                 return_counts=True))
    else:
        assert len(results[0]) == 1 and sum(results[0].values()) == 200


def test_all_unique_rows_alias_the_input():
    Y = np.arange(60).reshape(20, 3) % 200
    rows, counts = tcu.schedule_count_arrays(Y)
    assert rows is Y
    np.testing.assert_array_equal(counts, np.ones(20, np.int64))


@pytest.mark.parametrize("Y", [np.array([[300, 1], [300, 1], [2, 5]]),
                               np.array([[1.2, 2.0], [1.7, 2.0], [1.2, 2.0]]),
                               np.array([[-1, 2], [-1, 2], [0, 0]])],
                         ids=["wide", "float", "negative"])
def test_wide_float_and_negative_rows_take_the_exact_unique(Y):
    got = _as_dict(*tcu.schedule_count_arrays(Y))
    assert got == _as_dict(*np.unique(Y, axis=0, return_counts=True)) == \
        _as_dict(*jcu.schedule_count_arrays(Y))


# ---- label checks --------------------------------------------------------------

def test_out_of_range_labels_raise_on_both_branches(host_branch):
    Y = np.array([[0, 5, 1]])
    for fn in (lambda: tcu.ngram_count_arrays(Y, 2, P=3),
               lambda: tmetrics.tod_marginals(Y, P=3),
               lambda: tmetrics.bigram_matrix(Y, P=3),
               lambda: jcu.ngram_count_arrays(Y, 2, P=3)):
        with pytest.raises(ValueError, match="labels out of range"):
            fn()


def test_duration_hists_keep_codes_outside_the_table():
    for mod in (tdur, jdur):
        keys, hists = mod._duration_hists(np.array([5]), np.array([60]),
                                          grid_min=60, num_codes=4)
        assert list(keys) == [5] and hists.shape == (1, 1440 // 60)


@pytest.mark.parametrize("ref_Y,syn_Y", [
    ([[0, 1], [0, 0]], [[0, 1], [0, 300]]),
    ([[1.2, 2.0], [0.0, 0.0]], [[1.7, 2.0], [1.2, 2.0]]),
    ([[1.2, 2.0], [0.0, 0.0]], [[0, 0]]),
], ids=["wide", "float", "float-ref-int-model"])
def test_raw_schedules_csv_equals_jax(ref_Y, syn_Y, tmp_path):
    pm = {"Home": 0, "A": 1}
    texts = []
    for name, mod in (("port", traw), ("jax", jraw)):
        ref = {"Y": np.array(ref_Y), "purpose_map": pm, "name": "ref"}
        syn = {"Y": np.array(syn_Y), "purpose_map": pm, "name": "syn"}
        mod.metric_raw_schedules(ref, [syn], str(tmp_path / name))
        texts.append((tmp_path / name /
                      "raw_counts_schedule_confirmation.csv").read_text())
    assert texts[0] == texts[1]
    assert ",1," in texts[0].splitlines()[2]  # one confirmed row


# ---- metric_tables of both packages ------------------------------------------

PURPOSES = ["Education", "Other", "Shopping", "Social", "Work", "Escort"]


def _population(seed, N, T, P, home):
    """Home-bound days with one to three activity blocks."""
    r = np.random.default_rng(seed)
    Y = np.full((N, T), home, dtype=np.int64)
    for _ in range(3):
        start = r.integers(2, T - 6, N)
        length = r.integers(1, T // 4, N)
        act = r.integers(0, P, N)
        keep = r.random(N) < 0.7
        for i in np.flatnonzero(keep):
            Y[i, start[i]:min(start[i] + length[i], T - 1)] = act[i]
    return Y


def _world(tmp_path, N=2000, T=48, P=7, grid_min=30):
    pm = {p: i for i, p in enumerate(sorted(PURPOSES[:P - 1] + ["Home"]))}
    home = pm["Home"]
    meta = {"purpose_map": pm, "grid_min": grid_min, "horizon_min": 1440,
            "L": T}
    ref_npz = str(tmp_path / "ref.npz")
    np.savez(ref_npz, Y=_population(0, N, T, P, home))
    ref_meta = str(tmp_path / "ref_meta.json")
    with open(ref_meta, "w") as f:
        json.dump(meta, f)
    cdir = tmp_path / "models"
    cdir.mkdir()
    for name, seed in (("model_a", 1), ("model_b", 2)):
        Y = _population(seed, N, T, P, home)
        if name == "model_b":
            Y[: N // 4] = Y[N // 4: N // 2]  # repeated schedules
        np.savez(str(cdir / f"{name}.npz"), Y_generated=Y)
        with open(str(cdir / f"{name}_meta.json"), "w") as f:
            json.dump(meta, f)
    return ref_npz, ref_meta, str(cdir)


def _tables(fn, world, outdir):
    ran = fn(*world, outdir)
    return ran, {f: open(os.path.join(outdir, f)).read()
                 for f in sorted(os.listdir(outdir))}


def test_registry_keeps_the_reference_order():
    assert list(TFUNCS) == list(JFUNCS)


@pytest.mark.parametrize("T,P", [(48, 7), (24, 4)])
def test_metric_tables_write_the_jax_csvs(T, P, tmp_path, host_branch):
    world = _world(tmp_path, T=T, P=P, grid_min=1440 // T)
    jran, jcsv = _tables(jtables, world, str(tmp_path / "jax"))
    tran, tcsv = _tables(ttables, world, str(tmp_path / "port"))
    assert tran == jran == list(JFUNCS)
    assert list(tcsv) == list(jcsv)
    assert len(tcsv) == 24
    for name in jcsv:
        assert tcsv[name] == jcsv[name], name


def _bad_world(tmp_path, model_Y, model_L):
    pm = {"Home": 0, "Work": 1}
    np.savez(str(tmp_path / "ref.npz"), Y=np.zeros((4, 10), np.int64))
    with open(str(tmp_path / "ref_meta.json"), "w") as f:
        json.dump({"purpose_map": pm, "grid_min": 5, "L": 10}, f)
    cdir = tmp_path / "m"
    cdir.mkdir()
    np.savez(str(cdir / "x.npz"), Y_generated=model_Y)
    with open(str(cdir / "x_meta.json"), "w") as f:
        json.dump({"purpose_map": pm, "grid_min": 5, "L": model_L}, f)
    return (str(tmp_path / "ref.npz"), str(tmp_path / "ref_meta.json"),
            str(cdir))


def test_grid_mismatch_raises_in_both(tmp_path):
    world = _bad_world(tmp_path, np.zeros((4, 8), np.int64), 8)
    for fn in (ttables, jtables):
        with pytest.raises(AssertionError, match="Temporal mismatch"):
            fn(*world, str(tmp_path / "out"))


def test_out_of_map_labels_fail_fast_in_both(tmp_path):
    bad = np.zeros((4, 10), np.int64)
    bad[0, 0] = 7
    world = _bad_world(tmp_path, bad, 10)
    for fn, out in ((ttables, "t"), (jtables, "j")):
        outdir = tmp_path / out
        with pytest.raises(ValueError, match="purpose_map"):
            fn(*world, str(outdir))
        assert not outdir.exists() or not any(outdir.iterdir())


def test_metrics_equal_jax_on_both_branches(host_branch):
    Y = _population(9, 300, 48, 7, 1)
    for fn in ("tod_marginals", "bigram_matrix", "bigram_matrix_rowcond",
               "minutes_share"):
        np.testing.assert_array_equal(getattr(tmetrics, fn)(Y, 7),
                                      getattr(jmetrics, fn)(Y, 7))
