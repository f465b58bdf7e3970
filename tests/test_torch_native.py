"""The port's binding of the host counting kernels
(``ananke_abm_tpu_torch/ops/native.py``, ``csrc/ananke_host.cpp``) against
the JAX package's binding and against its own numpy branch, on the same
seeded inputs: integer outputs equal."""
import numpy as np
import pytest

from _schedule_port import numpy_branch
from ananke_abm_tpu.ops import native as jnative
from ananke_abm_tpu_torch.dataio import rasterize as trast
from ananke_abm_tpu_torch.ops import native as tnative

P = 5


@pytest.fixture(scope="module")
def Y():
    return np.random.default_rng(0).integers(0, P, size=(200, 48))


def test_library_builds_under_build_not_native():
    assert tnative.available(), "g++ is present: the library must build"
    lib = tnative.library_path()
    assert lib.exists()
    assert lib.parent.parts[-2:] == ("build", "ananke_abm_tpu_torch")
    assert "native" not in lib.parent.parts
    # the name hashes the source and the flags
    assert lib.name.startswith("ananke_host-") and len(lib.stem) == 28


def _outputs(native, Y, n):
    return {
        "count_ngrams_dense": native.count_ngrams_dense(Y, n, P),
        "ngram_start_hist_dense": native.ngram_start_hist_dense(Y, n, P),
        "tod_counts": native.tod_counts(Y, P),
        "run_length_segments": native.run_length_segments(Y),
    }


def _assert_same(got, want):
    for name in want:
        a, b = got[name], want[name]
        # run_length_segments gives (person, purpose, length)
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            assert x.dtype == y.dtype == np.int64, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_entry_points_equal_jax_and_the_numpy_branch(Y, n, monkeypatch):
    want = _outputs(jnative, Y, n)
    got = _outputs(tnative, Y, n)
    _assert_same(got, want)
    numpy_branch(monkeypatch)
    _assert_same(_outputs(tnative, Y, n), want)


def _activities(seed, n_persons=40, L=48, sort=True):
    """Per-activity arrays sorted by person; start bins non-decreasing
    within a person (stops in time order) unless ``sort`` is False."""
    rng = np.random.default_rng(seed)
    person_row = np.sort(rng.integers(0, n_persons, 300))
    nominal = rng.integers(0, 60, 300)  # some past the horizon
    if sort:
        nominal = nominal[np.lexsort((nominal, person_row))]
    bins = rng.integers(1, 9, 300)
    pid = rng.integers(0, P, 300)
    return person_row, nominal, bins, pid, n_persons, L


def test_rasterize_fill_equals_jax_and_its_numpy_twin(monkeypatch):
    args = _activities(3)
    want = jnative.rasterize_fill(*args)
    got = tnative.rasterize_fill(*args)
    assert got.dtype == np.int64 and got.shape == args[-2:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trast.rasterize_fill_numpy(*args), want)
    numpy_branch(monkeypatch)
    assert tnative.rasterize_fill(*args) is None


def test_each_rasterizer_branch_equals_jax_on_stops_out_of_time_order(
        monkeypatch):
    """A stop that starts past the horizon before an earlier-starting
    stop: the reference's native fill places the later stop after the
    last one placed, its prefix recurrence after the dropped one (past
    the horizon). The port keeps both branches as the reference has
    them."""
    from ananke_abm_tpu.dataio import rasterize as jrast

    args = _activities(4, sort=False)
    native_fill = tnative.rasterize_fill(*args)
    np.testing.assert_array_equal(native_fill, jnative.rasterize_fill(*args))
    assert not np.array_equal(native_fill, trast.rasterize_fill_numpy(*args))
    person_row, nominal, bins, pid, n_persons, L = args
    grid = 30
    df = {"persid": person_row, "stopno": np.arange(person_row.size),
          "purpose": np.array(["Home", "Work", "Shop", "Edu", "Social"])[pid],
          "starttime": nominal * grid, "total_duration": bins * grid}
    pm = {k: i for i, k in enumerate(sorted(set(df["purpose"].tolist())))}
    import pandas as pd

    frame = pd.DataFrame(df)
    for branch in ("native", "numpy"):
        if branch == "numpy":
            numpy_branch(monkeypatch)
            monkeypatch.setattr(jnative, "rasterize_fill",
                                lambda *a, **k: None)
        got, _ = trast.rasterize_frame(df, pm, grid)
        want, _ = jrast.rasterize_frame(frame, pm, grid)
        np.testing.assert_array_equal(got, want, err_msg=branch)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("bad", [[[0, 1, 2, 5]], [[0, -1, 2, 3]]])
def test_out_of_range_labels_raise_one_value_error(bad, branch,
                                                   monkeypatch):
    Y = np.array(bad, dtype=np.int64)
    if branch == "numpy":
        numpy_branch(monkeypatch)
    for fn in (lambda m: m.count_ngrams_dense(Y, 2, 3),
               lambda m: m.tod_counts(Y, 3),
               lambda m: m.ngram_start_hist_dense(Y, 2, 3),
               lambda m: m.check_labels(Y, 3)):
        for module in (jnative, tnative):
            with pytest.raises(ValueError, match="labels out of range"):
                fn(module)
