"""The port's schedule-VAE pipeline across packages and its numpy host
copies, on the CPU: checkpoints written by one package and sampled,
CRF-prepared or evaluated by the other, the trainer's log, checkpoints and
resume, and the population generator, rasterizer, splits, PDS and metrics
against the JAX package's (``ananke_abm_tpu_torch/models/gen_schedule``,
``dataio``, ``data_generator/population.py``)."""
import copy
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from _schedule_port import (  # noqa: E402,F401
    HOME,
    L,
    P,
    _rel,
    _t,
    host_branch,
)
from ananke_abm_tpu.data_generator import population as jpop
from ananke_abm_tpu.dataio import rasterize as jrast
from ananke_abm_tpu.dataio import splits as jsplits
from ananke_abm_tpu.models.gen_schedule import pds as jpds
from ananke_abm_tpu.models.gen_schedule.crf.train import (
    train_crf as jtrain_crf,
)
from ananke_abm_tpu.models.gen_schedule.evals import metrics as jmetrics
from ananke_abm_tpu.models.gen_schedule.pipeline import sample as jsample
from ananke_abm_tpu.models.gen_schedule.pipeline import train as jtrain
from ananke_abm_tpu.models.gen_schedule.pipeline.eval import (
    evaluate as jevaluate,
)
from ananke_abm_tpu_torch.data_generator import population as tpop
from ananke_abm_tpu_torch.dataio import rasterize as trast
from ananke_abm_tpu_torch.dataio import splits as tsplits
from ananke_abm_tpu_torch.models.gen_schedule import pds as tpds
from ananke_abm_tpu_torch.models.gen_schedule.crf.prepare import (
    prepare_crf_data as tprepare_crf,
)
from ananke_abm_tpu_torch.models.gen_schedule.evals import metrics as tmetrics
from ananke_abm_tpu_torch.models.gen_schedule.pipeline import sample as tsample
from ananke_abm_tpu_torch.models.gen_schedule.pipeline import train as ttrain
from ananke_abm_tpu_torch.models.gen_schedule.pipeline.eval import (
    evaluate as tevaluate,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]


# ---- the pipeline across packages ----------------------------------------

TINY_CFG = {
    "train": {"epochs": 1, "min_epochs": 1, "patience": 0, "batch_size": 32,
              "lr": 1e-3, "weight_decay": 1e-4, "grad_clip": 1.0,
              "beta_target": 1.0, "beta_warm_frac": 0.3, "lambda_tv": 0.01,
              "lambda_home": 0.1},
    "model": {"method": "baseline_cnn", "z_dim": 4, "emb_dim": 16,
              "cnn_channels": [8], "cnn_kernel": 3, "cnn_dropout": 0.1},
}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("sched")
    csv = str(root / "activities.csv")
    tpop.write_csv(csv, tpop.generate_population_activities(96, seed=11))
    grid = str(root / "grid.npz")
    trast.prepare_from_csv(csv, grid, grid_min=60, val_frac=0.2, seed=5)
    return root, grid


def _cfg(grid, **over):
    cfg = copy.deepcopy(TINY_CFG)
    cfg["data"] = {"npz": grid}
    for k, v in over.items():
        (cfg["model"] if k in cfg["model"] or k == "cnn_norm"
         else cfg["train"])[k] = v
    return cfg


@pytest.fixture(scope="module")
def jax_run(prepared):
    root, grid = prepared
    out = str(root / "jax_run")
    jtrain.train(_cfg(grid, cnn_norm="batch"), out, seed=1)
    return os.path.join(out, "checkpoints")


def test_a_jax_checkpoint_decodes_and_samples_in_the_port(prepared, jax_run):
    root, grid = prepared
    ck = os.path.join(jax_run, "best_val.ckpt")
    obj = load_checkpoint(ck)
    assert obj["batch_stats"]
    model, pds = tsample.load_vae(obj, "cpu")
    jm, _ = jtrain.build_model(obj["cfg"], obj["meta"])
    z = np.random.default_rng(17).standard_normal((64, 4)).astype(np.float32)
    want = np.asarray(jm.apply({"params": obj["params"]}, jnp.asarray(z),
                               method=lambda m, z: m.decode(z)))
    chunk = tsample.make_chunk_fn(model, pds)
    got = model.decode(_t(z), pds).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(chunk(_t(z))[0].numpy(),
                                  want.argmax(axis=-1))
    prefix = str(root / "port_s")
    info = tsample.sample(ck, 40, prefix, seed=2, csv_max_persons=3,
                          reject_all_home=True, device="cpu")
    assert info["generated"] == 40
    with np.load(prefix + ".npz") as s:
        assert s["Y_generated"].shape == (40, L) and \
            s["Y_generated"].dtype == np.int64
        assert s["U_mean_logits"].dtype == np.float32
        assert s["Z_stats"].shape == (2, 4)
        assert not (s["Y_generated"] == HOME).all(axis=1).any()
    assert set(pd.read_csv(prefix + "_preview.csv").columns) == set(
        tpop.COLUMNS)
    # the port's CRF path over the JAX checkpoint, JAX's CRF trainer on it
    meta = tprepare_crf(ck, grid.replace(".npz", "_splits.npz"),
                        str(root / "crf"), batch_size=32, device="cpu")
    with np.load(str(root / "crf" / "crf_train.npz")) as d:
        assert d["U"].dtype == np.float32 and d["U"].shape[1:] == (L, P)
        assert d["Y"].dtype == np.int64
    crf_ck = str(root / "crf" / "jax_crf.ckpt")
    jtrain_crf({"train_npz": str(root / "crf" / "crf_train.npz"),
                "val_npz": str(root / "crf" / "crf_val.npz"),
                "meta_json": str(root / "crf" / "crf_meta.json"),
                "save_path": crf_ck, "num_epochs": 1, "batch_size": 16,
                "lr": 1e-2})
    assert meta["home_idx"] == HOME
    info = tsample.sample(ck, 24, str(root / "port_c"), seed=3,
                          decode_mode="crf", crf_path=crf_ck,
                          enforce_nonhome=True, device="cpu")
    with np.load(str(root / "port_c.npz")) as s:
        assert not (s["Y_generated"] == HOME).all(axis=1).any()


def test_a_jax_checkpoint_serves_where_optax_is_absent(prepared, jax_run,
                                                       monkeypatch):
    """The card's machine has no optax: a JAX-written checkpoint's optax
    state unpickles as stand-ins and the rest serves ``sample()``."""
    from ananke_abm_tpu_torch.utils.ckpt import Unavailable

    root, _ = prepared
    ck = os.path.join(jax_run, "last.ckpt")
    with_optax = load_checkpoint(ck)
    for name in [k for k in sys.modules if k.split(".")[0] == "optax"]:
        monkeypatch.setitem(sys.modules, name, None)
    obj = load_checkpoint(ck)
    states = jax.tree_util.tree_leaves(
        obj["opt_state"], is_leaf=lambda x: isinstance(x, Unavailable))
    assert states and all(isinstance(x, Unavailable) for x in states)
    assert {x.name.split(".")[0] for x in states} == {"optax"}
    for a, b in zip(jax.tree_util.tree_leaves(obj["params"]),
                    jax.tree_util.tree_leaves(with_optax["params"])):
        assert np.array_equal(a, b)
    info = tsample.sample(ck, 16, str(root / "no_optax"), seed=1,
                          device="cpu")
    assert info["generated"] == 16
    # a module outside the JAX stack still fails loudly
    bad = root / "bad.ckpt"
    bad.write_bytes(b"cnosuchpkg\nX\n.")  # protocol 0: GLOBAL, STOP
    with pytest.raises(ModuleNotFoundError, match="nosuchpkg"):
        load_checkpoint(str(bad))


def test_a_port_checkpoint_samples_in_jax_and_reports_agree(prepared):
    root, grid = prepared
    out = str(root / "port_run")
    res = ttrain.train(_cfg(grid), out, seed=1, device="cpu")
    assert res["epochs_ran"] == 1
    ck = os.path.join(out, "checkpoints", "best_val.ckpt")
    prefix = str(root / "jax_s")
    jsample.sample(ck, num_samples=30, outprefix=prefix, seed=2,
                   csv_max_persons=2)
    with np.load(prefix + ".npz") as s:
        assert s["Y_generated"].shape == (30, L)
    want = jevaluate(prefix + ".npz", prefix + "_meta.json", grid,
                     str(root / "jrep.json"))
    got = tevaluate(prefix + ".npz", prefix + "_meta.json", grid,
                    str(root / "trep.json"))
    assert got == want
    with open(root / "jrep.json") as f, open(root / "trep.json") as g:
        assert f.read() == g.read()


def test_training_log_and_checkpoints_keep_the_reference_format(prepared,
                                                                 jax_run):
    root, grid = prepared
    out = str(root / "port_run_fmt")
    ttrain.train(_cfg(grid, epochs=2, min_epochs=2, ckpt_every=1), out,
                 seed=4, device="cpu")
    jlog = pd.read_csv(os.path.join(os.path.dirname(jax_run),
                                    "training_log.csv"))
    tlog = pd.read_csv(os.path.join(out, "training_log.csv"))
    assert list(tlog.columns) == list(jlog.columns)
    assert list(tlog["epoch"]) == [1, 2]
    assert np.isfinite(tlog.drop(columns="epoch").to_numpy()).all()
    for name in ("last.ckpt", "best_val.ckpt"):
        t = load_checkpoint(os.path.join(out, "checkpoints", name))
        j = load_checkpoint(os.path.join(jax_run, name))
        assert set(t) == set(j)
        assert t["batch_stats"] == {}
        assert t["opt_state"]["format"] == "ananke_abm_tpu_torch.adamw/1"


def test_resume_repeats_the_straight_run(prepared, jax_run):
    root, grid = prepared
    straight, split = str(root / "straight"), str(root / "split")
    cfg3 = _cfg(grid, epochs=3, min_epochs=3, cnn_norm="batch")
    cfg2 = _cfg(grid, epochs=2, min_epochs=2, cnn_norm="batch")
    ttrain.train(cfg3, straight, seed=6, device="cpu")
    ttrain.train(cfg2, split, seed=6, device="cpu")
    ttrain.train(cfg3, split, seed=6, resume=True, device="cpu")
    a = pd.read_csv(os.path.join(straight, "training_log.csv"))
    b = pd.read_csv(os.path.join(split, "training_log.csv"))
    assert list(b["epoch"]) == [3]
    np.testing.assert_allclose(b.iloc[0].to_numpy(), a.iloc[2].to_numpy(),
                               rtol=1e-5, atol=1e-7)
    pa = load_checkpoint(os.path.join(straight, "checkpoints", "last.ckpt"))
    pb = load_checkpoint(os.path.join(split, "checkpoints", "last.ckpt"))
    for x, y in zip(jax.tree_util.tree_leaves(
            (pa["params"], pa["batch_stats"])), jax.tree_util.tree_leaves(
            (pb["params"], pb["batch_stats"]))):
        assert _rel(y, x) <= 1e-5
    # a JAX-written last.ckpt holds an optax state: refused
    jdir = str(root / "from_jax")
    os.makedirs(os.path.join(jdir, "checkpoints"), exist_ok=True)
    with open(os.path.join(jax_run, "last.ckpt"), "rb") as f, open(
            os.path.join(jdir, "checkpoints", "last.ckpt"), "wb") as g:
        g.write(f.read())
    with pytest.raises(ValueError, match="optax optimizer state"):
        ttrain.train(cfg3, jdir, seed=6, resume=True, device="cpu")


def test_sharded_entry_points_raise_naming_item_11(prepared, jax_run):
    _, grid = prepared
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.train(_cfg(grid), "unused", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tsample.sample(os.path.join(jax_run, "last.ckpt"), 4, "unused",
                       mesh=object(), device="cpu")


def test_merge_welford_equals_jax():
    rng = np.random.default_rng(18)
    state_j = state_t = (0, np.zeros((3, 2)), np.zeros((3, 2)))
    for n in (0, 5, 1, 7):
        x = rng.standard_normal((n, 3, 2))
        chunk = (n, x.mean(0) if n else np.zeros((3, 2)),
                 ((x - x.mean(0)) ** 2).sum(0) if n else np.zeros((3, 2)))
        state_j = jsample._merge_welford(*state_j, *chunk)
        state_t = tsample._merge_welford(*state_t, *chunk)
        assert state_j[0] == state_t[0]
        for a, b in zip(state_j[1:], state_t[1:]):
            assert np.array_equal(a, b)


def test_segments_equal_jax():
    seq = np.array([2, 2, 6, 6, 6, 4, 2, 2])
    inv = {i: f"p{i}" for i in range(7)}
    assert tsample.decode_person_to_segments(seq, "a", 30, inv) == \
        jsample.decode_person_to_segments(seq, "a", 30, inv)


# ---- host copies ---------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(64, 7), (500, 0), (1, 3)])
def test_population_equals_jax(n, seed, tmp_path):
    df = jpop.generate_population_activities(n, seed=seed)
    cols = tpop.generate_population_activities(n, seed=seed)
    assert list(cols) == list(df.columns)
    for k in df.columns:
        np.testing.assert_array_equal(cols[k], df[k].to_numpy(), err_msg=k)
    df.to_csv(tmp_path / "j.csv", index=False)
    tpop.write_csv(str(tmp_path / "t.csv"), cols)
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "t.csv").read_text()


def test_population_csvs_equal_jax(tmp_path):
    jpop.write_population_csvs(str(tmp_path / "j"), 120, seed=4)
    tpop.write_population_csvs(str(tmp_path / "t"), 120, seed=4)
    for name in ("activities.csv", "persons.csv"):
        assert (tmp_path / "j" / name).read_text() == \
            (tmp_path / "t" / name).read_text(), name
    a = pd.read_csv(tmp_path / "j" / "purposes.csv")
    b = pd.read_csv(tmp_path / "t" / "purposes.csv")
    assert list(a.columns) == list(b.columns)
    pd.testing.assert_frame_equal(a, b, rtol=1e-12)


def _frame(rows):
    df = pd.DataFrame(rows)
    return df, {k: df[k].to_numpy() for k in df.columns}


RASTER_CASES = {
    # every activity gets a bin: two 1-min activities in the same bin
    "one_bin_each": ({"persid": [1, 1, 1], "stopno": [0, 1, 2],
                      "purpose": ["Home", "Work", "Home"],
                      "starttime": [0, 2, 4],
                      "total_duration": [2, 1, 1436]},
                     {"Home": 0, "Work": 1}),
    # overlapping starts never reorder activities
    "monotone": ({"persid": [1] * 4, "stopno": [0, 1, 2, 3],
                  "purpose": ["Home", "Work", "Shopping", "Home"],
                  "starttime": [0, 60, 60, 70],
                  "total_duration": [60, 30, 30, 1310]},
                 {"Home": 0, "Shopping": 1, "Work": 2}),
    # unsorted stops, zero durations, past the horizon, string ids, a
    # person ending away from home
    "mixed": ({"persid": ["b", "a", "a", "b", "a", "b", "c", "c"],
               "stopno": [1, 2, 0, 0, 1, 2, 0, 1],
               "purpose": ["Work", "Home", "Home", "Home", "Work", "Home",
                           "Home", "Shopping"],
               "starttime": [480, 1000, 0, 0, 500, 1500, 0, 600],
               "total_duration": [600, 440, 500, 480, 0, 30, 600, 840]},
              {"Home": 0, "Shopping": 1, "Work": 2}),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
@pytest.mark.parametrize("grid_min", [5, 60])
def test_rasterizer_cases_equal_jax(case, grid_min, host_branch):
    rows, pm = RASTER_CASES[case]
    df, cols = _frame(rows)
    Yj, pj = jrast.rasterize_frame(df, pm, grid_min=grid_min)
    Yt, pt = trast.rasterize_frame(cols, pm, grid_min=grid_min)
    np.testing.assert_array_equal(Yt, Yj)
    assert pt == pj


@pytest.mark.parametrize("Y", [np.r_[np.zeros(7, int), np.ones(3, int)],
                               np.ones(10, int),
                               np.r_[1, np.zeros(8, int), 1]])
def test_ensure_homebound_equals_jax(Y):
    Y = np.stack([Y, np.zeros(10, int)])
    np.testing.assert_array_equal(trast.ensure_homebound(Y, 0),
                                  jrast.ensure_homebound(Y, 0))


def test_population_grid_equals_jax(prepared, tmp_path, host_branch):
    root, grid = prepared
    df = pd.read_csv(root / "activities.csv")
    cols = trast.read_csv(str(root / "activities.csv"))
    pm = jrast.build_purpose_map(df["purpose"])
    assert trast.build_purpose_map(cols["purpose"]) == pm
    for g in (5, 10, 60):
        Yj, pj = jrast.rasterize_frame(df, pm, g)
        Yt, pt = trast.rasterize_frame(cols, pm, g)
        np.testing.assert_array_equal(Yt, Yj)
        assert pt == pj
    jout = str(tmp_path / "j.npz")
    jrast.prepare_from_csv(str(root / "activities.csv"), jout, grid_min=60,
                           val_frac=0.2, seed=5)
    tout = str(tmp_path / "t.npz")
    trast.prepare_from_csv(str(root / "activities.csv"), tout, grid_min=60,
                           val_frac=0.2, seed=5)
    with np.load(tout) as a, np.load(grid) as b:
        np.testing.assert_array_equal(a["Y"], b["Y"])
    for suffix in ("_meta.json", "_purpose_map.json"):
        assert Path(jout.replace(".npz", suffix)).read_text() == \
            Path(grid.replace(".npz", suffix)).read_text()
    for suffix in (".npz", "_splits.npz"):
        with np.load(jout.replace(".npz", suffix)) as a, \
                np.load(grid.replace(".npz", suffix)) as b:
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k])
                assert a[k].dtype == b[k].dtype
    np.testing.assert_array_equal(
        np.load(grid.replace(".npz", "_tod.npy")),
        np.load(jout.replace(".npz", "_tod.npy")))
    for fn in ("load_grid",):
        np.testing.assert_array_equal(getattr(tsplits, fn)(grid),
                                      getattr(jsplits, fn)(grid))
    for a, b in zip(tsplits.read_n_split_data(grid, 0.3, 9),
                    jsplits.read_n_split_data(grid, 0.3, 9)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsplits.load_splits(grid.replace(".npz", "_splits.npz")),
                    jsplits.load_splits(grid.replace(".npz", "_splits.npz"))):
        np.testing.assert_array_equal(a, b)


def test_pds_and_metrics_equal_jax(prepared, tmp_path, host_branch):
    root, grid = prepared
    pm = grid.replace(".npz", "_purpose_map.json")
    sj = jpds.compute_pds(grid, str(tmp_path / "j"), 60, pm)
    st = tpds.compute_pds(grid, str(tmp_path / "t"), 60, pm)
    assert {k: v for k, v in sj.items() if k != "npz_path"} == \
        {k: v for k, v in st.items() if k != "npz_path"}
    with np.load(str(tmp_path / "j_pds.npz"), allow_pickle=True) as a, \
            np.load(str(tmp_path / "t_pds.npz"), allow_pickle=True) as b:
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
    Y = np.load(grid)["Y"]
    for fn in ("minutes_share", "tod_marginals", "bigram_matrix",
               "bigram_matrix_rowcond"):
        np.testing.assert_array_equal(getattr(tmetrics, fn)(Y, P),
                                      getattr(jmetrics, fn)(Y, P))
    with pytest.raises(ValueError, match="out of range"):
        tmetrics.tod_marginals(Y + 7, P)


def test_diversity_ratio_equals_jax():
    """Byte ids, wider ids (Y + 300) and negative ids: the same counts."""
    from ananke_abm_tpu.models.gen_schedule.evals import report as jreport
    from ananke_abm_tpu_torch.models.gen_schedule.evals import report as treport

    rng = np.random.default_rng(19)
    base = rng.integers(0, P, size=(50, L))
    Y = base[rng.integers(0, 50, 400)]
    cases = [Y, Y[:, :3], np.array([[1, 2], [2, 1], [1, 2]]),
             np.zeros((5, 4), int), Y + 300, Y - 3, Y.astype(np.int32),
             np.array([[0, 256], [256, 0], [0, 256]])]
    for c in cases:
        assert treport.diversity_ratio(c) == jreport.diversity_ratio(c)


# ---- the smoke's configurations and the port's imports -------------------

def test_smoke_configs_equal_the_yaml_files():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for name, cfg in chip_smoke.SCHEDULE_CONFIGS.items():
        with open(ROOT / "configs" / f"{name}.yaml") as f:
            assert cfg == yaml.safe_load(f), name
        for key in chip_smoke.SCHEDULE_CUTS[name]:
            section, leaf = key.split(".")
            assert leaf in cfg[section], (name, key)


def test_port_imports_no_pandas_and_no_yaml_at_module_level():
    """The card's machine has neither pandas nor PyYAML: the port never
    imports pandas, and PyYAML only inside ``load_config``."""
    files = sorted((ROOT / "ananke_abm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    pandas = re.compile(r"^\s*(import|from)\s+pandas\b", re.M)
    top = re.compile(r"^(import|from)\s+(yaml|pandas)\b", re.M)
    for f in files:
        src = f.read_text()
        assert not pandas.search(src), f
        assert not top.search(src), f
