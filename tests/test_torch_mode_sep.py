"""The port's mode_sep family (``ananke_abm_tpu_torch/models/mode_sep``) and
the numpy copy of the mock world's CSV exporter
(``data_generator/export_csvs.py``) against the JAX package's on the CPU:
the CSV family byte-equal to the pandas writer's, the loader's people and
zone tables and its errors, the union grid array for array, the flax
bridge bit-exact both ways, the outputs and loss components at rel 1e-5
(RK4 and the fixed-grid SDE with JAX's noise injected) and their
gradients at cosine > 0.9999, one step of the zero-nonfinite -> clip ->
AdamW chain against optax (also with an injected inf gradient),
checkpoints across packages with byte-equal ``predictions.csv`` and
``evaluate`` metrics within 1e-5, and ``train_from_yaml``."""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from ananke_abm_tpu.data_generator import export_csvs as jexport
from ananke_abm_tpu.data_generator.mock_world import Persona
from ananke_abm_tpu.models.mode_sep import batching as jbatching
from ananke_abm_tpu.models.mode_sep import data as jdata
from ananke_abm_tpu.models.mode_sep.config import ModeSepConfig as JC
from ananke_abm_tpu.models.mode_sep.evaluate import evaluate as j_evaluate
from ananke_abm_tpu.models.mode_sep.evaluate import rank_auc as j_auc
from ananke_abm_tpu.models.mode_sep.inference import (
    run_inference as j_run_inference,
)
from ananke_abm_tpu.models.mode_sep.losses import total_loss as j_total
from ananke_abm_tpu.models.mode_sep.model import ModeSepModel as JM
from ananke_abm_tpu.models.mode_sep.train import _zero_nonfinite
from ananke_abm_tpu.models.mode_sep.train import train as j_train
from ananke_abm_tpu.models.mode_sep.train import (
    union_to_device as j_union_to_device,
)
from ananke_abm_tpu_torch.data_generator import export_csvs as texport
from ananke_abm_tpu_torch.data_generator import mock_world as tworld
from ananke_abm_tpu_torch.models import mode_sep as tpkg
from ananke_abm_tpu_torch.models.mode_sep import batching as tbatching
from ananke_abm_tpu_torch.models.mode_sep import data as tdata
from ananke_abm_tpu_torch.models.mode_sep import model as tmodel
from ananke_abm_tpu_torch.models.mode_sep import train as ttrain
from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig as TC
from ananke_abm_tpu_torch.models.mode_sep.evaluate import (
    evaluate as t_evaluate,
    rank_auc as t_auc,
)
from ananke_abm_tpu_torch.models.mode_sep.inference import (
    load_model,
    rollout,
    run_inference as t_run_inference,
)
from ananke_abm_tpu_torch.models.mode_sep.losses import total_loss as t_total
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

DATA = os.path.join(os.path.dirname(__file__), "data")
PERIODS = os.path.join(DATA, "periods_small.csv")
SNAPS = os.path.join(DATA, "snaps_small.csv")
# tests/test_mode_sep.py's tiny widths
TINY = dict(emb_dim=8, context_dim=8, zone_emb_dim=4, hidden_dim=16,
            num_res_blocks=1, K_internal=2, rk4_substeps=2, sde_dt=0.1,
            dense_resolution=50)
COS_MIN = 0.9999
# the reference's own bound between two float32 trajectories
# (tests/test_torch_schedule_train.py)
TRAJ_LOSS = dict(rtol=2e-4, atol=1e-6)
TRAJ_PARAMS = dict(rtol=2e-3, atol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b / (na * nb))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mock_world")
    return texport.write_mock_world_csvs(str(d))


def _full(paths):
    return (paths["periods.csv"], paths["snaps.csv"], paths["zones.csv"],
            paths["persons.csv"], paths["dist_mat.csv"])


# ---- the CSV family ---------------------------------------------------------

@pytest.mark.parametrize("pids", [(1, 2), (2,), (2, 1)])
def test_mock_world_csvs_are_byte_equal_to_pandas(pids, tmp_path):
    want = jexport.write_mock_world_csvs(str(tmp_path / "j"), pids)
    got = texport.write_mock_world_csvs(str(tmp_path / "t"), pids)
    assert list(got) == list(want)
    for name in want:
        assert _bytes(got[name]) == _bytes(want[name]), name


def _persona(events):
    return Persona(person_id=7, name="Ida", age=41, income=51000.5,
                   home_zone=2, work_zone=4, employment="fulltime",
                   commute_mode="walk", flexibility=0.5, events=events)


# ties in start time, a travel that swallows its stay, a repeated zone,
# a last event at midnight, a trip with no later stay
ODD_EVENTS = [
    [(6.0, 2, "home", "stay", 1), (6.25, 4, "work", "walk", 1),
     (6.25, 4, "work", "stay", 0), (12.0, 3, "shopping", "bike", 0),
     (12.4, 2, "home", "walk", 0), (23.9, 5, "social", "car", 1)],
    [(0.0, 1, "home", "stay", 1), (24.0, 1, "home", "stay", 1)],
    [(5.0, 3, "home", "stay", 1), (5.1, 3, "home", "stay", 0),
     (5.2, 6, "education", "public_transit", 0)],
]


@pytest.mark.parametrize("events", ODD_EVENTS)
def test_period_snap_segment_builders_match_pandas(events, tmp_path):
    p_j, p_t = _persona(events), _persona(events)
    jp = jexport.build_person_periods(p_j)
    tp = texport.build_person_periods(p_t)
    for name, jf, tf in (
            ("periods", jp, tp),
            ("snaps", jexport.build_snaps_from_periods(jp),
             texport.build_snaps_from_periods(tp)),
            ("segments", jexport.build_segments_from_periods(jp),
             texport.build_segments_from_periods(tp))):
        jf.to_csv(tmp_path / f"{name}_j.csv", index=False)
        texport.write_frame(tf, str(tmp_path / f"{name}_t.csv"))
        assert _bytes(tmp_path / f"{name}_t.csv") == \
            _bytes(tmp_path / f"{name}_j.csv"), name


def test_port_imports_no_pandas_and_plots_lazily():
    """No module of the two families or the data generator imports pandas;
    matplotlib and yaml are imported only inside functions."""
    import ananke_abm_tpu_torch
    root = os.path.dirname(ananke_abm_tpu_torch.__file__)
    for sub in ("models/mode_sep", "models/latent_ode", "data_generator",
                "ode"):
        for f in os.listdir(os.path.join(root, sub)):
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(root, sub, f)):
                assert not re.match(r"\s*(import|from)\s+pandas\b",
                                    line), (f, line)
                assert not line.startswith(("import matplotlib",
                                            "from matplotlib",
                                            "import yaml")), (f, line)


# ---- the loader and the union grid -------------------------------------------

def _same_people(got, want):
    (gp, gs), (wp, ws) = got, want
    assert len(gp) == len(wp)
    for a, b in zip(gp, wp):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name
    assert gs.zone_names == ws.zone_names
    assert dataclasses.asdict(gs.id_maps) == dataclasses.asdict(ws.id_maps)
    assert gs.dist_mat.dtype == ws.dist_mat.dtype
    assert np.array_equal(gs.dist_mat, ws.dist_mat)
    if ws.zone_features is None:
        assert gs.zone_features is None
    else:
        assert np.array_equal(gs.zone_features, ws.zone_features)


def test_loader_equals_the_reference(world):
    _same_people(tdata.load_trajectory_csvs(PERIODS, SNAPS),
                 jdata.load_trajectory_csvs(PERIODS, SNAPS))
    _same_people(tdata.load_trajectory_csvs(*_full(world)),
                 jdata.load_trajectory_csvs(*_full(world)))


def _edit(src, dst, fn):
    df = pd.read_csv(src)
    df = fn(df)
    df.to_csv(dst, index=False)
    return str(dst)


BAD = {
    "period_type": ("periods", lambda d: d.assign(
        type=["teleport" if i == 1 else t for i, t in enumerate(d.type)])),
    "missing_column": ("snaps", lambda d: d.drop(columns=["anchor"])),
    "text_in_numbers": ("snaps", lambda d: d.astype({"timestamp": object})
                        .assign(timestamp=["x"] + list(d.timestamp[1:]))),
    "unknown_location": ("periods", lambda d: d.assign(
        location=["Atlantis"] + list(d.location[1:]))),
    "dist_header": ("dist_mat.csv", lambda d: d.rename(
        columns={d.columns[2]: "Nowhere"})),
    "dist_rows": ("dist_mat.csv", lambda d: d.iloc[::-1]),
    "dist_first": ("dist_mat.csv", lambda d: d.rename(
        columns={"loc_id": "zone"})),
    "dist_asym": ("dist_mat.csv", lambda d: d.assign(
        **{d.columns[2]: [9.0] + list(d[d.columns[2]][1:])})),
    "dist_diag": ("dist_mat.csv", lambda d: d.assign(
        **{d.columns[1]: [0.5] + list(d[d.columns[1]][1:])})),
    "persons_missing": ("persons.csv", lambda d: d.iloc[:1]),
    "persons_zone": ("persons.csv", lambda d: d.assign(
        home_zone_id=[99] + list(d.home_zone_id[1:]))),
    "zones_dup": ("zones.csv", lambda d: d.assign(
        name=[d.name[1]] + list(d.name[1:]))),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_loader_raises_the_reference_errors(case, world, tmp_path):
    which, fn = BAD[case]
    paths = dict(world)
    key = {"periods": "periods.csv", "snaps": "snaps.csv"}.get(which, which)
    paths[key] = _edit(paths[key], tmp_path / key, fn)
    args = _full(paths)
    with pytest.raises(Exception) as want:
        jdata.load_trajectory_csvs(*args)
    with pytest.raises(type(want.value)) as got:
        tdata.load_trajectory_csvs(*args)
    assert str(got.value) == str(want.value)


def test_data_paths_yaml_resolves_as_the_reference(world, tmp_path):
    d = os.path.dirname(world["periods.csv"])
    y = tmp_path / "paths.yml"
    y.write_text("periods_csv: %s\nsnaps_csv: %s\nzones_csv: %s\n"
                 % (os.path.relpath(world["periods.csv"], tmp_path),
                    world["snaps.csv"], os.path.join(d, "zones.csv")))
    assert tdata.load_data_paths_yaml(str(y)) == \
        jdata.load_data_paths_yaml(str(y))
    y.write_text("periods_csv: nowhere.csv\n")
    with pytest.raises(FileNotFoundError, match="periods_csv"):
        tdata.load_data_paths_yaml(str(y))


@pytest.mark.parametrize("K", [0, 2, 8])
def test_union_batch_equals_the_reference(K, world):
    for args in ((PERIODS, SNAPS), _full(world)):
        want = jbatching.build_union_batch(
            jdata.load_trajectory_csvs(*args)[0], K)
        got = tbatching.build_union_batch(
            tdata.load_trajectory_csvs(*args)[0], K)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
    t = np.array([0.0, 1.0, 2.0], np.float32)
    assert np.array_equal(tbatching.insert_internal_points(t, 3),
                          jbatching.insert_internal_points(t, 3))


# ---- the model, the losses and a step ----------------------------------------

class Pair:
    def __init__(self, seed=0, args=(PERIODS, SNAPS), **overrides):
        kw = {**TINY, **overrides}
        self.jc, self.tc = JC(**kw), TC(**kw)
        people, self.shared = jdata.load_trajectory_csvs(*args)
        union = jbatching.build_union_batch(people, self.jc.K_internal)
        self.jtimes, self.jfb = j_union_to_device(union)
        self.Z = self.shared.id_maps.Z
        self.jm = JM(Z=self.Z, config=self.jc)
        key = jax.random.PRNGKey(seed)
        p = self.jm.init({"params": key, "sde": key}, self.jtimes,
                         self.jfb["home_idx"], self.jfb["work_idx"],
                         self.jfb["traits"])["params"]
        # a moving start: the zero-initialised drift output made nonzero
        p["drift"]["Dense_1"]["kernel"] = 0.1 * jax.random.normal(
            jax.random.fold_in(key, 1), p["drift"]["Dense_1"]["kernel"].shape)
        self.params = _np(p)
        tpeople, tshared = tdata.load_trajectory_csvs(*args)
        self.union = tbatching.build_union_batch(tpeople, self.tc.K_internal)
        self.ttimes, self.tfb = ttrain.union_to_device(self.union, "cpu")
        self.tm = tmodel.ModeSepModel(self.Z, self.tc)
        tmodel.load_flax_params(self.tm, self.params)
        self.dist = torch.tensor(tshared.dist_mat)
        self._vg = jax.jit(jax.value_and_grad(self._j_loss, has_aux=True))

    def times(self):
        return self.union.times_union if self.tc.enable_sde else self.ttimes

    def _j_loss(self, p, rng):
        out = self.jm.apply({"params": p}, self.jtimes, self.jfb["home_idx"],
                            self.jfb["work_idx"], self.jfb["traits"], rng=rng)
        pe, lg, v = out
        total, comps = j_total(self.jc, lg, pe, v, p["class_table"],
                               jnp.asarray(self.shared.dist_mat), self.jfb)
        return total, (comps, out)

    def j_value_and_grad(self, params=None, rng=jax.random.PRNGKey(0)):
        """((total, (components, outputs)), grads) of the JAX model, jitted
        once per pair."""
        return self._vg(self.params if params is None else params, rng)

    def fresh_torch(self, **overrides):
        """The port's model on this pair's JAX params."""
        m = tmodel.ModeSepModel(self.Z, dataclasses.replace(self.tc,
                                                             **overrides))
        tmodel.load_flax_params(m, self.params)
        return m

    def noise(self, rng):
        if not self.tc.enable_sde:
            return None
        B, D = 2, 2 * self.tc.emb_dim + self.tc.context_dim
        steps = int(round(self.tc.sde_span_hours / self.tc.sde_dt)) + 1
        return torch.tensor(np.asarray(jax.vmap(lambda i: jax.random.normal(
            jax.random.split(jax.random.fold_in(rng, i), 1)[0], (B, D)))(
            jnp.arange(steps))))


@pytest.fixture(scope="module")
def pairs():
    return {sde: Pair(seed=3, enable_sde=sde) for sde in (False, True)}


def test_flax_bridge_is_bit_exact_both_ways(pairs):
    pr = pairs[False]
    got = tmodel.to_flax_params(pr.tm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(pr.params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(pr.params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    m = tmodel.ModeSepModel(pr.Z, pr.tc)
    tmodel.init_params(m, torch.Generator().manual_seed(1))
    tree = tmodel.to_flax_params(m)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(pr.params)):
        assert a.shape == b.shape
    assert float(m.drift.out.weight.detach().abs().max()) == 0.0
    a = (6.0 / (pr.Z + pr.tc.emb_dim)) ** 0.5
    assert float(m.class_table.detach().abs().max()) <= a
    # the JAX model runs on the port's initialisation, at rest
    (_, (_, (pe, lg, v))), _ = pr.j_value_and_grad(tree)
    assert float(jnp.abs(v).max()) == 0.0


@pytest.mark.parametrize("sde", [False, True])
def test_outputs_loss_and_gradients_match_jax(sde, pairs):
    pr = pairs[sde]
    rng = jax.random.PRNGKey(8)
    (_, (jcomps, jout)), jg = pr.j_value_and_grad(rng=rng)
    tm = pr.fresh_torch()
    tout = tm(pr.times(), pr.tfb["home_idx"], pr.tfb["work_idx"],
              pr.tfb["traits"], None, pr.noise(rng))
    for name, a, b in zip(("pred_emb", "logits", "v"), tout, jout):
        assert _rel(a.detach(), b) <= 1e-5, name
    total, comps = t_total(pr.tc, tout[1], tout[0], tout[2],
                           tm.class_table, pr.dist, pr.tfb)
    assert set(comps) == set(jcomps)
    for k, v in jcomps.items():
        assert abs(float(comps[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    total.backward()
    grads = tmodel.entries_to_flax({
        k: (lay, [v[0].grad]) for k, (lay, v) in
        tmodel.param_entries(tm).items()})
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(grads)):
        assert _cos(b, a) > COS_MIN, jax.tree_util.keystr(path)


def test_gradients_are_finite_at_rest(pairs):
    """The zero-initialised drift starts at v == 0 exactly: every gradient
    stays finite there (the + 1e-12 inside the square roots)."""
    pr = pairs[False]
    m = tmodel.ModeSepModel(pr.Z, TC())
    tmodel.init_params(m, torch.Generator().manual_seed(0))
    u = tbatching.build_union_batch(
        tdata.load_trajectory_csvs(PERIODS, SNAPS)[0], TC().K_internal)
    times, fb = ttrain.union_to_device(u, "cpu")
    pe, lg, v = m(times, fb["home_idx"], fb["work_idx"], fb["traits"])
    assert float(v.abs().max()) == 0.0
    total, _ = t_total(TC(), lg, pe, v, m.class_table, pr.dist, fb)
    total.backward()
    for name, p in m.named_parameters():
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("inject_inf", [False, True])
def test_step_matches_the_optax_chain(inject_inf, pairs):
    pr = pairs[False]
    wd = 1e-4
    tm = pr.fresh_torch(weight_decay=wd)
    opt = optax.chain(_zero_nonfinite(),
                      optax.clip_by_global_norm(pr.jc.grad_clip),
                      optax.adamw(pr.jc.lr, weight_decay=wd))
    (jl, _), g = pr.j_value_and_grad()
    g = jax.tree_util.tree_map(np.array, g)  # writable copies
    if inject_inf:
        g["decoder"]["layers_0"]["kernel"][0, 0] = np.inf
        tm.decoder[0].weight.register_hook(
            lambda t: t.index_put((torch.tensor(0), torch.tensor(0)),
                                  torch.tensor(float("inf"))))
    upd, _ = opt.update(g, opt.init(pr.params), pr.params)
    after = _np(optax.apply_updates(pr.params, upd))
    topt = ttrain.make_optimizer(tm, tm.config)
    step = ttrain.make_train_step(tm, topt, tm.config, pr.dist, pr.times())
    comps = step(pr.tfb, torch.arange(2))
    loss = comps[ttrain.CURVE_COLUMNS.index("loss")]
    np.testing.assert_allclose(float(loss), float(jl), **TRAJ_LOSS)
    got = tmodel.to_flax_params(tm)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(after)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **TRAJ_PARAMS)


def test_epoch_rows_follow_the_reference_permutation():
    rows = ttrain.epoch_rows(42, 3, 7, 2)
    perm = np.random.default_rng(45).permutation(7)
    assert np.array_equal(rows.ravel(), perm[:6])
    assert np.array_equal(ttrain.epoch_rows(42, 1, 2, 2)[0],
                          np.random.default_rng(43).permutation(2))


def test_rank_auc_equals_the_reference():
    rng = np.random.default_rng(0)
    pos = np.round(rng.standard_normal(40), 1)
    neg = np.round(rng.standard_normal(30) - 0.5, 1)  # ties
    assert t_auc(pos, neg) == j_auc(pos, neg)
    assert np.isnan(t_auc(pos[:0], neg))


# ---- checkpoints, inference, evaluate, train_from_yaml ------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny JAX training run and one port run on the fixtures."""
    d = tmp_path_factory.mktemp("mode_sep")
    cfg = dict(TINY, max_epochs=2)
    jres = j_train(PERIODS, SNAPS, str(d / "j"), config=JC(**cfg))
    tres = ttrain.train(PERIODS, SNAPS, str(d / "t"), config=TC(**cfg),
                        device="cpu")
    return d, jres["ckpt"], tres


def test_train_writes_the_reference_files(trained, tmp_path):
    d, jckpt, tres = trained
    ck = load_checkpoint(tres["ckpt"])
    assert set(ck) == set(load_checkpoint(jckpt)) == \
        {"params", "config", "Z", "zone_names", "epoch"}
    lines = open(d / "t" / "curves.csv").read().splitlines()
    assert lines[0] == open(d / "j" / "curves.csv").read().splitlines()[0]
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2"]
    assert ck["zone_names"] == load_checkpoint(jckpt)["zone_names"]
    assert np.isfinite(tres["best_loss"])


@pytest.mark.parametrize("which", ["jax", "port"])
def test_checkpoints_infer_across_packages(which, trained):
    d, jckpt, tres = trained
    ckpt = jckpt if which == "jax" else tres["ckpt"]
    out_j, out_t = d / f"inf_j_{which}", d / f"inf_t_{which}"
    jdf = j_run_inference(ckpt, PERIODS, SNAPS, str(out_j))
    got = t_run_inference(ckpt, PERIODS, SNAPS, str(out_t), device="cpu")
    assert _bytes(out_t / "predictions.csv") == \
        _bytes(out_j / "predictions.csv")
    assert list(got) == list(jdf.columns) and len(got["time"]) == 12
    for k in got:
        assert list(got[k]) == list(jdf[k]), k
    with np.load(out_j / "dense_rollout.npz") as a, \
            np.load(out_t / "dense_rollout.npz") as b:
        assert list(b.files) == list(a.files)
        for k in ("times", "person_ids"):
            assert np.array_equal(a[k], b[k])
        for k in ("logits", "velocity", "pred_emb"):
            assert _rel(b[k], a[k]) <= 1e-5, k
    want = j_evaluate(ckpt, PERIODS, SNAPS, str(d / f"ev_j_{which}"))
    metrics = t_evaluate(ckpt, PERIODS, SNAPS, str(d / f"ev_t_{which}"),
                         device="cpu")
    assert json.load(open(d / f"ev_t_{which}" / "metrics.json")) == metrics

    def close(a, b, path=""):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                close(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), path
        else:
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), path

    close(metrics, want)


def test_sde_rollout_draws_from_the_generator(trained):
    _, _, tres = trained
    model, config, _ = load_model(tres["ckpt"], device="cpu")
    model.config = dataclasses.replace(config, enable_sde=True)
    u = tbatching.build_union_batch(
        tdata.load_trajectory_csvs(PERIODS, SNAPS)[0], config.K_internal)
    args = (u.times_union, u.home_idx, u.work_idx, u.traits)
    a = rollout(model, config, *args, torch.Generator().manual_seed(1))
    b = rollout(model, config, *args, torch.Generator().manual_seed(1))
    c = rollout(model, config, *args, torch.Generator().manual_seed(2))
    assert np.array_equal(a[2], b[2]) and not np.array_equal(a[2], c[2])


def test_train_from_yaml_and_the_sde_variant(world, tmp_path):
    y = tmp_path / "paths.yml"
    y.write_text("".join(f"{k.replace('.csv', '')}_csv: {v}\n"
                         for k, v in world.items() if k.endswith(".csv")))
    cfg = TC(**dict(TINY, max_epochs=1, enable_sde=True, sde_dt=0.25))
    res = tpkg.train_from_yaml(str(y), str(tmp_path / "run"), config=cfg,
                               device="cpu")
    assert np.isfinite(res["best_loss"])
    assert load_checkpoint(res["ckpt"])["zone_names"] == tworld.zone_names()


def test_entry_points_refuse_a_missing_device(trained, tmp_path):
    _, jckpt, _ = trained
    calls = (
        lambda: ttrain.train(PERIODS, SNAPS, str(tmp_path), device=None),
        lambda: t_run_inference(jckpt, PERIODS, SNAPS, str(tmp_path),
                                device=None),
        lambda: t_evaluate(jckpt, PERIODS, SNAPS, str(tmp_path),
                           device=None),
        lambda: load_model(jckpt, device=None),
    )
    for call in calls:
        with pytest.raises(ValueError, match="device is required"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_model(jckpt, device="cuda")
