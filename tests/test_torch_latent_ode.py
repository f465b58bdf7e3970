"""The port's latent_ode family (``ananke_abm_tpu_torch/models/latent_ode``,
``data_generator/features.py``) against the JAX package's on the CPU: the
feature tables, the unified-timeline batch array for array, the closed-form
constraint gradient against ``jax.grad``, the flax bridges bit-exact both
ways, the forward's outputs and the loss components at rel 1e-5 with JAX's
own draws injected (fixed grid, per interval, RK4), the gradients at cosine
> 0.9999 per parameter, one Adam step against optax, the adjoint block
solve, checkpoints across packages with equal argmax ids, and the trainer's
checkpoint cadence."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parallel_worker import one_rank_mesh
from ananke_abm_tpu.data_generator import features as jfeat
from ananke_abm_tpu.models.latent_ode import data as jdata
from ananke_abm_tpu.models.latent_ode.config import GenerativeODEConfig as JC
from ananke_abm_tpu.models.latent_ode.inference import (
    BatchedInferenceEngine as JEngine,
)
from ananke_abm_tpu.models.latent_ode.loss import (
    calculate_composite_loss as j_loss,
)
from ananke_abm_tpu.models.latent_ode.model import GenerativeODE as JG
from ananke_abm_tpu.models.latent_ode.ode_components import (
    TimeEmbedODEFunc as JFunc,
    ode_block_solve as j_block,
)
from ananke_abm_tpu.models.latent_ode.train import (
    build_model_and_batch as j_build,
    make_forward as j_forward,
    train as j_train,
)
from ananke_abm_tpu_torch.data_generator import features as tfeat
from ananke_abm_tpu_torch.models.latent_ode import data as tdata
from ananke_abm_tpu_torch.models.latent_ode import evaluate as tevaluate
from ananke_abm_tpu_torch.models.latent_ode import model as tmodel
from ananke_abm_tpu_torch.models.latent_ode import ode_components as tcomp
from ananke_abm_tpu_torch.models.latent_ode import train as ttrain
from ananke_abm_tpu_torch.models.latent_ode.config import (
    GenerativeODEConfig as TC,
)
from ananke_abm_tpu_torch.models.latent_ode.inference import (
    BatchedInferenceEngine as TEngine,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

# tests/test_latent_ode.py's tiny widths; the fixed grid at sde_dt 0.1
# (241 internal steps over the 24 h span)
TINY = dict(hidden_dim=8, encoder_hidden_dim=16, ode_hidden_dim=16,
            zone_embed_dim=4, num_residual_blocks=1, sde_dt=0.1)
COS_MIN = 0.9999
# the reference's own bound between two float32 trajectories (the
# schedule trainer's, tests/test_torch_schedule_train.py): losses rtol
# 2e-4, parameters rtol 2e-3
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


def draws(rng, B, config, num_times=None):
    """The reference forward's draws for ``rng``: eps from fold_in(rng, 0);
    the SDE's step i from split(fold_in(fold_in(rng, 1), i), 1)[0]."""
    eps = jax.random.normal(jax.random.fold_in(rng, 0), (B, config.hidden_dim))
    sk = jax.random.fold_in(rng, 1)
    D = config.state_dim + config.hidden_dim
    if config.sde_dt:
        steps = int(round(config.sde_span_hours / config.sde_dt)) + 1
        keys = jnp.arange(steps)
    else:
        keys = jnp.arange((num_times - 1) * config.sde_substeps)
    noise = jax.vmap(lambda i: jax.random.normal(
        jax.random.split(jax.random.fold_in(sk, i), 1)[0], (B, D)))(keys)
    return torch.tensor(np.asarray(eps)), torch.tensor(np.asarray(noise))


class Pair:
    def __init__(self, seed=0, **overrides):
        kw = {**TINY, **overrides}
        self.jc, self.tc = JC(**kw), TC(**kw)
        self.jm, self.jb, self.host = j_build(self.jc)
        key = jax.random.PRNGKey(seed)
        b = self.jb
        self.params = _np(self.jm.init(
            {"params": key}, b["person_features"],
            b["all_zone_features"][b["home_zone_ids"]],
            b["all_zone_features"][b["work_zone_ids"]],
            b["initial_purpose_features"], b["initial_mode_features"],
            b["t_unified"], b["all_zone_features"], key)["params"])
        self.tm, self.tb, _ = ttrain.build_model_and_batch(self.tc,
                                                           device="cpu")
        tmodel.load_flax_params(self.tm, self.params)
        self.times = self.host["t_unified"].astype(np.float32)

    def j_loss_fn(self, rng):
        fwd = j_forward(self.jm)

        def loss(params):
            out = fwd(params, self.jb, rng)
            cand = self.jm.apply({"params": params},
                                 self.jb["all_zone_features"],
                                 method=JG.encode_zones)
            return j_loss(self.jb, out, cand, self.jc)

        return loss

    def t_draws(self, rng):
        return draws(rng, self.tb["person_features"].shape[0], self.tc,
                     len(self.times))


@pytest.fixture(scope="module")
def pair():
    return Pair()


# ---- numpy copies -----------------------------------------------------------

def test_feature_tables_equal_the_reference():
    for name in ("MODE_FEATURE_NAMES", "MODE_NAMES", "PURPOSE_FEATURE_NAMES",
                 "PURPOSE_NAMES", "MODE_ID_MAP", "ID_TO_MODE_MAP",
                 "PURPOSE_ID_MAP", "ID_TO_PURPOSE_MAP", "NUM_MODES",
                 "NUM_PURPOSES"):
        assert getattr(tfeat, name) == getattr(jfeat, name), name
    for name in ("MODE_TABLE", "PURPOSE_TABLE"):
        a, b = getattr(tfeat, name), getattr(jfeat, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tfeat.get_feature_dimensions() == jfeat.get_feature_dimensions()
    for i in range(tfeat.NUM_MODES):
        assert np.array_equal(tfeat.get_mode_features(i),
                              jfeat.get_mode_features(i))
    for i in range(tfeat.NUM_PURPOSES):
        assert np.array_equal(tfeat.get_purpose_features(i),
                              jfeat.get_purpose_features(i))
    for bad, fn in ((5, "get_mode_features"), (-1, "get_purpose_features")):
        with pytest.raises(ValueError, match="Invalid"):
            getattr(tfeat, fn)(bad)
    assert dataclasses.asdict(TC()) == dataclasses.asdict(JC())


@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("pids", [(1, 2), (2,), (2, 1)])
def test_unified_batch_equals_the_reference(pids, interp):
    jc = JC(train_on_interpolated_points=interp)
    tc = TC(train_on_interpolated_points=interp)
    for pid in pids:
        a, b = tdata.get_person_sample(pid, tc), jdata.get_person_sample(pid,
                                                                         jc)
        assert a.keys() == b.keys()
    want = jdata.unify_and_interpolate_batch(
        [jdata.get_person_sample(p, jc) for p in pids], jc)
    got = tdata.unify_and_interpolate_batch(
        [tdata.get_person_sample(p, tc) for p in pids], tc)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


# ---- the model --------------------------------------------------------------

def test_closed_form_potential_gradient_matches_jax_grad(pair):
    p = np.random.default_rng(1).standard_normal(
        (7, pair.tc.position_dim)).astype(np.float32) * 3
    p[0, [4, 8]] = 0.0  # both flags at 0: sigmoid' at its peak
    g = jax.grad(lambda q: pair.jm._potential(q))(jnp.asarray(p))
    got = np.zeros_like(p)
    cols = pair.tm.flag_cols.numpy()
    got[:, cols] = pair.tm.potential_grad(torch.tensor(p)).numpy()
    assert _rel(got, g) <= 1e-6
    want_u = float(pair.jm._potential(jnp.asarray(p)))
    assert abs(float(pair.tm._potential(torch.tensor(p))) - want_u) \
        <= 1e-6 * abs(want_u)
    # autograd of the port's U agrees with its closed form
    q = torch.tensor(p, requires_grad=True)
    pair.tm._potential(q).backward()
    assert _rel(q.grad.numpy(), got) <= 1e-6


def test_flax_bridge_is_bit_exact_both_ways(pair):
    got = tmodel.to_flax_params(pair.tm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(pair.params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(pair.params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own initialisation: the JAX model runs on its tree
    m = tmodel.GenerativeODE(8, 7, pair.tc)
    tmodel.init_params(m, torch.Generator().manual_seed(3))
    tree = tmodel.to_flax_params(m)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(pair.params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(pair.params)):
        assert a.shape == b.shape
    m2 = tmodel.GenerativeODE(8, 7, pair.tc)
    tmodel.load_flax_params(m2, tree)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    k = m.dynamics.inp.weight
    assert abs(float(k.detach().std()) - (1 / k.shape[1]) ** 0.5) < 0.05
    assert all(float(lin.bias.abs().max()) == 0 for lin in
               (m.dynamics.inp, m.decoder_loc, m.encoder[0]))


@pytest.mark.parametrize("variant", ["fixed", "interval", "rk4"])
def test_forward_and_loss_match_jax_with_its_draws(variant):
    over = {"fixed": {}, "interval": dict(sde_dt=None, sde_substeps=3),
            "rk4": dict(enable_sde=False, ode_method="rk4",
                        rk4_substeps=2)}[variant]
    pr = Pair(seed=2, **over)
    rng = jax.random.PRNGKey(7)
    (_, jcomps), jg = jax.value_and_grad(pr.j_loss_fn(rng), has_aux=True)(
        pr.params)
    jout = j_forward(pr.jm)(pr.params, pr.jb, rng)
    eps, noise = pr.t_draws(rng)
    tout = ttrain.make_forward(pr.tm)(pr.tb, None, eps, noise, pr.times)
    for name, a, b in zip(("loc_logits", "loc_embed", "purp_logits",
                           "mode_logits", "purpose_feat", "mode_feat", "mu",
                           "logvar"), tout, jout):
        assert a.shape == b.shape, name
        assert _rel(a.detach(), b) <= 1e-5, name
    loss_fn = ttrain.make_loss_fn(pr.tm, pr.tc)
    total, comps = loss_fn(pr.tb, None, eps, noise, pr.times)
    for k, v in jcomps.items():
        assert abs(float(comps[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    total.backward()
    grads = tmodel.entries_to_flax({
        k: (lay, [v[0].grad]) for k, (lay, v) in
        tmodel.param_entries(pr.tm).items()})
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(grads)):
        assert _cos(b, a) > COS_MIN, jax.tree_util.keystr(path)


def test_loss_argmax_takes_the_first_index_on_ties(pair):
    out = list(ttrain.make_forward(pair.tm)(
        pair.tb, torch.Generator().manual_seed(0), times=pair.times))
    out[0] = torch.zeros_like(out[0])  # every zone ties: argmax is zone 0
    cand = pair.tm.encode_zones(pair.tb["all_zone_features"])
    _, comps = ttrain.calculate_composite_loss(pair.tb, tuple(out), cand,
                                               pair.tc)
    b = pair.tb
    m = b["loss_mask"]
    want = (b["distance_matrix"][0][b["y_loc_dense"].clamp_min(0)] * m).sum() \
        / m.sum()
    assert torch.allclose(comps["distance"], want)


def test_adam_step_matches_optax(pair):
    pr = Pair(seed=4)
    rng = jax.random.PRNGKey(9)
    loss_j = pr.j_loss_fn(rng)
    opt = optax.adam(pr.jc.learning_rate)
    params, state = pr.params, opt.init(pr.params)
    eps, noise = pr.t_draws(rng)
    topt = ttrain.make_optimizer(pr.tm, pr.tc)
    loss_t = ttrain.make_loss_fn(pr.tm, pr.tc)
    (jl, _), g = jax.value_and_grad(loss_j, has_aux=True)(params)
    upd, state = opt.update(g, state, params)
    params = optax.apply_updates(params, upd)
    topt.zero_grad()
    tl, _ = loss_t(pr.tb, None, eps, noise, pr.times)
    tl.backward()
    topt.step()
    np.testing.assert_allclose(float(tl), float(jl), **TRAJ_LOSS)
    got = tmodel.to_flax_params(pr.tm)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_np(params))):
        np.testing.assert_allclose(a, b, **TRAJ_PARAMS)


def test_ode_block_solve_matches_jax_with_gradients():
    func = JFunc(dim=3, hidden_dim=5)
    x0 = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
    times = np.asarray([0.0, 0.5, 1.5], np.float32)
    params = _np(func.init(jax.random.PRNGKey(1), 0.0, jnp.asarray(x0),
                           jnp.asarray(x0))["params"])

    def jl(p, x):
        return jnp.sum(j_block(func, p, x, jnp.asarray(times))[1:] ** 2)

    (jv, (jgp, jgx)) = jax.value_and_grad(jl, argnums=(0, 1))(
        params, jnp.asarray(x0))
    tf = tcomp.TimeEmbedODEFunc(3, hidden_dim=5)
    tcomp.load_flax_params(tf, params)
    for a, b in zip(jax.tree_util.tree_leaves(tcomp.to_flax_params(tf)),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)
    x = torch.tensor(x0, requires_grad=True)
    ys = tcomp.ode_block_solve(tf, None, x, torch.tensor(times))
    tv = (ys[1:] ** 2).sum()
    tv.backward()
    assert abs(float(tv) - float(jv)) <= 1e-4 * abs(float(jv))
    assert _cos(x.grad.numpy(), jgx) > COS_MIN
    grads = tcomp.entries_to_flax({
        k: (lay, [v[0].grad]) for k, (lay, v) in
        tcomp.param_entries(tf).items()})
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jgp)):
        assert _cos(a, b) > COS_MIN


# ---- checkpoints, inference, the trainer ------------------------------------

def _jax_draws(config, seed, num_samples, times):
    keys = jax.random.split(jax.random.PRNGKey(seed), num_samples)
    return [draws(k, 2, config, len(times)) for k in keys]


def test_checkpoints_infer_across_packages(tmp_path):
    """A checkpoint written by the JAX package's train() predicts the same
    ids in the port (JAX's draws injected), and one written by the port's
    train() predicts in JAX the same ids as in the port: every id equal."""
    times = np.linspace(0.0, 24.0, 30).astype(np.float32)
    jc, tc = JC(**TINY), TC(**TINY)
    j_train(str(tmp_path / "jax"), config=jc, num_iterations=4,
            steps_per_call=2, log_every=0)
    jpath = str(tmp_path / "jax" / "latent_ode_best_model.ckpt")
    assert load_checkpoint(jpath)["iteration"] > 0
    want = JEngine(jpath).predict_trajectories(num_samples=2, times=times,
                                               seed=3)
    got = TEngine(jpath, device="cpu").predict_trajectories(
        num_samples=2, times=times, draws=_jax_draws(tc, 3, 2, times))
    for k in ("zones", "purposes", "modes"):
        assert got[k].shape == (2, 2, 30) and got[k].dtype == np.int32
        assert np.array_equal(got[k], want[k]), k

    res = ttrain.train(str(tmp_path / "port"), config=tc, num_iterations=4,
                       steps_per_call=2, log_every=0, device="cpu")
    assert load_checkpoint(res["ckpt"])["iteration"] > 0
    want = JEngine(res["ckpt"]).predict_trajectories(num_samples=2,
                                                     times=times, seed=4)
    got = TEngine(res["ckpt"], device="cpu").predict_trajectories(
        num_samples=2, times=times, draws=_jax_draws(tc, 4, 2, times))
    for k in ("zones", "purposes", "modes"):
        assert np.array_equal(got[k], want[k]), k


def test_train_writes_the_reference_files_at_its_cadence(tmp_path,
                                                         monkeypatch):
    """latent_ode_best_model.ckpt is written at the end of a call whose
    last step's total beat the best so far, and only then."""
    saved = []
    real = ttrain.save_checkpoint

    def spy(obj, path):
        saved.append(obj["iteration"])
        real(obj, path)

    monkeypatch.setattr(ttrain, "save_checkpoint", spy)
    cfg = TC(**{**TINY, "sde_dt": 0.25})
    out = str(tmp_path / "run")
    res = ttrain.train(out, config=cfg, num_iterations=7, steps_per_call=3,
                       log_every=0, device="cpu")
    hist = np.load(os.path.join(out, "loss_history.npz"))
    # sorted, as the reference's jitted steps return their dict
    assert list(hist.files) == sorted(ttrain.COMPONENTS)
    assert all(hist[k].shape == (7,) for k in hist.files)
    best, want = np.inf, []
    for end in (3, 6, 7):
        if hist["total"][end - 1] < best:
            best = hist["total"][end - 1]
            want.append(end)
    assert saved == want
    assert res["best_loss"] == float(best)
    ck = load_checkpoint(res["ckpt"])
    assert set(ck) == {"params", "config", "person_ids", "iteration"}
    assert ck["iteration"] == want[-1] and ck["person_ids"] == [1, 2]
    # the same seed gives the same history
    res2 = ttrain.train(str(tmp_path / "again"), config=cfg,
                        num_iterations=7, steps_per_call=3, log_every=0,
                        device="cpu")
    hist2 = np.load(os.path.join(tmp_path, "again", "loss_history.npz"))
    assert np.array_equal(hist2["total"], hist["total"])
    assert res2["best_loss"] == res["best_loss"]

    # the inference engine, the benchmark and evaluate() on it
    eng = TEngine(res["ckpt"], device="cpu")
    pred = eng.predict_trajectories(num_samples=2)
    assert pred["zones"].shape == (2, 2, len(eng.times))
    bench = eng.benchmark_performance(batch_sizes=(1, 3))
    assert bench[3]["people_per_s"] > 0 and "projected_1M_people_hours" \
        in bench
    metrics = tevaluate.evaluate(res["ckpt"], str(tmp_path / "ev"),
                                 num_eval_points=40, make_plots=False,
                                 device="cpu")
    assert set(metrics["persons"]) == {"Ava", "Theo"}
    assert os.path.exists(tmp_path / "ev" / "eval_metrics.json")


def test_entry_points_refuse_a_missing_device(tmp_path):
    with pytest.raises(ValueError, match="device is required"):
        ttrain.train(str(tmp_path), config=TC(**TINY), num_iterations=1,
                     device=None)
    with pytest.raises(ValueError, match="device is required"):
        ttrain.build_model_and_batch(TC(**TINY), device=None)
    path = str(tmp_path / "c.ckpt")
    m = tmodel.GenerativeODE(8, 7, TC(**TINY))
    ttrain.save_checkpoint({"params": tmodel.to_flax_params(m),
                            "config": dataclasses.asdict(TC(**TINY))}, path)
    with pytest.raises(ValueError, match="device is required"):
        TEngine(path, device=None)
    # a mesh shards the person axis: a one-rank mesh's engine predicts the
    # single-device engine's ids (2-rank meshes: test_torch_parallel_*.py)
    want = TEngine(path, device="cpu").predict_trajectories(num_samples=1)
    with one_rank_mesh(tmp_path) as mesh:
        got = TEngine(path, mesh=mesh, device="cpu").predict_trajectories(
            num_samples=1)
    for k in ("zones", "purposes", "modes"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="device is required"):
        tevaluate.evaluate(path, str(tmp_path / "ev"), device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.train(str(tmp_path), config=TC(**TINY),
                         num_iterations=1, device="cuda")
