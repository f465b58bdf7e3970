"""The port's traj_syn family (``ananke_abm_tpu_torch/models/traj_syn``,
``utils/make_purposes.py``, ``utils/traj_fig``) against the JAX package's
on the same seeded inputs, on the CPU: the purposes catalog's CSV and the
segment CSV byte-equal, the buffer grid equal, the flax bridge bit-exact,
the model's outputs, one loss-and-ClippedAdamW step against ``jax.grad``
and optax in each CRF mode, an epoch with JAX's permutation and noise
injected, and checkpoints generating the same labels across packages
with the same latents."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from ananke_abm_tpu.data_generator.population import (
    generate_population_activities,
)
from ananke_abm_tpu.losses import cross_entropy_masked as j_ce
from ananke_abm_tpu.losses import kl_gaussian as j_kl
from ananke_abm_tpu.models.traj_syn.model import TrajEmbedVAE as JTraj
from ananke_abm_tpu.models.traj_syn.pipeline import train_full as jtrain
from ananke_abm_tpu.models.traj_syn.pipeline import validate as jval
from ananke_abm_tpu.ops.crf import crf_nll as j_crf_nll
from ananke_abm_tpu.ops.semi_crf import semicrf_nll as j_semicrf_nll
from ananke_abm_tpu.utils import save_checkpoint as j_save
from ananke_abm_tpu.utils.make_purposes import build_purposes_catalog as jcat
from ananke_abm_tpu.utils.traj_fig.make_buffer_grid import (
    make_buffer_grid as jgrid,
)
from ananke_abm_tpu_torch.dataio.rasterize import read_csv
from ananke_abm_tpu_torch.models.traj_syn import model as tmodel
from ananke_abm_tpu_torch.models.traj_syn.configs import (
    CRFConfig,
    TrajEmbedConfig,
)
from ananke_abm_tpu_torch.models.traj_syn.pipeline import train_full as ttrain
from ananke_abm_tpu_torch.models.traj_syn.pipeline import validate as tval
from ananke_abm_tpu_torch.models.traj_syn.pipeline.vae_only import (
    analyze_vae,
    synthesize_vae,
)
from ananke_abm_tpu_torch.utils.make_purposes import (
    LEAD_COLUMNS,
    build_purposes_catalog as tcat,
    read_catalog,
)
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
from ananke_abm_tpu_torch.utils.traj_fig.make_buffer_grid import (
    make_buffer_grid as tgrid,
)

CFG = TrajEmbedConfig(grid_min=60, horizon_min=1800, z_dim=4, emb_dim=16,
                      cnn_channels=(16,), cnn_kernel=3, cnn_dropout=0.0)
L = CFG.L  # 30 bins
DMAX_MIN = 300  # 5 bins: the grid's overnight Home runs exceed it
Z = CFG.z_dim


@pytest.fixture(scope="module")
def acts(tmp_path_factory):
    d = tmp_path_factory.mktemp("traj_syn")
    p = os.path.join(d, "acts.csv")
    generate_population_activities(48, seed=3).to_csv(p, index=False)
    return p


@pytest.fixture(scope="module")
def grid(acts):
    return tgrid(acts, grid_min=CFG.grid_min, horizon_min=CFG.horizon_min)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the buffer grid and the purposes catalog ------------------------------

@pytest.mark.parametrize("grid_min,horizon", [(5, 1800), (10, 1800),
                                              (60, 1800), (15, 1440)])
def test_buffer_grid_equals_jax(acts, grid_min, horizon):
    Yj, pmj, pj = jgrid(acts, grid_min=grid_min, horizon_min=horizon)
    Yt, pmt, pt = tgrid(acts, grid_min=grid_min, horizon_min=horizon)
    np.testing.assert_array_equal(Yt, Yj)
    assert pmt == pmj and list(pt) == list(pj)
    assert (Yt[:, -1] == pmt["Home"]).all()


def test_buffer_grid_from_columns_renames_startime_and_adds_home(acts):
    cols = read_csv(acts)
    cols["startime"] = cols.pop("starttime")
    keep = cols["purpose"] != "Home"
    cols = {k: v[keep] for k, v in cols.items()}
    df = pd.DataFrame(cols)
    Yj, pmj, _ = jgrid(df, grid_min=30)
    Yt, pmt, _ = tgrid(cols, grid_min=30)
    assert "Home" in pmt and pmt == pmj
    np.testing.assert_array_equal(Yt, Yj)


def _catalog_case(name, acts, d):
    """(activities CSV, kwargs) of one catalog case."""
    df = pd.read_csv(acts)
    if name == "fixture":
        return acts, {}
    if name == "overrides":
        yml = os.path.join(d, "ov.yaml")
        with open(yml, "w") as f:
            f.write("Home:\n  is_primary: 'N'\n  notes: anchor activity\n"
                    "work:\n  flexibility: 0.25\n  extra_tag: 3\n"
                    "Shopping: quick errand\n")
        ov = os.path.join(d, "ov.csv")
        pd.DataFrame({"purpose": [" work", "Work ", "social"],
                      "notes": ["first", "last-wins", None],
                      "can_open_close_day": ["yes", "n", "maybe"],
                      "weight": [1, 2, 3]}).to_csv(ov, index=False)
        return acts, {"overrides": yml, "override_csv": ov}
    if name == "persons_columns_day":
        persons = os.path.join(d, "persons.csv")
        pd.DataFrame({"PID": list(df["persid"].unique()) + ["ghost1"]}
                     ).to_csv(persons, index=False)
        df = df.rename(columns={"persid": "PID", "purpose": "act",
                                "starttime": "start_min",
                                "total_duration": "dur"})
        df["Day"] = (np.arange(len(df)) % 3).astype(float)
        path = os.path.join(d, "renamed.csv")
        df.to_csv(path, index=False)
        return path, {"persons_csv": persons, "person_col": "PID",
                      "purpose_col": "act", "start_col": "start_min",
                      "dur_col": "dur", "day_col": "day",
                      "day_horizon_minutes": 1800.0}
    # tests/test_cli_and_viz.py's case: day 2's only row is unparseable
    path = os.path.join(d, "bad.csv")
    pd.DataFrame({"persid": ["p1", "p1", "p1"], "day": [1, 1, 2],
                  "purpose": ["Work", "Home", "Work"],
                  "startime": [540, 0, 540],
                  "total_duration": [480, 500, "bad"]}).to_csv(path,
                                                              index=False)
    persons = os.path.join(d, "p.csv")
    pd.DataFrame({"persid": ["p1", "p2"]}).to_csv(persons, index=False)
    return path, {"persons_csv": persons, "day_col": "day"}


@pytest.mark.parametrize("case", ["fixture", "overrides",
                                  "persons_columns_day", "unparseable_day"])
def test_catalog_csv_is_byte_equal_to_jax(acts, tmp_path, case):
    path, kw = _catalog_case(case, acts, str(tmp_path))
    jout, tout = str(tmp_path / "j.csv"), str(tmp_path / "t" / "p.csv")
    want = jcat(path, jout, **kw)
    got = tcat(path, tout, **kw)
    with open(jout, "rb") as a, open(tout, "rb") as b:
        assert b.read() == a.read()
    assert list(got) == list(want.columns)
    assert list(got)[:len(LEAD_COLUMNS)] == LEAD_COLUMNS
    for k in want.columns:
        w = want[k].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(got[k].astype(float), w,
                                          err_msg=k)
        else:
            assert [str(v) for v in got[k].tolist()] == \
                [str(v) for v in w.tolist()], k
    if case == "unparseable_day":
        row = list(got["purpose"]).index("Work")
        assert got["person_day_participation_rate"][row] == 0.5


def test_purpose_features_equal_jax(acts, tmp_path, grid):
    _, pm, _ = grid
    out = str(tmp_path / "p.csv")
    want = jtrain.purpose_features_from_catalog(jcat(acts, out), pm)
    got_built = ttrain.purpose_features_from_catalog(tcat(acts), pm)
    got_read = ttrain.purpose_features_from_catalog(read_catalog(out), pm)
    np.testing.assert_array_equal(got_built, want)
    np.testing.assert_array_equal(got_read, want)
    assert want.shape == (len(pm), 8) and np.abs(want).sum() > 0


# ---- the model and its weights ----------------------------------------------

def _feats(P, seed=1):
    return np.random.default_rng(seed).random((P, 8)).astype(np.float32)


def _pair(P, seed=0):
    jm = JTraj(L=L, P=P, z_dim=Z, emb_dim=CFG.emb_dim,
               cnn_channels=CFG.cnn_channels, cnn_kernel=CFG.cnn_kernel,
               cnn_dropout=0.0)
    key = jax.random.PRNGKey(seed)
    params = _np(jm.init({"params": key, "dropout": key},
                         jnp.zeros((2, L), jnp.int32), key,
                         jnp.asarray(_feats(P)))["params"])
    tm = ttrain.build_model(CFG, L, P, "cpu")
    tmodel.load_flax_params(tm, params)
    return jm, params, tm


def test_flax_bridge_is_bit_exact_both_ways(grid):
    _, pm, _ = grid
    _, params, tm = _pair(len(pm))
    back = tmodel.to_flax_params(tm)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # the port's own initialisation round-trips through the JAX model
    tm2 = ttrain.build_model(CFG, L, len(pm), "cpu")
    tmodel.init_params(tm2, torch.Generator().manual_seed(3))
    mine = tmodel.to_flax_params(tm2)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(params)
    tm3 = ttrain.build_model(CFG, L, len(pm), "cpu")
    tmodel.load_flax_params(tm3, mine)
    for a, b in zip(tm2.parameters(), tm3.parameters()):
        assert torch.equal(a, b)
    tb = mine["decoder"]["time_basis"]
    assert abs(tb.std() - np.sqrt(2.0 / (L + CFG.emb_dim))) < 0.05


def test_model_forward_decode_and_prior_match_jax(grid):
    Y, pm, _ = grid
    P = len(pm)
    jm, params, tm = _pair(P, seed=4)
    feats = _feats(P)
    y = Y[:6]
    rng = jax.random.PRNGKey(5)
    logits, mu, logvar = jm.apply({"params": params}, jnp.asarray(y), rng,
                                  jnp.asarray(feats), deterministic=True)
    eps = np.asarray(jax.random.normal(rng, (6, Z)))
    tm.eval()
    with torch.no_grad():
        tl, tmu, tlv = tm(_t(y, torch.long), _t(feats), eps=_t(eps))
        z = np.random.default_rng(6).standard_normal((5, Z)).astype(
            np.float32)
        td = tm.decode(_t(z), _t(feats))
        tp = tm.sample_from_prior(torch.Generator().manual_seed(0), 3,
                                  _t(feats))
    for a, b in ((tl, logits), (tmu, mu), (tlv, logvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    jd = jm.apply({"params": params}, jnp.asarray(z), jnp.asarray(feats),
                  method=JTraj.decode)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    zp = torch.randn((3, Z), generator=torch.Generator().manual_seed(0))
    jp = jm.apply({"params": params}, jnp.asarray(zp.numpy()),
                  jnp.asarray(feats), method=JTraj.decode)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)


# ---- the loss, one step, one epoch ------------------------------------------

MODES = {"linear": CRFConfig("linear", DMAX_MIN, CFG.grid_min),
         "semi": CRFConfig("semi", DMAX_MIN, CFG.grid_min, exact_long=True),
         "vae_only": None}
# as tests/test_torch_schedule_train.py: Adam's steps compared where the
# clipped reference gradient exceeds this, elsewhere held to Adam's bound
ADAM_WELL_CONDITIONED = 1e-5
TRAJ_LOSS = dict(rtol=2e-4, atol=1e-6)
TRAJ_PARAMS = dict(rtol=2e-3, atol=1e-5)


def _crf_init(P, crf_cfg, seed=8):
    if crf_cfg is None:
        return None
    rng = np.random.default_rng(seed)
    out = {"A": (0.1 * rng.standard_normal((P, P))).astype(np.float32)}
    if crf_cfg.crf_mode == "semi":
        out["dur"] = (0.1 * rng.standard_normal(
            (P, crf_cfg.Dmax_bins))).astype(np.float32)
    else:
        out["bias"] = (0.1 * rng.standard_normal(P)).astype(np.float32)
    return out


def _jloss(jm, feats, crf_cfg, lambda_crf):
    """The reference trainer's loss_fn (train_full.py), on its parts."""

    def loss_fn(all_params, batch, mask, rng, beta, deterministic):
        logits, mu, logvar = jm.apply(
            {"params": all_params["vae"]}, batch, rng, feats,
            deterministic=deterministic,
            rngs={"dropout": jax.random.fold_in(rng, 1)})
        ce = j_ce(logits, batch, mask)
        kl = j_kl(mu, logvar, mask)
        loss = ce + beta * kl
        comps = {"ce": ce, "kl": kl}
        if "crf" in all_params:
            cp = all_params["crf"]
            if crf_cfg.crf_mode == "semi":
                nll = j_semicrf_nll(logits, batch, cp["dur"], cp["A"],
                                    mask_b=mask,
                                    exact_long=crf_cfg.exact_long)
            else:
                nll = j_crf_nll(logits + cp["bias"][None, None, :], batch,
                                cp["A"], mask_b=mask)
            loss = loss + lambda_crf * nll
            comps["crf_nll"] = nll
        else:
            comps["crf_nll"] = jnp.zeros(())
        comps["loss"] = loss
        return loss, comps

    return loss_fn


def _port(tm, crf_np, crf_cfg, feats, lr, wd, clip):
    crf = None if crf_np is None else {
        k: _t(v).requires_grad_(True) for k, v in crf_np.items()}
    opt = ClippedAdamW(list(tm.parameters()) + (
        [] if crf is None else list(crf.values())), lr, wd, clip)
    loss_fn = ttrain.make_loss_fn(tm, crf, crf_cfg or MODES["linear"],
                                  CFG.lambda_crf, _t(feats))
    return crf, opt, loss_fn


def _tree(tm, crf, grads=False):
    """The port's parameters (or their gradients) as the reference's
    {"vae", "crf"} tree."""
    if grads:
        g = copy.deepcopy(tm)
        with torch.no_grad():
            for p, q in zip(g.parameters(), tm.parameters()):
                p.copy_(q.grad)
        tm = g
    out = {"vae": tmodel.to_flax_params(tm)}
    if crf is not None:
        out["crf"] = {k: (v.grad if grads else v).detach().numpy()
                      for k, v in crf.items()}
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_loss_and_clipped_adamw_step_match_jax(grid, mode, clip):
    """The components and every gradient of one masked step against
    jax.grad of the reference's loss, then one optax-clipped AdamW step
    (the clip active at 0.05, idle at 100)."""
    Y, pm, _ = grid
    P, crf_cfg = len(pm), MODES[mode]
    jm, params, tm = _pair(P, seed=9)
    feats = _feats(P)
    crf_np = _crf_init(P, crf_cfg)
    allp = {"vae": params, **({} if crf_np is None else {"crf": crf_np})}
    y = Y[:8]
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    rng = jax.random.PRNGKey(12)
    lr, wd = 1e-2, 1e-3
    jloss = _jloss(jm, jnp.asarray(feats), crf_cfg, CFG.lambda_crf)
    jgrads, comps = jax.jit(jax.grad(jloss, has_aux=True),
                            static_argnums=(5,))(
        allp, jnp.asarray(y), jnp.asarray(mask), rng, 0.5, False)
    jgrads = _np(jgrads)
    norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jax.tree_util.tree_leaves(jgrads))))
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(lr, weight_decay=wd))
    updates, _ = opt.update(jgrads, opt.init(allp), allp)
    after = _np(optax.apply_updates(allp, updates))

    crf, topt, loss_fn = _port(tm, crf_np, crf_cfg, feats, lr, wd, clip)
    tm.train()
    eps = _t(jax.random.normal(rng, (8, Z)))
    loss, tcomps = loss_fn(_t(y, torch.long), _t(mask), 0.5, eps=eps)
    loss.backward()
    for k in ttrain.COMPONENTS:
        want = float(comps[k])
        assert abs(float(tcomps[k].detach()) - want) <= 1e-5 * max(abs(want), 1e-6), k
    tgrads = _tree(tm, crf, grads=True)
    for (path, g), tg in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree_util.tree_leaves(tgrads)):
        np.testing.assert_allclose(tg, g, rtol=1e-4, atol=1e-6 * norm,
                                   err_msg=jax.tree_util.keystr(path))
    topt.step()
    scale = min(1.0, clip / norm)
    for (path, g), p0, a, b in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree_util.tree_leaves(allp),
            jax.tree_util.tree_leaves(after),
            jax.tree_util.tree_leaves(_tree(tm, crf))):
        name = jax.tree_util.keystr(path)
        sound = np.abs(g) * scale > ADAM_WELL_CONDITIONED
        if sound.any():
            assert np.max(np.abs(b - a)[sound]) <= \
                1e-5 * np.max(np.abs(a)), name
        bound = lr * (1 + wd * np.abs(p0)) * (1 + 1e-5)
        assert np.all(np.abs(b - p0)[~sound] <= bound[~sound]), name


@pytest.mark.parametrize("mode", ["linear", "semi"])
def test_epoch_matches_the_reference_epoch(grid, mode):
    """The reference's epoch (train_full.py's scan body: the permutation,
    the wrapped and masked tail batch, a key per batch) with JAX's
    permutation and noise injected into the port's ``train_epoch``: the
    logged components (unweighted means over the batches), the CRF's
    parameters and the model's outputs after three steps within the
    reference's own bound between two float32 trajectories (the outputs,
    not the weights: a weight whose gradient is rounding noise takes an
    Adam step set by that noise in either package). FiLM's shift bias is
    such a weight: it moves every purpose's logit at a time by the same
    amount, which neither the cross-entropy nor either CRF sees, so its
    gradient is 0 up to rounding; the logits are compared as the
    log-softmax over purposes that both losses read. Then the validation
    loss."""
    Y, pm, _ = grid
    P, crf_cfg = len(pm), MODES[mode]
    jm, params, tm = _pair(P, seed=13)
    feats = _feats(P)
    crf_np = _crf_init(P, crf_cfg, seed=14)
    allp = {"vae": params, "crf": crf_np}
    Yt, Yv = Y[:20], Y[20:32]
    bsz, n = 8, 20
    nb = -(-n // bsz)
    opt = optax.chain(optax.clip_by_global_norm(CFG.grad_clip),
                      optax.adamw(CFG.lr, weight_decay=CFG.weight_decay))
    jloss = _jloss(jm, jnp.asarray(feats), crf_cfg, CFG.lambda_crf)

    @jax.jit
    def step(allp, opt_state, batch, mask, rng):
        grads, comps = jax.grad(jloss, has_aux=True)(
            allp, batch, mask, rng, 0.7, False)
        updates, opt_state = opt.update(grads, opt_state, allp)
        return optax.apply_updates(allp, updates), opt_state, comps

    key = jax.random.PRNGKey(16)
    perm = jax.random.permutation(jax.random.fold_in(key, 0), n)
    pad = nb * bsz - n
    idx = np.concatenate([perm, perm[:pad]])
    mask_full = np.concatenate([np.ones(n), np.zeros(pad)]).astype(
        np.float32)
    state, rows = opt.init(allp), []
    p_j = allp
    for i in range(nb):
        sl = slice(i * bsz, (i + 1) * bsz)
        p_j, state, comps = step(p_j, state, jnp.asarray(Yt[idx[sl]]),
                                 jnp.asarray(mask_full[sl]),
                                 jax.random.fold_in(key, i + 1))
        rows.append([float(comps[k]) for k in ttrain.COMPONENTS])
    want = np.mean(np.array(rows), axis=0)
    jval_loss = float(jax.jit(jloss, static_argnums=(5,))(
        p_j, jnp.asarray(Yv), jnp.ones(len(Yv)), key, 0.7, True)[0])

    crf, topt, loss_fn = _port(tm, crf_np, crf_cfg, feats, CFG.lr,
                               CFG.weight_decay, CFG.grad_clip)
    train_epoch, val_loss = ttrain.make_epoch_fns(tm, topt, loss_fn, bsz)
    eps = [_t(jax.random.normal(jax.random.fold_in(key, i + 1), (bsz, Z)))
           for i in range(nb)]
    got = train_epoch(_t(Yt, torch.long), None, 0.7, nb,
                      perm=_t(perm, torch.long), eps=eps)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ_LOSS)
    for k, v in crf.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(
            p_j["crf"][k]), err_msg=k, **TRAJ_PARAMS)
    y = Yv[:6]
    z = np.random.default_rng(22).standard_normal((6, Z)).astype(np.float32)
    mu, logvar = jm.apply({"params": p_j["vae"]}, jnp.asarray(y),
                          method=JTraj.encode)
    logits = jax.nn.log_softmax(jm.apply(
        {"params": p_j["vae"]}, jnp.asarray(z), jnp.asarray(feats),
        method=JTraj.decode), axis=-1)
    tm.eval()
    with torch.no_grad():
        tmu, tlogvar = tm.encode(_t(y, torch.long))
        tlogits = torch.log_softmax(tm.decode(_t(z), _t(feats)), dim=-1)
    for name, a, b in (("mu", mu, tmu), ("logvar", logvar, tlogvar),
                       ("logits", logits, tlogits)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TRAJ_PARAMS)
    # the validation pass on JAX's weights after the epoch, JAX's noise
    tmodel.load_flax_params(tm, _np(p_j)["vae"])
    with torch.no_grad():
        for k, v in crf.items():
            v.copy_(_t(p_j["crf"][k]))
    vl = val_loss(_t(Yv, torch.long), None, 0.7,
                  eps=_t(jax.random.normal(key, (len(Yv), Z))))
    assert abs(float(vl) - jval_loss) <= 1e-5 * abs(jval_loss)


# ---- checkpoints, generation and the segment CSV ------------------------------

DECODES = [("none", False, False), ("linear", False, False),
           ("linear", True, False), ("semi", False, True),
           ("semi", False, False)]


def _jax_ckpt(path, grid, crf_mode, exact_long, seed=21):
    """A checkpoint with the keys and layout the JAX trainer writes, from
    the JAX model's initialisation and seeded CRF parameters."""
    _, pm, _ = grid
    P = len(pm)
    _, params, _ = _pair(P, seed=seed)
    crf_cfg = CRFConfig(crf_mode, DMAX_MIN, CFG.grid_min,
                        exact_long=exact_long)
    crf = _crf_init(P, crf_cfg, seed=seed)
    if crf_mode == "linear":
        # home-heavy: the no-all-home decode must bind somewhere
        crf["bias"][pm["Home"]] += 3.0
    j_save({"params": params, "crf_params": crf,
            "cfg": dataclasses.asdict(CFG),
            "crf_cfg": dataclasses.asdict(crf_cfg),
            "meta": {"purpose_map": pm, "grid_min": CFG.grid_min,
                     "horizon_min": CFG.horizon_min, "L": L, "N": 48},
            "purpose_feats": _feats(P), "epoch": 1}, path)
    return path


def _jax_z(seed, n_chunks=1):
    key = jax.random.PRNGKey(seed)
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (tval.CHUNK, Z)))
        for i in range(n_chunks)])


@pytest.mark.parametrize("mode,nonhome,exact_long", DECODES)
def test_jax_checkpoint_generates_the_same_labels_in_the_port(
        tmp_path, grid, mode, nonhome, exact_long):
    ck = _jax_ckpt(str(tmp_path / "ckpt_best.ckpt"), grid,
                   "linear" if mode == "none" else mode, exact_long)
    want, meta = jval.generate_trajectories(ck, 600, seed=2, crf_mode=mode,
                                            enforce_nonhome=nonhome)
    got, tmeta = tval.generate_trajectories(ck, 600, seed=2, crf_mode=mode,
                                            enforce_nonhome=nonhome,
                                            device="cpu", z=_jax_z(2, 2))
    assert tmeta == meta and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_port_checkpoint_loads_in_jax_and_generates_the_same_labels(
        tmp_path, acts):
    res = ttrain.train_traj_embed(acts, None, epochs=2, batch_size=16,
                                  outdir=str(tmp_path / "run"),
                                  crf_mode="semi", config=CFG,
                                  semi_Dmax_minutes=DMAX_MIN, device="cpu")
    ck = res["ckpt"]
    log = pd.read_csv(tmp_path / "run" / "training_log.csv")
    assert list(log.columns) == ["epoch", "val_loss", "ce", "crf_nll", "kl",
                                 "loss"]
    assert len(log) == 2 and np.isfinite(log.to_numpy()).all()
    assert os.path.exists(tmp_path / "run" / "meta.json")
    for mode in ("semi", "none"):
        want, meta = jval.generate_trajectories(ck, 40, seed=5,
                                                crf_mode=mode)
        got, tmeta = tval.generate_trajectories(ck, 40, seed=5,
                                                crf_mode=mode, device="cpu",
                                                z=_jax_z(5))
        assert tmeta == meta
        np.testing.assert_array_equal(got, want)


def test_vae_only_training_and_the_vae_synthesis(tmp_path, acts):
    res = ttrain.train_vae_only(acts, None, epochs=1, batch_size=16,
                                outdir=str(tmp_path / "v"), config=CFG,
                                device="cpu")
    ck = tval.load_checkpoint(res["ckpt"])
    assert ck["crf_params"] is None and ck["epoch"] == 1
    out = synthesize_vae(res["ckpt"], 30, str(tmp_path / "s" / "s.npz"),
                         seed=1, device="cpu")
    with np.load(out) as d:
        Y = d["Y_generated"]
    assert Y.shape == (30, L) and Y.dtype == np.int64
    report = analyze_vae(out, str(tmp_path / "s" / "a.json"))
    assert report["N"] == 30 and report["L"] == L
    assert abs(sum(report["minutes_share"].values()) - 1.0) < 1e-9


def test_segments_csv_and_summary_equal_jax(tmp_path, acts, grid):
    Y, pm, _ = grid
    inv = {v: k for k, v in pm.items()}
    for name, rows in (("grid", Y), ("empty_names", Y % 3)):
        jout, tout = tmp_path / f"j_{name}.csv", tmp_path / "t" / f"{name}.csv"
        jseg = jval.write_segments_csv(rows, str(jout), CFG.grid_min, inv)
        tseg = tval.write_segments_csv(rows, str(tout), CFG.grid_min, inv)
        assert tout.read_bytes() == jout.read_bytes()
        for a, b in zip(tseg, jseg):
            np.testing.assert_array_equal(a, b)
    ck = _jax_ckpt(str(tmp_path / "c.ckpt"), grid, "semi", True)
    kw = dict(val_csv=acts, eval_step_minutes=120, summary_json=None)
    want = jval.gen_n_val_traj(ck, 512, str(tmp_path / "jg.csv"), **kw)
    got = tval.gen_n_val_traj(ck, 512, str(tmp_path / "tg.csv"), **kw,
                              device="cpu")
    assert set(got) == set(want)
    assert set(got["validation"]) == set(want["validation"])
    for k in ("P", "L", "home_idx"):
        assert got["validation"][k] == want["validation"][k]
    assert set(got["generated_stats"]) == set(want["generated_stats"])


def test_figures_equal_jax(tmp_path, grid):
    """The three figures of the port and of the JAX package from the same
    grid: the same files, byte for byte (the same plotting calls on the
    Agg backend)."""
    pytest.importorskip("matplotlib")
    from ananke_abm_tpu.utils.traj_fig import figures as jfig
    from ananke_abm_tpu_torch.utils.traj_fig import figures as tfig

    Y, pm, _ = grid
    for mod, name in ((jfig, "j"), (tfig, "t")):
        out = tmp_path / name
        out.mkdir()
        mod.fig_stacked_traj(Y, pm, str(out / "stacked_traj.png"),
                             CFG.grid_min)
        mod.fig_specific_trajs(Y, pm, str(out), CFG.grid_min)
        mod.fig_primary_lunch_time(Y, pm, str(out), CFG.grid_min)
    want = {p.name: p.read_bytes() for p in (tmp_path / "j").iterdir()}
    got = {p.name: p.read_bytes() for p in (tmp_path / "t").iterdir()}
    assert sorted(got) == sorted(want) and "stacked_traj.png" in got
    for name, data in got.items():
        assert data == want[name], name
