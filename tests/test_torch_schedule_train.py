"""The port's schedule-VAE loss, optimizer step and epoch
(``ananke_abm_tpu_torch/models/gen_schedule/pipeline/train.py``) against
the JAX package's ``make_loss_fn`` and ``make_epoch_fns`` on the same
seeded inputs, on the CPU."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _schedule_port import (  # noqa: E402
    HOME,
    JVAE,
    L,
    P,
    Z,
    _jvars,
    _labels,
    _np,
    _pair,
    _pds_features,
    _rel,
    _t,
)
from ananke_abm_tpu.models.gen_schedule.pipeline import train as jtrain
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    load_flax_params,
    to_flax_batch_stats,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gen_schedule.pipeline import train as ttrain
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW


# ---- loss function, step, epoch ------------------------------------------

LAMBDAS = {"tv": 0.02, "home": 0.2, "tod": 0.3, "presence": 0.3,
           "share": 0.3}


def _pds_arrays(kind, jax_side):
    if kind != "pds":
        return None
    rng = np.random.default_rng(8)
    m_tod = rng.random((P, L)).astype(np.float32)
    arrs = {"pds_features": _pds_features(), "m_tod": m_tod,
            "presence": rng.random(P).astype(np.float32),
            "share_emp": m_tod.mean(axis=1)}
    conv = jnp.asarray if jax_side else _t
    return {k: conv(v) for k, v in arrs.items()}


def _grads_as_flax(tm):
    g = copy.deepcopy(tm)
    with torch.no_grad():
        for p, q in zip(g.parameters(), tm.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return to_flax_params(g)


# Adam divides each gradient coordinate by its own magnitude plus 1e-8, so
# a coordinate whose gradient is rounding noise (a conv bias that the norm
# after it cancels, a saturated gate) takes a step set by that noise in
# either package. The steps are compared where the clipped reference
# gradient exceeds ADAM_WELL_CONDITIONED (there the map g -> g / (|g| +
# 1e-8) moves a relative error by at most 1e-3 of itself); elsewhere each
# coordinate's step is held to Adam's own bound, lr (1 + weight_decay |p|).
ADAM_WELL_CONDITIONED = 1e-5


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jax.tree_util.tree_leaves(tree))))


@pytest.mark.parametrize("kind", ["cnn", "batch", "gru", "lstm", "pds"])
@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_loss_components_and_clipped_adamw_step_match_jax(kind, clip):
    """The loss components and every gradient of one masked step against
    jax.grad of the reference's loss, then one optax-clipped AdamW step
    (the clip active at 0.05, idle at 100)."""
    jm, var, tm, _ = _pair(kind, seed=9, stats_seed=10)
    y = _labels(11, n=8)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    rng = jax.random.PRNGKey(12)
    eps = np.asarray(jax.random.normal(rng, (8, Z)))
    jloss = jtrain.make_loss_fn(jm, HOME, LAMBDAS, _pds_arrays(kind, True))
    tloss = ttrain.make_loss_fn(tm, HOME, LAMBDAS, _pds_arrays(kind, False))
    lr, wd = 1e-2, 1e-3
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(lr, weight_decay=wd))
    params, stats = var["params"], var["batch_stats"]
    grad_fn = jax.jit(jax.grad(jloss, has_aux=True), static_argnums=(6,))
    jgrads, (comps, stats) = grad_fn(
        params, stats, jnp.asarray(y), jnp.asarray(mask), rng, 0.5, False)
    jgrads = _np(jgrads)
    norm = _global_norm(jgrads)

    @jax.jit
    def step(grads, params):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    params_after = _np(step(jgrads, params))

    topt = ClippedAdamW(tm.parameters(), lr, wd, clip)
    tm.train()
    loss, tcomps = tloss(_t(y), _t(mask), 0.5, eps=_t(eps))
    loss.backward()
    for k in ttrain.COMPONENTS:
        if abs(float(comps[k])) > 0:
            assert _rel(tcomps[k].detach(), comps[k]) <= 1e-5, k
    for (path, g), tg in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree_util.tree_leaves(_grads_as_flax(tm))):
        np.testing.assert_allclose(tg, g, rtol=1e-4, atol=1e-6 * norm,
                                   err_msg=jax.tree_util.keystr(path))
    topt.step()
    scale = min(1.0, clip / norm)
    for (path, g), p0, a, b in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(params_after),
            jax.tree_util.tree_leaves(to_flax_params(tm))):
        name = jax.tree_util.keystr(path)
        sound = np.abs(g) * scale > ADAM_WELL_CONDITIONED
        if sound.any():
            assert np.max(np.abs(b - a)[sound]) <= 1e-5 * np.max(np.abs(a)),\
                name
        step_bound = lr * (1 + wd * np.abs(p0)) * (1 + 1e-5)
        assert np.all(np.abs(b - p0)[~sound] <= step_bound[~sound]), name
    for a, b in zip(jax.tree_util.tree_leaves(_np(stats)),
                    jax.tree_util.tree_leaves(to_flax_batch_stats(tm))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def _outputs(jm, tm, var_j, pds):
    """(mu, logvar, decoded logits) of both models on fixed labels and
    latents, the encoders in training mode (dropout 0): batch statistics
    then cancel the convolution biases that a norm follows, whose steps
    are set by rounding noise (ADAM_WELL_CONDITIONED)."""
    y = _labels(21, n=8)
    z = np.random.default_rng(22).standard_normal((8, Z)).astype(np.float32)
    out = jm.apply(_jvars(var_j), jnp.asarray(y), deterministic=False,
                   method=JVAE.encode,
                   mutable=["batch_stats"] if var_j["batch_stats"] else False)
    mu, logvar = out[0] if var_j["batch_stats"] else out
    logits = jm.apply({"params": var_j["params"]}, jnp.asarray(z), pds,
                      method=lambda m, z, p: m.decode(z, p))
    tm = copy.deepcopy(tm).train()
    with torch.no_grad():
        tmu, tlogvar = tm.encode(_t(y))
        tlogits = tm.decode(_t(z), None if pds is None else _t(pds))
    return ([np.asarray(a) for a in (mu, logvar, logits)],
            [a.numpy() for a in (tmu, tlogvar, tlogits)])


# the reference's own bound between two of its float32 trajectories over
# the same epochs, at its learning rate 1e-3 and weight decay 1e-4
# (tests/test_gen_schedule.py::TestEpochFusion): losses rtol 2e-4 (atol
# 1e-6), parameters rtol 2e-3 (atol 1e-5)
TRAJ_LOSS = dict(rtol=2e-4, atol=1e-6)
TRAJ_PARAMS = dict(rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("kind,batch_size", [("batch", 64), ("cnn", 64),
                                             ("pds", 64), ("cnn", 16)])
def test_epoch_matches_jax_train_and_eval_epochs(kind, batch_size):
    """JAX's permutation and noise injected, dropout off. batch 64 over 40
    rows is one full batch padded with wrapped rows: its components and
    running statistics equal JAX's (rel 1e-5); batches of 16 take three
    steps, held to the reference's own bound between two float32
    trajectories, as are the models' outputs after the epoch. The eval
    epoch runs on JAX's weights after the epoch and equals JAX's."""
    jm, var, tm, pds = _pair(kind, seed=13)
    Y = _labels(14, n=40)
    Yv = _labels(15, n=20)
    opt = optax.chain(optax.clip_by_global_norm(5.0),
                      optax.adamw(1e-3, weight_decay=1e-4))
    jtr, jev = jtrain.make_epoch_fns(jm, opt, HOME, LAMBDAS,
                                     _pds_arrays(kind, True), batch_size)
    key = jax.random.PRNGKey(16)
    nb, nvb = -(-40 // batch_size), -(-20 // batch_size)
    p2, _, s2, tr_m = jtr(var["params"], opt.init(var["params"]),
                          var["batch_stats"], jnp.asarray(Y), key, 0.7, nb)
    va_m = jev(p2, s2, jnp.asarray(Yv), key, 0.7, nvb)
    after = {"params": _np(p2), "batch_stats": _np(s2)}
    perm = _t(jax.random.permutation(jax.random.fold_in(key, 0), 40),
              torch.long)
    eps = [_t(jax.random.normal(jax.random.fold_in(key, i + 1),
                                (batch_size, Z))) for i in range(nb)]

    topt = ClippedAdamW(tm.parameters(), 1e-3, 1e-4, 5.0)
    tloss = ttrain.make_loss_fn(tm, HOME, LAMBDAS, _pds_arrays(kind, False))
    ttr, _ = ttrain.make_epoch_fns(tm, topt, tloss, batch_size)
    got_tr = ttr(_t(Y), None, 0.7, nb, perm=perm, eps=eps)
    one = nb == 1
    for i, k in enumerate(ttrain.COMPONENTS):
        if one and abs(float(tr_m[k])) > 0:
            assert _rel(got_tr[i], tr_m[k]) <= 1e-5, k
        else:
            np.testing.assert_allclose(float(got_tr[i]), float(tr_m[k]),
                                       err_msg=k, **TRAJ_LOSS)
    for a, b in zip(jax.tree_util.tree_leaves(after["batch_stats"]),
                    jax.tree_util.tree_leaves(to_flax_batch_stats(tm))):
        np.testing.assert_allclose(b, a, **(dict(rtol=1e-5, atol=1e-6)
                                            if one else TRAJ_PARAMS))
    want, got = _outputs(jm, tm, after, pds)
    for name, a, b in zip(("mu", "logvar", "logits"), want, got):
        np.testing.assert_allclose(b, a, err_msg=name, **TRAJ_PARAMS)

    # the eval epoch on JAX's weights after the epoch
    load_flax_params(tm, after["params"], after["batch_stats"])
    _, tev = ttrain.make_epoch_fns(tm, topt, tloss, batch_size)
    got_va = tev(_t(Yv), None, 0.7, nvb, eps=eps)
    for i, k in enumerate(ttrain.COMPONENTS):
        if abs(float(va_m[k])) > 0:
            assert _rel(got_va[i], va_m[k]) <= 1e-5, k
