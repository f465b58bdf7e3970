"""The port's schedule VAE (``ananke_abm_tpu_torch/models/gen_schedule``,
``losses``) against the JAX package on the same seeded inputs, on the CPU:
losses, encoders, decoders, the carried weights and the initialisation,
the loss and one optimizer step, an epoch. The pipeline across packages
and the host copies: ``tests/test_torch_schedule_pipeline.py``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu import losses as jlosses
from ananke_abm_tpu.models.gen_schedule.vae import ScheduleVAE as JVAE
from ananke_abm_tpu_torch import losses as tlosses
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    load_flax_params,
    to_flax_batch_stats,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gen_schedule.vae import ScheduleVAE as TVAE
from ananke_abm_tpu_torch.models.gen_schedule.vae import init_params
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW

from _schedule_port import (  # noqa: E402
    E,
    HOME,
    KINDS,
    L,
    P,
    Z,
    _init,
    _jvars,
    _labels,
    _np,
    _pair,
    _rel,
    _t,
)


# ---- losses ------------------------------------------------------------

LOSSES = ("kl", "ce", "tv", "home", "tod", "presence", "share")


def _loss_call(mod, name, logits, y, mask, mu, logvar, m_tod, pres, share):
    if name == "kl":
        return mod.kl_gaussian(mu, logvar, mask)
    if name == "ce":
        return mod.cross_entropy_masked(logits, y, mask)
    if name == "tv":
        return mod.time_total_variation(logits, mask)
    if name == "home":
        return mod.start_end_home_loss(logits, HOME, mask)
    if name == "tod":
        return mod.time_of_day_marginal_loss(logits, m_tod, mask)
    if name == "presence":
        return mod.presence_rate_loss(logits, pres, mask)
    return mod.minutes_share_loss(logits, share, mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name, masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((5, L, P)) * 3).astype(np.float32)
    logits[0, :, 1] = 40.0  # a saturated softmax: the presence clip
    y = rng.integers(0, P, size=(5, L))
    mu = rng.standard_normal((5, Z)).astype(np.float32)
    logvar = rng.standard_normal((5, Z)).astype(np.float32)
    m_tod = rng.random((P, L)).astype(np.float32)
    pres = rng.random(P).astype(np.float32)
    share = rng.random(P).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32) if masked else None
    args = (logits, y, mask, mu, logvar, m_tod, pres, share)
    want = _loss_call(jlosses, name, *[None if a is None else jnp.asarray(a)
                                       for a in args])
    got = _loss_call(tlosses, name, *[None if a is None else _t(a)
                                      for a in args])
    assert _rel(got, want) <= 1e-6, (float(got), float(want))


def test_masked_losses_ignore_padded_rows():
    rng = np.random.default_rng(2)
    logits = _t(rng.standard_normal((4, L, P)), torch.float32)
    y = _t(rng.integers(0, P, size=(4, L)))
    mask = _t([1.0, 1.0, 0.0, 0.0])
    got = tlosses.cross_entropy_masked(logits, y, mask)
    want = tlosses.cross_entropy_masked(logits[:2], y[:2])
    assert _rel(got, want) <= 1e-6


def test_jsd_equals_jax():
    rng = np.random.default_rng(3)
    p, q = rng.random(7), rng.random(7)
    q[2] = 0.0
    assert tlosses.jsd(p, q) == jlosses.jsd(p, q)


# ---- the model ---------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("train", [False, True])
def test_encoders_match_jax(kind, train):
    jm, var, tm, _ = _pair(kind, seed=1, stats_seed=2)
    y = _labels(3)
    batch = kind == "batch"
    out = jax.jit(lambda v, y: jm.apply(
        v, y, deterministic=not train, method=JVAE.encode,
        mutable=["batch_stats"] if batch else False))(_jvars(var),
                                                       jnp.asarray(y))
    (mu, logvar), mutated = out if batch else (out, None)
    tm.train(train)
    tmu, tlogvar = tm.encode(_t(y))
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(mu),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlogvar.detach().numpy(), np.asarray(logvar),
                               rtol=1e-5, atol=1e-5)
    if batch:
        # the running statistics after the pass (unchanged in eval mode)
        got = to_flax_batch_stats(tm)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(_np(mutated["batch_stats"]))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["cnn", "pds"])
def test_decoders_match_jax(kind):
    jm, var, tm, pds = _pair(kind, seed=4)
    z = np.random.default_rng(5).standard_normal((6, Z)).astype(np.float32)
    want = jm.apply({"params": var["params"]}, jnp.asarray(z), pds,
                    method=lambda m, z, p: m.decode(z, p))
    got = tm.decode(_t(z), None if pds is None else _t(pds))
    assert got.shape == (6, L, P)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_carried_weights_round_trip_bit_exact(kind):
    _, var, tm, _ = _pair(kind, seed=6, stats_seed=7)
    back = to_flax_params(tm)
    jl, jt = jax.tree_util.tree_flatten(var["params"])
    tl, tt = jax.tree_util.tree_flatten(back)
    assert jt == tt
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stats = to_flax_batch_stats(tm)
    assert jax.tree_util.tree_structure(stats) == \
        jax.tree_util.tree_structure(var["batch_stats"])
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(var["batch_stats"])):
        assert np.array_equal(a, b)
    # and back: torch -> flax -> torch
    other = TVAE(L, P, Z, E, **KINDS[kind])
    load_flax_params(other, back, stats)
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n


def test_load_refuses_a_tree_of_another_model():
    _, var, tm, _ = _pair("cnn")
    params = copy.deepcopy(var["params"])
    params["encoder"]["Dense_9"] = {"bias": np.zeros(Z, np.float32)}
    with pytest.raises(KeyError, match="Dense_9"):
        load_flax_params(tm, params)
    _, var_b, tm_b, _ = _pair("batch")
    with pytest.raises(KeyError, match="batch_stats"):
        load_flax_params(tm_b, var_b["params"])


@pytest.mark.parametrize("kind", ["cnn", "gru", "pds"])
def test_init_follows_flax_initialisers_in_distribution(kind):
    """At wider widths each leaf's spread matches flax's initialiser: the
    same zeros and ones, stddev within 10% (leaves of >= 500 entries)."""
    kw = dict(KINDS[kind])
    wide = dict(L=96, P=P, z_dim=16, emb_dim=64)
    if kw["encoder_kind"] == "cnn":
        kw["cnn_channels"] = (32,)
    else:
        kw["rnn_hidden_dim"] = 32
    jm = JVAE(**wide, **kw)
    key = jax.random.PRNGKey(0)
    pds = jnp.ones((P, 96, 2)) if kw.get("use_pds") else None
    jp = _init(jm, key, pds)
    tm = TVAE(*wide.values(), **kw)
    init_params(tm, torch.Generator().manual_seed(0))
    tp = to_flax_params(tm)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(jp["params"])[0],
            jax.tree_util.tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        if np.all(a == 0) or np.all(a == 1):
            assert np.array_equal(a, b), name
        elif a.size >= 500:
            assert 0.9 <= b.std() / a.std() <= 1.1, (name, a.std(), b.std())
            assert abs(b.mean()) <= 4 * a.std() / np.sqrt(a.size), name


def test_rnn_zero_bias_parts_stay_zero_through_training():
    for kind in ("gru", "lstm"):
        _, _, tm, _ = _pair(kind)
        opt = ClippedAdamW(tm.parameters(), 1e-2, 1e-2, 1.0)
        for _ in range(2):
            opt.zero_grad()
            logits, mu, _ = tm(_t(_labels(4)),
                               eps=torch.zeros(6, Z))
            (logits.square().mean() + mu.sum()).backward()
            opt.step()
        for name, mask in tm.encoder.zero_bias_masks().items():
            bias = getattr(tm.encoder.rnn, name).detach()
            assert torch.all(bias[mask == 0] == 0), (kind, name)
