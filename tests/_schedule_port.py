"""Shared set-up for the schedule-VAE parity tests: the same flax
variables in the JAX package's ``ScheduleVAE`` and in the port's."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.models.gen_schedule.vae import ScheduleVAE as JVAE
from ananke_abm_tpu_torch.models.gen_schedule.params import load_flax_params
from ananke_abm_tpu_torch.models.gen_schedule.vae import ScheduleVAE as TVAE
from ananke_abm_tpu_torch.ops import native as tnative

L, P, Z, E, HOME = 24, 7, 4, 16, 2

KINDS = {
    # an even kernel ("SAME" pads 1 before, 2 after), residuals without a
    # projection, two channels a group
    "cnn": dict(encoder_kind="cnn", cnn_channels=(16, 16), cnn_kernel=4),
    "batch": dict(encoder_kind="cnn", cnn_channels=(8,), cnn_kernel=3,
                  cnn_norm="batch"),
    "gru": dict(encoder_kind="rnn", rnn_hidden_dim=8, use_emb_layernorm=True),
    "lstm": dict(encoder_kind="rnn", rnn_hidden_dim=8, rnn_cell="lstm"),
    "pds": dict(encoder_kind="cnn", cnn_channels=(8,), use_pds=True),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _pds_features(seed=5):
    rng = np.random.default_rng(seed)
    return rng.random((P, L, 2)).astype(np.float32)


def _labels(seed, n=6):
    return np.random.default_rng(seed).integers(0, P, size=(n, L))


_INITS = {}


def _init(jm, key, pds):
    """flax's variables of ``jm`` at ``key`` (kept: a model's first init
    compiles its every primitive)."""
    k = (repr(jm), tuple(np.asarray(key).tolist()))
    if k not in _INITS:
        _INITS[k] = _np(jm.init({"params": key, "dropout": key},
                                jnp.zeros((2, jm.L), jnp.int32), key,
                                pds_features=pds, deterministic=True))
    return copy.deepcopy(_INITS[k])


def _pair(kind, seed=0, stats_seed=None):
    """JAX model + its flax variables and the port's model loaded from
    them. ``stats_seed`` randomises batch norm's running statistics."""
    kw = dict(KINDS[kind], **({"cnn_dropout": 0.0}
                              if KINDS[kind]["encoder_kind"] == "cnn"
                              else {}))
    jm = JVAE(L=L, P=P, z_dim=Z, emb_dim=E, **kw)
    key = jax.random.PRNGKey(seed)
    pds = jnp.asarray(_pds_features()) if kw.get("use_pds") else None
    var = _init(jm, key, pds)
    var = {"params": var["params"], "batch_stats": var.get("batch_stats", {})}
    if stats_seed is not None and var["batch_stats"]:
        rng = np.random.default_rng(stats_seed)
        var["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
            var["batch_stats"])
    tm = TVAE(L, P, Z, E, **kw)
    load_flax_params(tm, var["params"], var["batch_stats"])
    return jm, var, tm, pds


def _jvars(var):
    return {k: v for k, v in var.items() if v}


def numpy_branch(monkeypatch):
    """Force the port's host counters and rasterizer onto their numpy
    branches: ``ops/native.available()`` False for the test."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.available()


@pytest.fixture(params=["native", "numpy"])
def host_branch(request, monkeypatch):
    """The port's host counters and rasterizer through its native library,
    or through their numpy branches."""
    if request.param == "numpy":
        numpy_branch(monkeypatch)
    assert tnative.available() == (request.param == "native")
    return request.param
