"""The port's epoch function and ``train()`` on the CPU: against the JAX
package's ``make_epoch_fn`` and a per-step loop, resume and its refusals,
and the trained checkpoint served by both packages.

Bounds are those of the JAX package's own tests of the same functions
(tests/test_gnn_embed.py ``TestTrain``), but one:

- accumulated epochs, port against JAX: the losses within rtol 1e-5 and
  the parameters within rtol 1e-4, with SGD, whose update is linear in the
  gradient, so float32 noise between the two packages stays noise (AdamW's
  first step turns near-zero gradients of either sign into full +-lr
  moves). The parameters' atol is 1e-5 where the JAX test (two runs of one
  package) has 1e-6: across the packages the float32 gradients differ by
  up to 1.8e-5 absolute (2.5e-6 of the largest; the drift's Dense_0
  kernel), which two SGD steps at lr 0.05 carry into the parameters as
  ~2.6e-6. A wrong accumulation (two updates, or the sum) moves them by
  ~lr x gradient, 1e-2 and more;
- the epoch against the per-step loop: the losses within rtol 1e-6, the
  parameters within rtol 1e-5, atol 1e-6;
- a resumed history within rtol 1e-5 of the straight run's.
"""
import copy
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import agreement, make_pair, t32, tlong
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.utils import save_checkpoint as jax_save
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    load_flax_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

F32_IDS_MIN = 0.999
WORLD = dict(n_agents=64, num_times=6, num_zones=10)


def tiny_cfg(**kw):
    """tests/test_gnn_embed.py's tiny_cfg, in the port's config."""
    base = dict(zone_dim=16, agent_dim=8, context_dim=8, hidden_dim=16,
                gat_heads=2, gat_layers=1, num_blocks=1, substeps=1,
                batch_size=64, epochs=2)
    base.update(kw)
    return ttrain.GATODEConfig(**base)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def _graph(pair):
    return tuple(t32(pair.data[k]) for k in ("zone_features", "adj", "times"))


def _data(pair):
    d = pair.data
    return t32(d["person_feats"]), tlong(d["home_zone"]), tlong(d["zone_ids"])


def test_epoch_accum_matches_jax():
    """accum=2: every 2 microbatches give ONE update on their mean
    gradient, in both packages, from the same parameters over the same
    batches."""
    pair = make_pair(num_blocks=1, seed=3, **WORLD)
    d = pair.data
    batches = np.random.default_rng(1).permutation(64).reshape(4, 16)
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    opt = optax.sgd(0.05)
    epoch_j = jtrain.make_epoch_fn(
        opt, jtrain._build_loss_fn_g(pair.jmodel, pair.jcfg),
        graph=jtrain._unpack_static(static), accum=2)
    p_j, _, losses_j, _ = epoch_j(
        pair.params, opt.init(pair.params), jnp.asarray(d["person_feats"]),
        jnp.asarray(d["home_zone"]), jnp.asarray(d["zone_ids"]),
        jnp.asarray(batches))

    sgd = torch.optim.SGD(pair.tmodel.parameters(), lr=0.05)
    epoch_t = ttrain.make_epoch_fn(
        sgd, ttrain._build_loss_fn_g(pair.tmodel, pair.tcfg),
        graph=_graph(pair), accum=2)
    losses_t, accs_t = epoch_t(*_data(pair), tlong(batches))
    assert losses_t.shape == (4,) and accs_t.shape == (4,)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5)
    for a, b in zip(_leaves(to_flax_params(pair.tmodel)), _leaves(p_j)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_epoch_matches_per_step_loop():
    """The epoch reproduces the per-step make_step_fns loop: same batches,
    same update order, same ops."""
    pair = make_pair(num_blocks=1, seed=2, **WORLD)
    looped = copy.deepcopy(pair.tmodel)
    batches = tlong(np.random.default_rng(0).permutation(64).reshape(2, 32))
    data, graph = _data(pair), _graph(pair)

    epoch = ttrain.make_epoch_fn(
        ttrain.make_optimizer(pair.tmodel, pair.tcfg),
        ttrain._build_loss_fn_g(pair.tmodel, pair.tcfg), graph=graph)
    losses, _ = epoch(*data, batches)

    step, _ = ttrain.make_step_fns(
        looped, ttrain.make_optimizer(looped, pair.tcfg), pair.tcfg, graph)
    ref = [step(*(a[rows] for a in data))[0].item() for rows in batches]
    np.testing.assert_allclose(losses.numpy(), ref, rtol=1e-6)
    for a, b in zip(pair.tmodel.parameters(), looped.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_epoch_accum_must_divide_the_batches():
    pair = make_pair(num_blocks=1, seed=2, **WORLD)
    epoch = ttrain.make_epoch_fn(
        torch.optim.SGD(pair.tmodel.parameters(), lr=0.05),
        ttrain._build_loss_fn_g(pair.tmodel, pair.tcfg), graph=_graph(pair),
        accum=2)
    with pytest.raises(ValueError, match="divide"):
        epoch(*_data(pair), tlong(np.arange(48).reshape(3, 16)))


def test_resume_reproduces_uninterrupted_run(tmp_path):
    kw = dict(WORLD, seed=5, device="cpu")
    straight = ttrain.train(str(tmp_path / "a"),
                            config=tiny_cfg(epochs=4, batch_size=32), **kw)
    ttrain.train(str(tmp_path / "b"),
                 config=tiny_cfg(epochs=2, batch_size=32), ckpt_every=2,
                 **kw)
    last = load_checkpoint(str(tmp_path / "b" / "gatode_last.ckpt"))
    assert set(last) == {"params", "opt_state", "epoch", "history",
                         "config", "world_seed", "n_agents", "num_times",
                         "num_zones", "sparse_world"}
    assert last["epoch"] == 2 and last["opt_state"]["step"] == 4
    resumed = ttrain.train(str(tmp_path / "b"),
                           config=tiny_cfg(epochs=4, batch_size=32),
                           resume=True, **kw)
    h_a = load_checkpoint(straight["ckpt"])["history"]
    h_b = load_checkpoint(resumed["ckpt"])["history"]
    assert [h["epoch"] for h in h_b] == [1, 2, 3, 4] == [h["epoch"]
                                                         for h in h_a]
    for ra, rb in zip(h_a, h_b):
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=1e-5)
    np.testing.assert_allclose(straight["final_loss"], resumed["final_loss"],
                               rtol=1e-5)
    # a checkpoint of another run is refused
    with pytest.raises(ValueError, match="different run"):
        ttrain.train(str(tmp_path / "b"),
                     config=tiny_cfg(epochs=4, batch_size=32), resume=True,
                     **{**kw, "seed": 6})
    with pytest.raises(ValueError, match="different run"):
        ttrain.train(str(tmp_path / "b"),
                     config=tiny_cfg(epochs=4, batch_size=32, lr=1e-2),
                     resume=True, **kw)


@pytest.mark.parametrize("optax_installed", [True, False])
def test_resume_refuses_a_jax_checkpoint(tmp_path, monkeypatch,
                                         optax_installed):
    """The JAX package's gatode_last.ckpt holds an optax state, which the
    port cannot rebuild (where optax is absent it unpickles as stand-ins,
    and is refused all the same)."""
    config = tiny_cfg(epochs=2, batch_size=32)
    pair = make_pair(num_blocks=1, seed=5, **WORLD, full=True,
                     **{k: v for k, v in dataclasses.asdict(config).items()
                        if k != "num_blocks"})
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    jax_save({"params": pair.params, "opt_state": tx.init(pair.params),
              "epoch": 1, "history": [{"epoch": 1, "loss": 1.0, "acc": 0.1}],
              "config": dataclasses.asdict(pair.jcfg), "world_seed": 5,
              "n_agents": 64, "num_times": 6, "num_zones": 10,
              "sparse_world": False}, str(tmp_path / "gatode_last.ckpt"))
    if not optax_installed:  # as on the card's machine: optax unimportable
        for name in [k for k in sys.modules if k.split(".")[0] == "optax"]:
            monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ValueError, match="optax"):
        ttrain.train(str(tmp_path), config=config, seed=5, resume=True,
                     device="cpu", **WORLD)


def test_train_accum_steps(tmp_path):
    config = tiny_cfg(epochs=1, batch_size=16)
    out = ttrain.train(str(tmp_path / "a"), config=config, accum_steps=2,
                       device="cpu", **WORLD)
    assert np.isfinite(out["final_loss"])
    with pytest.raises(ValueError, match="divide"):
        ttrain.train(str(tmp_path / "b"), config=config, accum_steps=2,
                     device="cpu", **{**WORLD, "n_agents": 48})


def test_loss_decreases(tmp_path):
    res = ttrain.train(str(tmp_path), n_agents=256, num_times=16,
                       config=tiny_cfg(epochs=8), seed=0, device="cpu")
    assert np.isfinite(res["final_loss"]) and res["seconds"] > 0
    hist = load_checkpoint(res["ckpt"])["history"]
    assert len(hist) == 8
    assert hist[-1]["loss"] < hist[0]["loss"], "training must reduce loss"


@pytest.mark.parametrize("change,error,match", [
    (dict(resume=True), FileNotFoundError, "ckpt_every"),
])
def test_train_refusals(tmp_path, change, error, match):
    kw = dict(WORLD, config=tiny_cfg(), device="cpu")
    with pytest.raises(error, match=match):
        ttrain.train(str(tmp_path), **{**kw, **change})


@pytest.mark.parametrize("change", [dict(sparse_zones=True),
                                    dict(sparse_world=True)],
                         ids=["sparse_zones", "sparse_world"])
def test_train_sparse_histories_match_jax(tmp_path, monkeypatch, change):
    """train() on an edge-list zone graph (the two cases that were refused):
    both packages from the same initial parameters (JAX's init_params,
    loaded into the port's model), histories within rtol 1e-5, and the
    checkpoint's sparse_world key."""
    world = dict(n_agents=32, num_times=4, num_zones=16, seed=3)
    base = dict(zone_dim=16, agent_dim=8, context_dim=8, hidden_dim=16,
                gat_heads=2, gat_layers=1, num_blocks=1, substeps=1,
                batch_size=16, epochs=2)
    jparams = []
    real_init = jtrain.init_params

    def keep_init(*a, **kw):
        jparams.append(real_init(*a, **kw))
        return jparams[-1]

    monkeypatch.setattr(jtrain, "init_params", keep_init)
    jres = jtrain.train(str(tmp_path / "jax"),
                        config=jtrain.GATODEConfig(**base), **world, **change)
    monkeypatch.setattr(ttrain, "init_params",
                        lambda model, gen: load_flax_params(model,
                                                            jparams[0]))
    tres = ttrain.train(str(tmp_path / "port"),
                        config=ttrain.GATODEConfig(**base), device="cpu",
                        **world, **change)
    jck, tck = load_checkpoint(jres["ckpt"]), load_checkpoint(tres["ckpt"])
    assert len(tck["history"]) == len(jck["history"]) == 2
    for a, b in zip(tck["history"], jck["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert tck["sparse_world"] == jck["sparse_world"] == bool(
        change.get("sparse_world"))


def test_data_parallel_on_one_device_runs_the_single_device_step(tmp_path):
    kw = dict(WORLD, config=tiny_cfg(batch_size=32), seed=1, device="cpu")
    one = ttrain.train(str(tmp_path / "one"), **kw)
    dp = ttrain.train(str(tmp_path / "dp"), data_parallel=True, **kw)
    assert dp["final_loss"] == one["final_loss"]


def test_trained_checkpoint_is_served_by_both_packages(tmp_path):
    res = ttrain.train(str(tmp_path), n_agents=64, num_times=10,
                       num_zones=12, config=tiny_cfg(num_blocks=2), seed=4,
                       device="cpu")
    ck = load_checkpoint(res["ckpt"])
    assert set(ck) == {"params", "config", "num_zones", "num_times",
                       "history", "world_seed", "sparse_world"}
    jtrain.serve(res["ckpt"], str(tmp_path / "jax.npz"), n_agents=64,
                 seed=2, use_pallas=False)
    ttrain.serve(res["ckpt"], str(tmp_path / "port.npz"), n_agents=64,
                 seed=2, use_kernel=False, device="cpu")
    with np.load(tmp_path / "jax.npz") as w, np.load(tmp_path /
                                                     "port.npz") as g:
        assert g["zone_ids"].shape == w["zone_ids"].shape == (64, 10)
        np.testing.assert_array_equal(g["times"], w["times"])
        assert agreement(g["zone_ids"], w["zone_ids"]) >= F32_IDS_MIN
