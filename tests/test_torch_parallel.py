"""The port's parallel layer on a 2-rank gloo mesh (2 x 1) on the CPU:
the mesh and row functions, the sharded fused and plain GAT-ODE steps, the
sharded rollouts and ``train(data_parallel=True)``, each held against the
port's single-device call and the JAX package.

One group of ranks (``_torch_parallel_worker.py``, suite ``gatode``) runs
every case of this file once; each test reads its case's results."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_worker as w
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.models.gnn_embed.rollout import (
    make_decoded_rollout as jax_rollout,
)
from ananke_abm_tpu.parallel import distributed as jdist
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import to_flax_params
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    make_decoded_rollout,
    make_pallas_rollout,
)
from ananke_abm_tpu_torch.parallel import distributed as tdist

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_group("gatode", WORLD, str(tmp_path_factory.mktemp("dp")))


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_pair(cfg, data, model):
    jcfg = jtrain.GATODEConfig(**dataclasses.asdict(cfg))
    jmodel = jtrain.build_model(jcfg, data["zone_features"].shape[-1],
                                data["person_feats"].shape[-1])
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(model))
    return jcfg, jmodel, params


@pytest.mark.parametrize("n,pc", [(8, 1), (8, 2), (12, 4), (12, 3), (7, 2),
                                  (10, 4)])
def test_row_functions_equal_the_reference(n, pc):
    assert tdist.global_batch_shape((n, 3), pc) == \
        jdist.global_batch_shape((n, 3), pc)
    if n % pc:
        for mod in (tdist, jdist):
            with pytest.raises(ValueError, match="not divisible"):
                mod.host_row_slice(n, 0, pc)
        return
    for i in range(pc):
        assert tdist.host_row_slice(n, i, pc) == jdist.host_row_slice(n, i,
                                                                      pc)


def test_mesh_and_sharding_api(ranks):
    for rank, r in enumerate(ranks):
        assert list(r["mesh_api/mesh_shape"]) == [2, 1]
        assert list(r["mesh_api/default_zone_parallel"]) == [2, 1]
        assert list(r["mesh_api/summary"]) == [rank, WORLD, 1, WORLD]
        x = np.arange(WORLD * 6, dtype=np.float32).reshape(-1, 2)
        assert list(r["mesh_api/shard_shape"]) == [6, 2]
        np.testing.assert_array_equal(r["mesh_api/shard_local"],
                                      x[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(r["mesh_api/rep_local"], x)
        assert list(r["mesh_api/global_shape"]) == [6, 2]
        np.testing.assert_array_equal(r["mesh_api/global_local"],
                                      x[3 * rank:3 * rank + 3])
        assert "spans the world's 2 ranks" in r["mesh_api/errors"][0]
        assert "not divisible by zone_parallel=3" in r["mesh_api/errors"][1]


def _single_fused():
    cfg, data, model = w.gatode(seed=3, num_times=4, num_zones=10,
                                n_agents=48, num_blocks=2)
    step, _ = ttrain.make_fused_train_step(model, w.optimizer_of(model, cfg),
                                           cfg, w.static_of(data))
    out = [step(*w.batch_of(data)) for _ in range(2)]
    return cfg, data, out, model


def assert_grads_close(got, want):
    """The step's reduced gradients against the single device's: the sums
    over ranks only reorder float32 additions."""
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())


def test_sharded_fused_step_is_the_single_device_step(ranks):
    cfg, data, out, model = _single_fused()
    _, _, start = w.gatode(seed=3, num_times=4, num_zones=10, n_agents=48,
                           num_blocks=2)
    before = w.flat_params(start)
    upd = w.flat_params(model) - before
    for r in ranks:
        for i, (loss, acc) in enumerate(out):
            assert abs(r["fused/loss"][i] - float(loss)) < 1e-4 * max(
                1.0, abs(float(loss)))
            assert abs(r["fused/acc"][i] - float(acc)) < 1e-6
        assert _cos(r["fused/params"] - before, upd) > 0.99
        assert_grads_close(r["fused/grads"], w.flat_grads(model))
    # the first step's loss against JAX's fused loss on the same weights
    jcfg, jmodel, params = _jax_pair(cfg, data, start)
    static = tuple(jnp.asarray(data[k]) for k in
                   ("zone_features", "adj", "times"))
    _, jloss = jtrain.make_fused_train_step(jmodel, optax.adamw(1e-3), jcfg,
                                            static)
    lj, _ = jloss(params, *(jnp.asarray(data[k]) for k in
                            ("person_feats", "home_zone", "zone_ids")))
    assert abs(ranks[0]["fused/loss"][0] - float(lj)) <= 2e-3 * abs(
        float(lj))


def _single_step(name):
    cfg, data, model, static = w.step_case(name)
    before = w.flat_params(model)
    opt = w.optimizer_of(model, cfg)
    if cfg.method == "dopri5":
        step, _ = ttrain.make_adjoint_step_fns(
            model, opt, cfg, static, use_fused=False,
            adjoint_mode="discrete")
    else:
        step, _ = ttrain.make_step_fns(model, opt, cfg, static)
    loss, acc = step(*w.batch_of(data))
    return (cfg, data, float(loss), float(acc), w.flat_params(model) - before,
            getattr(step, "stats", {}), w.flat_grads(model))


@pytest.mark.parametrize("name", sorted(w.STEP_CASES))
def test_sharded_step_is_the_single_device_step(ranks, name):
    cfg, data, loss, acc, upd, stats, grads = _single_step(name)
    for r in ranks:
        np.testing.assert_allclose(r[f"step_{name}/loss"], loss, rtol=1e-4)
        assert abs(r[f"step_{name}/acc"] - acc) < 1e-6
        assert _cos(r[f"step_{name}/update"], upd) > 0.999
        assert_grads_close(r[f"step_{name}/grads"], grads)
    if name == "dopri5":
        return
    # the loss against the JAX package's plain step on the same weights
    _, _, start = w.gatode(seed=1, **{k: v for k, v in
                                      w.STEP_CASES[name].items()
                                      if k != "sparse"})
    jcfg, jmodel, params = _jax_pair(cfg, data, start)
    static = [jnp.asarray(data["zone_features"]), jnp.asarray(data["adj"]),
              jnp.asarray(data["times"])]
    if name == "sparse":
        from ananke_abm_tpu.ops.segment import edges_from_adj

        ei = edges_from_adj(data["adj"])
        static = [static[0], None, static[2],
                  (jnp.asarray(ei[0]), jnp.asarray(ei[1]))]
    _, jloss = jtrain.make_step_fns(jmodel, optax.adamw(1e-3), jcfg,
                                    tuple(static))
    lj, _ = jloss(params, *(jnp.asarray(data[k]) for k in
                            ("person_feats", "home_zone", "zone_ids")))
    np.testing.assert_allclose(ranks[0][f"step_{name}/loss"], float(lj),
                               rtol=1e-4)


def test_dopri5_takes_one_step_sequence_on_every_rank(ranks):
    """The controller's error norm runs over all agents: every rank takes
    the single-device solve's accepted steps."""
    *_, stats, _ = _single_step("dopri5")
    want = [stats["forward"]["n_steps"], stats["forward"]["n_accepted"]]
    for r in ranks:
        assert list(r["step_dopri5/steps"]) == want


def test_clip_acts_on_the_reduced_gradient(ranks):
    """With a clip far below the gradient's norm every update is the
    clipped one: the sharded step's equals the single device's only if the
    clip saw the reduced gradient."""
    cfg, data, model, static = w.step_case("clip")
    model.zero_grad()
    loss, _ = ttrain.make_step_fns(model, None, cfg, static)[1](
        *w.batch_of(data))
    loss.backward()
    norm = float(torch.sqrt(sum((p.grad ** 2).sum()
                                for p in model.parameters())))
    assert norm > 10 * cfg.grad_clip
    *_, upd, _, grads = _single_step("clip")
    np.testing.assert_allclose(np.linalg.norm(grads), cfg.grad_clip,
                               rtol=1e-5)
    for r in ranks:
        assert_grads_close(r["step_clip/grads"], grads)
        np.testing.assert_allclose(r["step_clip/update"], upd, rtol=1e-4,
                                   atol=1e-7)


def test_sharded_step_refusals(ranks):
    assert "needs the dense adjacency" in \
        ranks[0]["step_refusals/messages"][0]


def _single_rollouts():
    cfg, data, model = w.rollout_setup()
    zf, adj, times = w.static_of(data)
    pf, hz, _ = w.batch_of(data)
    sparse = w.static_of(data, sparse=True)
    dopri5 = dataclasses.replace(cfg, method="dopri5", rtol=1e-3, atol=1e-4)

    def forward(c, static):
        with torch.inference_mode():
            logits, _ = model(static[0], static[1], pf, hz, static[2],
                              ode_method=c.method, substeps=c.substeps,
                              rtol=c.rtol, atol=c.atol,
                              edge_index=static[3] if len(static) > 3
                              else None)
        return torch.argmax(logits, -1).to(torch.int32)

    return cfg, data, model, {
        "pallas_step": make_pallas_rollout(model, zf, adj, times,
                                           substeps=cfg.substeps)(pf, hz),
        "pallas_interval": make_pallas_rollout(
            model, zf, adj, times, substeps=cfg.substeps,
            fuse_decode=True)(pf, hz),
        "decoded_kernel": make_decoded_rollout(
            model, cfg, zf, adj, times, use_kernel=True)(pf, hz),
        "decoded_f32": make_decoded_rollout(
            model, cfg, zf, adj, times, use_kernel=False)(pf, hz),
        "sharded_dense": forward(cfg, (zf, adj, times)),
        "sharded_sparse": forward(cfg, sparse),
        "sharded_dopri5": forward(dopri5, (zf, adj, times)),
    }


def test_sharded_rollouts_return_the_single_device_grid(ranks):
    cfg, data, model, want = _single_rollouts()
    for r in ranks:
        for k, v in want.items():
            got = r[f"rollouts/{k}"]
            assert got.shape == (w.ROLLOUT_AGENTS, w.NUM_TIMES), k
            np.testing.assert_array_equal(got, v.numpy(), err_msg=k)
    # and the float32 grid against the JAX package's
    jcfg, jmodel, params = _jax_pair(cfg, data, model)
    jids = jax_rollout(jmodel, jcfg, *(jnp.asarray(data[k]) for k in
                                       ("zone_features", "adj", "times")),
                       use_pallas=False)(
        params, jnp.asarray(data["person_feats"]),
        jnp.asarray(data["home_zone"]))
    assert np.mean(ranks[0]["rollouts/decoded_f32"] == np.asarray(jids)) \
        >= 0.999


@pytest.mark.parametrize("name", sorted(w.TRAIN_CASES))
def test_train_data_parallel_is_the_single_device_run(ranks, name,
                                                      tmp_path):
    """The data-parallel run cuts its batch of 15 to 14 (a multiple of the
    2 ranks), so it equals the single-device run at batch 14."""
    config = dataclasses.replace(w.train_config(), batch_size=14)
    res = ttrain.train(str(tmp_path), config=config, device="cpu",
                       **w.TRAIN_CASES[name])
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    hist = [h["loss"] for h in load_checkpoint(res["ckpt"])["history"]]
    for r in ranks:
        np.testing.assert_allclose(r[f"train/{name}_hist"], hist, rtol=1e-4)
        np.testing.assert_allclose(r[f"train/{name}_loss"],
                                   res["final_loss"], rtol=1e-4)
        assert abs(r[f"train/{name}_acc"] - res["final_acc"]) < 1e-6
    # rank 0 alone wrote the checkpoint; every rank read it; every rank
    # returns the same dict, the wall included
    assert ranks[0][f"train/{name}_ckpt"]
    assert len({float(r[f"train/{name}_seconds"]) for r in ranks}) == 1
