"""The continuous-adjoint DOPRI5 trainer: the port's ``make_adjoint_step_fns``
against the JAX package's on the same data and flax parameters, the
optimizer against optax, and the trainer's knobs.

Sizes and bounds are tests/test_ops_kernels.py's for the same comparison
(48 agents, 5 times, 10 zones, the narrow widths, rtol 1e-5, atol 1e-7):

- ``use_fused=False`` (float32 drift, autograd VJP on both sides): loss
  within 1e-5 relative, gradient cosine > 0.9999, and the forward solve
  takes the same number of accepted steps;
- ``use_fused=True`` (the kernel's plain version against the Pallas kernel
  in interpret mode, both bf16 with float32 sums in other orders): loss
  within 2e-3 relative, gradient cosine > 0.999;
- one optimizer step: parameters within 1e-6 of optax's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.ode.dopri5 import dopri5_solve as jax_dopri5
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    flax_leaf_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.ops.cuda.fused_rhs import drift_rhs_and_vjp

SETUP = dict(num_blocks=1, n_agents=48, num_times=5, num_zones=10, seed=11,
             substeps=1, rtol=1e-5, atol=1e-7)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_loss_and_grad(pair, use_fused):
    d = pair.data
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    _, loss = jtrain.make_adjoint_step_fns(
        pair.jmodel, optax.adamw(1e-3), pair.jcfg, static,
        use_fused=use_fused)
    (l, acc), g = jax.value_and_grad(
        lambda p: loss(p, jnp.asarray(d["person_feats"]),
                       jnp.asarray(d["home_zone"]),
                       jnp.asarray(d["zone_ids"])), has_aux=True)(
        pair.params)
    flat = np.concatenate([np.ravel(np.asarray(v)) for v in
                           jax.tree_util.tree_leaves(g)])
    return float(l), float(acc), flat


def _port_loss_and_grad(pair, use_fused):
    d = pair.data
    static = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    _, loss_fn = ttrain.make_adjoint_step_fns(
        pair.tmodel, None, pair.tcfg, static, use_fused=use_fused)
    pair.tmodel.zero_grad()
    loss, acc = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                        tlong(d["zone_ids"]))
    loss.backward()
    flat = np.concatenate([
        np.ravel((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
        for path, p in flax_leaf_params(pair.tmodel)
    ])
    return loss.item(), acc.item(), flat, loss_fn.stats


def _jax_forward_stats(pair):
    zf, adj, times, pf, hz = pair.arrays()
    m, p = pair.jmodel, {"params": pair.params}
    ze = m.apply(p, zf, adj, method=m.encode_zones)
    x0, h = m.apply(p, pf, hz, ze, method=m.initial_state)
    _, st = jax_dopri5(lambda t, x, a: m.apply(p, t, x, h, ze, method=m.rhs),
                       x0, jnp.asarray(times), rtol=pair.jcfg.rtol,
                       atol=pair.jcfg.atol)
    return int(st["n_steps"]), int(st["n_accepted"])


def test_adjoint_trainer_matches_jax_plain_path():
    pair = make_pair(**SETUP)
    lj, accj, gj = _jax_loss_and_grad(pair, use_fused=False)
    lt, acct, gt, stats = _port_loss_and_grad(pair, use_fused=False)
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    assert acct == pytest.approx(accj)
    assert _cos(gt, gj) > 0.9999
    # at atol 1e-7 the first steps' error norms sit near the drifts'
    # float32 rounding (1.18e-4 in JAX against 1.29e-4 here at step 0), so
    # a borderline step may be rejected on one side only: the accepted
    # sequence is the same, the attempted count within one rejection
    fwd = stats["forward"]
    n_steps, n_accepted = _jax_forward_stats(pair)
    assert fwd["n_accepted"] == n_accepted
    assert abs(fwd["n_steps"] - n_steps) <= 1
    assert len(stats["backward"]) == SETUP["num_times"] - 1
    assert all(s["ok"] for s in stats["backward"])


def test_adjoint_trainer_matches_jax_fused_path():
    """K8's plain version (the port on the CPU) against the Pallas kernel
    in interpret mode, each inside its own package's trainer."""
    pair = make_pair(**SETUP)
    lj, _, gj = _jax_loss_and_grad(pair, use_fused=True)
    before = drift_rhs_and_vjp.launches
    lt, _, gt, stats = _port_loss_and_grad(pair, use_fused=True)
    assert abs(lt - lj) <= 2e-3 * abs(lj)
    assert _cos(gt, gj) > 0.999
    assert drift_rhs_and_vjp.launches == before  # the CPU launches nothing
    assert stats["forward"]["ok"]


def test_auto_takes_the_plain_route_on_the_cpu():
    pair = make_pair(**SETUP)
    la, _, ga, _ = _port_loss_and_grad(pair, use_fused="auto")
    lf, _, gf, _ = _port_loss_and_grad(pair, use_fused=False)
    assert la == lf
    np.testing.assert_array_equal(ga, gf)


def test_train_step_updates_the_model_and_lowers_the_loss():
    pair = make_pair(**{**SETUP, "lr": 1e-2})
    d = pair.data
    static = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    opt = ttrain.make_optimizer(pair.tmodel, pair.tcfg)
    step, loss_fn = ttrain.make_adjoint_step_fns(pair.tmodel, opt,
                                                 pair.tcfg, static)
    batch = (t32(d["person_feats"]), tlong(d["home_zone"]),
             tlong(d["zone_ids"]))
    before = [p.detach().clone() for p in pair.tmodel.parameters()]
    losses = [float(step(*batch)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert all(not torch.equal(b, p) for b, p in
               zip(before, pair.tmodel.parameters()))
    assert step.stats is loss_fn.stats and step.stats["forward"]["ok"]


def test_optimizer_step_matches_optax():
    """Global-norm clip (above the limit, then below it) then AdamW."""
    pair = make_pair(**SETUP)
    cfg = pair.tcfg
    rng = np.random.default_rng(0)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adamw(cfg.lr, weight_decay=cfg.weight_decay))
    params = jax.tree_util.tree_map(jnp.asarray, pair.params)
    state = tx.init(params)
    opt = ttrain.make_optimizer(pair.tmodel, cfg)
    leaves = flax_leaf_params(pair.tmodel)
    for scale in (1.0, 1e-3):  # global norm ~ 20, then ~ 0.02
        grads = jax.tree_util.tree_map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * scale,
                                  jnp.float32), params)
        norm = float(optax.global_norm(grads))
        assert (norm > cfg.grad_clip) == (scale == 1.0)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for (path, p), (_, g) in zip(
                leaves, jax.tree_util.tree_leaves_with_path(grads)):
            g = torch.tensor(np.asarray(g))
            p.grad = g.T.contiguous() if path[-1] == "kernel" else g
        opt.step()
        got = to_flax_params(pair.tmodel)
        for (path, v), w in zip(leaves, jax.tree_util.tree_leaves(params)):
            node = got
            for k in path:
                node = node[k]
            np.testing.assert_allclose(node, np.asarray(w), rtol=0,
                                       atol=1e-6)


def test_adjoint_modes_and_fused_contract():
    pair = make_pair(**SETUP)
    static = tuple(t32(pair.data[k]) for k in
                   ("zone_features", "adj", "times"))
    # the discrete mode runs (its parity: tests/test_torch_discrete_adjoint.py)
    _, loss_fn = ttrain.make_adjoint_step_fns(pair.tmodel, None, pair.tcfg,
                                              static, adjoint_mode="discrete")
    d = pair.data
    loss, _ = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                      tlong(d["zone_ids"]))
    loss.backward()
    assert np.isfinite(loss.item())
    assert loss_fn.stats["vjps"] == loss_fn.stats["forward"]["n_accepted"]
    with pytest.raises(ValueError, match="adjoint_mode"):
        ttrain.build_adjoint_loss_fn_g(pair.tmodel, pair.tcfg, static,
                                       adjoint_mode="banana")
    pair.tmodel.attn_temp = 2.0
    with pytest.raises(ValueError, match="attn_temp"):
        ttrain.build_adjoint_loss_fn_g(pair.tmodel, pair.tcfg, static,
                                       use_fused=True)
    # a sparse static (adj None, the world's edge list) gives the dense loss
    src, dst = np.nonzero(d["adj"])[::-1]
    sparse = (static[0], None, static[2], (tlong(src), tlong(dst)))
    losses = []
    for graph in (static, sparse):
        loss_g = ttrain.build_adjoint_loss_fn_g(pair.tmodel, pair.tcfg,
                                                graph, adjoint_mode="discrete")
        losses.append(loss_g(t32(d["person_feats"]), tlong(d["home_zone"]),
                             tlong(d["zone_ids"]), graph)[0].item())
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
