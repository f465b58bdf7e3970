"""The fused fixed-step trainer: the port's ``make_fused_train_step`` (the
training-day kernels' plain versions on the CPU) against the JAX package's
(its Pallas kernels in interpret mode) on the same data and flax
parameters, and against the port's own plain ``make_step_fns``.

Bounds:

- loss at full width (96 agents x 5 times x 16 zones): within 2e-3
  relative of JAX's. Both round at the same bf16 points and sum in float32
  in other orders; the zone encoder is the flax encoder here and the fused
  GAT kernel there (float32 op-order jitter, < 1e-4 in tests/
  test_fused_train.py);
- the full gradient at the narrow widths: cosine > 0.999, the JAX tests'
  bound for the fused step;
- one AdamW step: ``torch.optim.AdamW`` at optax's defaults on the step's
  own gradients lands within 1e-6 of ``optax.adamw(1e-3)``;
- against the port's plain step (float32 autograd through RK4): loss
  within 1e-2 relative, accuracy within 5e-3, gradient cosine > 0.999, as
  tests/test_fused_train.py holds the JAX fused step against its XLA step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    flax_leaf_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.ops.cuda import fused_train

FULL = dict(n_agents=96, num_times=5, num_zones=16, seed=3, full=True)
NARROW = dict(n_agents=48, num_times=4, num_zones=10, seed=5)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _static(pair):
    return tuple(t32(pair.data[k]) for k in
                 ("zone_features", "adj", "times"))


def _batch(pair):
    d = pair.data
    return t32(d["person_feats"]), tlong(d["home_zone"]), tlong(d["zone_ids"])


def _jax_loss(pair, grad=False):
    d = pair.data
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    _, loss = jtrain.make_fused_train_step(pair.jmodel, optax.adamw(1e-3),
                                           pair.jcfg, static)
    batch = tuple(jnp.asarray(d[k]) for k in
                  ("person_feats", "home_zone", "zone_ids"))
    if not grad:
        l, acc = loss(pair.params, *batch)
        return float(l), float(acc)
    g = jax.grad(lambda p: loss(p, *batch)[0])(pair.params)
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree_util.tree_leaves(g)])


def _port_grads(model):
    return np.concatenate([
        np.ravel((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
        for path, p in flax_leaf_params(model)])


def _port_loss(pair, make=ttrain.make_fused_train_step):
    _, loss_fn = make(pair.tmodel, None, pair.tcfg, _static(pair))
    pair.tmodel.zero_grad()
    loss, acc = loss_fn(*_batch(pair))
    loss.backward()
    return loss.item(), acc.item(), _port_grads(pair.tmodel)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_fused_loss_matches_jax_at_full_width(num_blocks):
    pair = make_pair(num_blocks=num_blocks, **FULL)
    lj, aj = _jax_loss(pair)
    lt, at, _ = _port_loss(pair)
    assert abs(lt - lj) <= 2e-3 * abs(lj), (lt, lj)
    assert abs(at - aj) < 5e-3


def test_fused_gradient_matches_jax():
    pair = make_pair(num_blocks=2, **NARROW)
    gj = _jax_loss(pair, grad=True)
    _, _, gt = _port_loss(pair)
    assert gt.shape == gj.shape
    assert _cos(gt, gj) > 0.999


def test_fused_step_with_adamw_matches_optax():
    pair = make_pair(num_blocks=1, **NARROW)
    before = to_flax_params(pair.tmodel)
    opt = torch.optim.AdamW(pair.tmodel.parameters(), lr=1e-3,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step, _ = ttrain.make_fused_train_step(pair.tmodel, opt, pair.tcfg,
                                           _static(pair))
    loss, acc = step(*_batch(pair))
    assert np.isfinite(loss.item()) and 0.0 <= acc.item() <= 1.0
    # the gradients the step used, in flax layout and leaf order
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(before),
        [jnp.asarray((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
         for path, p in flax_leaf_params(pair.tmodel)])
    tx = optax.adamw(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, before)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    got = to_flax_params(pair.tmodel)
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_fused_step_matches_the_plain_step():
    pair = make_pair(num_blocks=2, **FULL)
    lf, af, gf = _port_loss(pair)
    lp, ap, gp = _port_loss(pair, make=ttrain.make_step_fns)
    assert abs(lf - lp) < 1e-2 * abs(lp)
    assert abs(af - ap) < 5e-3
    assert _cos(gf, gp) > 0.999


def test_plain_step_matches_jax_step():
    """make_step_fns: float32 autograd through RK4 on both sides."""
    pair = make_pair(num_blocks=1, **NARROW)
    d = pair.data
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    _, loss = jtrain.make_step_fns(pair.jmodel, optax.adamw(1e-3), pair.jcfg,
                                   static)
    batch = tuple(jnp.asarray(d[k]) for k in
                  ("person_feats", "home_zone", "zone_ids"))
    (lj, aj), g = jax.value_and_grad(lambda p: loss(p, *batch),
                                     has_aux=True)(pair.params)
    gj = np.concatenate([np.ravel(np.asarray(v))
                         for v in jax.tree_util.tree_leaves(g)])
    lt, at, gt = _port_loss(pair, make=ttrain.make_step_fns)
    assert abs(lt - float(lj)) <= 1e-5 * abs(float(lj))
    assert at == pytest.approx(float(aj))
    assert _cos(gt, gj) > 0.9999


def test_train_step_lowers_the_loss_on_the_plain_versions():
    pair = make_pair(num_blocks=1, **{**NARROW, "lr": 1e-2})
    opt = ttrain.make_optimizer(pair.tmodel, pair.tcfg)
    step, _ = ttrain.make_fused_train_step(pair.tmodel, opt, pair.tcfg,
                                           _static(pair))
    counts = lambda: tuple(f.launches for f in (
        fused_train.day_forward_fused, fused_train.day_backward_fused,
        fused_train.ce_forward_fused, fused_train.ce_backward_fused))
    before = counts()
    losses = [step(*_batch(pair))[0].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert counts() == before  # the CPU launches no kernel


@pytest.mark.parametrize("change,obj", [
    ({"method": "dopri5"}, "config"), ({"num_blocks": 0}, "config"),
    ({"attn_temp": 2.0}, "model"),
])
def test_fused_step_refusals(change, obj):
    pair = make_pair(num_blocks=1, **NARROW)
    config = pair.tcfg
    if obj == "model":
        pair.tmodel.attn_temp = change["attn_temp"]
    else:
        config = ttrain.GATODEConfig(**{**vars(pair.tcfg), **change})
    with pytest.raises(ValueError):
        ttrain.make_fused_train_step(pair.tmodel, None, config,
                                     _static(pair))
