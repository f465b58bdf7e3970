"""The discrete adjoint: the port's ``dopri5_solve(record=...)``,
``odeint_discrete_adjoint``, the fused step hooks, the discrete trainer and
``train(method="dopri5")`` against the JAX package's on the same inputs
(made with numpy from a seed, or the same world and flax parameters).

Bounds are those of the JAX package's own tests of the same functions
(tests/test_ode.py ``TestDiscreteAdjoint``, tests/test_ops_kernels.py
``test_trainer_discrete_mode_matches_continuous``):

- the recorded step sequence: the same accepted count and the same step
  filling each row; start times and the steps the controller chose
  (``rec_h[:n-1]``) within rtol 1e-3 / atol 1e-4. The two controllers run
  the same float32 arithmetic, but the embedded error is a difference of
  nearly equal sums, and the two frameworks' float32 drifts (tanh, sin,
  sums in other orders) move it by ~1e-4 relative; each step size carries
  that through err^(-1/5). The first step is given (0.3): HINIT's first
  step is so short that its error sits at float32 rounding, where the two
  packages' step sizes differ by 20%;
- the last accepted step is the cut one, ``ts[-1] - rec_t0[n-1]`` in
  float32, exactly, in each package (both take ``min(h, t_end - t)``). Its
  value is held through ``rec_t0``'s bound: a cut step is a function of its
  start, and at rtol 1e-6 a one-ulp change of the drift's tanh moves it by
  up to 4.4e-4, past a bound of its own (1.5e-4 at its size);
- the checkpoints within rtol 1e-4 / atol 1e-6, JAX's carried to the
  port's step start (the same time difference moves the state by ~7e-5);
- values equal ``dopri5_solve``'s exactly (the same solve);
- gradients at rtol 2e-3 / atol 2e-5 against the JAX discrete adjoint;
- the trainer: loss within 2e-4 relative and gradient cosine > 0.999;
- ``train(method="dopri5")``: epoch losses within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.ode import dopri5_solve as jax_dopri5
from ananke_abm_tpu.ode import odeint_discrete_adjoint as jax_disc
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    flax_leaf_params,
    load_flax_params,
)
from ananke_abm_tpu_torch.ode import dopri5_solve, odeint_discrete_adjoint
from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as tfd
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

D = 4


def _mlp():
    """tests/test_ode.py's MLP drift, its operands made with numpy."""
    rng = np.random.default_rng(7)
    y0 = (rng.normal(size=(2, D)) * 0.3).astype(np.float32)
    W = (rng.normal(size=(D, D)) * 0.4).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)

    def jrhs(t, y, a):
        return jnp.tanh(y @ a[0] + a[1]) - 0.1 * y + 0.05 * jnp.sin(t)

    def trhs(t, y, a):
        return torch.tanh(y @ a[0] + a[1]) - 0.1 * y + 0.05 * float(
            np.sin(np.float32(t)))

    return jrhs, trhs, y0, (W, b), ts


def _loss(ys):
    return (ys[-1] ** 2).sum() + 0.5 * (ys[2] ** 2).sum()


def test_recorded_step_sequence_matches_jax():
    jrhs, trhs, y0, (W, b), ts = _mlp()
    rec = {"max_accepted": 64, "ckpt_every": 4}
    kw = dict(rtol=1e-6, atol=1e-8, record=rec, first_step=0.3)
    jys, jst = jax_dopri5(jrhs, jnp.asarray(y0), jnp.asarray(ts),
                          (jnp.asarray(W), jnp.asarray(b)), **kw)
    tys, tst = dopri5_solve(trhs, torch.from_numpy(y0), ts,
                            (torch.from_numpy(W), torch.from_numpy(b)), **kw)
    n = int(jst["n_accepted"])
    assert tst["n_accepted"] == n and tst["ok"] and n > 3
    np.testing.assert_allclose(tst["rec_t0"], np.asarray(jst["rec_t0"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tst["rec_h"][:n - 1],
                               np.asarray(jst["rec_h"])[:n - 1],
                               rtol=1e-3, atol=1e-4)
    for t0, h in ((tst["rec_t0"], tst["rec_h"]),
                  (np.asarray(jst["rec_t0"]), np.asarray(jst["rec_h"]))):
        assert h[n - 1] == np.float32(ts[-1]) - t0[n - 1]
    np.testing.assert_array_equal(tst["out_step"], np.asarray(jst["out_step"]))
    assert tuple(tst["ckpts"].shape) == (16, 2, D)
    # a checkpoint is the state at its step's start, which the two packages
    # put up to rec_t0's bound apart: JAX's is carried to the port's start
    # by one Euler step of the drift (the rest is O(|f'| dt^2) < 1e-7)
    rows = np.arange(0, n, rec["ckpt_every"])
    dt = (tst["rec_t0"][rows].astype(np.float64)
          - np.asarray(jst["rec_t0"])[rows])
    jc = np.asarray(jst["ckpts"]).astype(np.float64)
    jt0 = np.asarray(jst["rec_t0"])[rows].astype(np.float64)
    drift = (np.tanh(jc[:len(rows)] @ W + b) - 0.1 * jc[:len(rows)]
             + 0.05 * np.sin(jt0)[:, None, None])
    jc[:len(rows)] += drift * dt[:, None, None]
    np.testing.assert_allclose(tst["ckpts"].numpy(), jc, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-4,
                               atol=1e-6)


def test_forward_equals_dopri5_solve():
    _, trhs, y0, (W, b), ts = _mlp()
    args = (torch.from_numpy(W), torch.from_numpy(b))
    want, st = dopri5_solve(trhs, torch.from_numpy(y0), ts, args, rtol=1e-6,
                            atol=1e-8)
    assert st["ok"]
    got = odeint_discrete_adjoint(trhs, torch.from_numpy(y0), ts, args,
                                  rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("ckpt_every", [1, 4, 64])
def test_gradients_match_jax(ckpt_every):
    """The loss touches an interior row, so the dense-output cotangents are
    folded too."""
    jrhs, trhs, y0, (W, b), ts = _mlp()

    def jloss(y0, a):
        return _loss(jax_disc(jrhs, y0, jnp.asarray(ts), a, rtol=1e-7,
                              atol=1e-9, ckpt_every=ckpt_every))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y0),
                                         (jnp.asarray(W), jnp.asarray(b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (y0, W, b)]
    stats = {}
    ys = odeint_discrete_adjoint(trhs, leaves[0], ts, tuple(leaves[1:]),
                                 rtol=1e-7, atol=1e-9, ckpt_every=ckpt_every,
                                 stats=stats)
    tg = torch.autograd.grad(_loss(ys), leaves)
    for got, want in zip(tg, (jg[0], *jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-5)
    n = stats["forward"]["n_accepted"]
    assert stats["vjps"] == n
    assert stats["replays"] == n - (-(-n // ckpt_every))


@pytest.mark.parametrize("store_f,ckpt_dtype,tol", [
    (True, None, 1e-6), ("bf16", "bf16", 2e-2)])
def test_store_f_and_ckpt_dtype(store_f, ckpt_dtype, tol):
    """The forward's recorded FSAL evals replace the backward's rhs evals:
    float32 storage within float32 rounding, bf16 within the bf16 class;
    values unchanged."""
    _, trhs, y0, (W, b), ts = _mlp()

    def run(**kw):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (y0, W, b)]
        ys = odeint_discrete_adjoint(trhs, leaves[0], ts, tuple(leaves[1:]),
                                     rtol=1e-7, atol=1e-9, ckpt_every=1,
                                     **kw)
        return ys, torch.autograd.grad(_loss(ys), leaves)

    (yb, gb), (yf, gf) = run(), run(store_f=store_f, ckpt_dtype=ckpt_dtype)
    np.testing.assert_array_equal(yf.detach().numpy(), yb.detach().numpy())
    for got, want in zip(gf, gb):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol)


def test_invalid_store_f_and_ckpt_dtype_raise():
    _, trhs, y0, (W, b), ts = _mlp()
    args = (torch.from_numpy(W), torch.from_numpy(b))
    with pytest.raises(ValueError, match="store_f"):
        odeint_discrete_adjoint(trhs, torch.from_numpy(y0), ts, args,
                                store_f="auto")
    with pytest.raises(ValueError, match="ckpt_dtype"):
        odeint_discrete_adjoint(trhs, torch.from_numpy(y0), ts, args,
                                ckpt_dtype="fp16")


def test_unpaired_step_hooks_raise():
    _, trhs, y0, (W, b), ts = _mlp()
    y0, args = torch.from_numpy(y0), (torch.from_numpy(W),
                                      torch.from_numpy(b))
    fake_step = lambda t0, h, y, f, a: None
    fake_vjp = lambda t0, h, y, f, a, g: None
    with pytest.raises(ValueError, match="together"):
        odeint_discrete_adjoint(trhs, y0, ts, args, step_impl=fake_step)
    with pytest.raises(ValueError, match="together"):
        odeint_discrete_adjoint(trhs, y0, ts, args, step_vjp=fake_vjp)
    with pytest.raises(ValueError, match="sentinel"):
        odeint_discrete_adjoint(trhs, y0, ts, args, step_impl=fake_step,
                                step_vjp="generic?")
    ys = odeint_discrete_adjoint(trhs, y0, ts, args, step_impl="tableau",
                                 step_vjp="generic")
    ref, _ = dopri5_solve(trhs, y0, ts, args)
    np.testing.assert_array_equal(ys.numpy(), ref.numpy())


def test_max_accepted_exceeded_poisons():
    """A solve past max_accepted NaN-poisons the rows left, and so the
    gradient, in the value-only call and under autograd alike."""
    rhs = lambda t, y, a: -50.0 * (y - float(np.cos(np.float32(t))))
    ts = np.linspace(0.0, 3.0, 6).astype(np.float32)
    y0 = torch.zeros(2, requires_grad=True)
    ys = odeint_discrete_adjoint(rhs, y0, ts, rtol=1e-8, atol=1e-10,
                                 max_accepted=4)
    assert torch.isnan(ys[-1]).all()
    (g,) = torch.autograd.grad((ys ** 2).sum(), y0)
    assert torch.isnan(g).all()
    ok = odeint_discrete_adjoint(rhs, y0.detach(), ts, rtol=1e-6,
                                 atol=1e-8, max_accepted=512, ckpt_every=8)
    want, st = dopri5_solve(rhs, y0.detach(), ts, rtol=1e-6, atol=1e-8)
    assert st["ok"]
    np.testing.assert_array_equal(ok.numpy(), want.numpy())


SETUP = dict(num_blocks=1, n_agents=48, num_times=5, num_zones=10, seed=11,
             substeps=1, rtol=1e-5, atol=1e-7)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _port_grads(pair, **kw):
    d = pair.data
    static = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    stats = {}
    loss_fn = ttrain.build_adjoint_loss_fn_g(pair.tmodel, pair.tcfg, static,
                                             stats=stats, **kw)
    pair.tmodel.zero_grad()
    loss, _ = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                      tlong(d["zone_ids"]), static)
    loss.backward()
    flat = np.concatenate([
        np.ravel((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
        for path, p in flax_leaf_params(pair.tmodel)])
    return loss.item(), flat, stats


def _jax_discrete_grads(pair):
    """JAX's discrete trainer loss and flat gradient (use_fused=False)."""
    d = pair.data
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    _, loss = jtrain.make_adjoint_step_fns(
        pair.jmodel, optax.adamw(1e-3), pair.jcfg, static, use_fused=False,
        adjoint_mode="discrete")
    (lj, _), g = jax.value_and_grad(
        lambda p: loss(p, jnp.asarray(d["person_feats"]),
                       jnp.asarray(d["home_zone"]),
                       jnp.asarray(d["zone_ids"])), has_aux=True)(
        pair.params)
    return float(lj), np.concatenate([np.ravel(np.asarray(v)) for v in
                                      jax.tree_util.tree_leaves(g)])


def test_discrete_trainer_matches_jax():
    """use_fused=False on both sides: the generic step VJP."""
    pair = make_pair(**SETUP)
    lj, gj = _jax_discrete_grads(pair)
    lt, gt, stats = _port_grads(pair, use_fused=False,
                                adjoint_mode="discrete")
    assert abs(lt - lj) <= 2e-4 * abs(lj)
    assert _cos(gt, gj) > 0.999
    assert stats["forward"]["ok"]
    assert stats["vjps"] == stats["forward"]["n_accepted"]


@pytest.mark.parametrize("plain", [False, True])
def test_discrete_hooks_match_jax(plain):
    """The port's step hooks, the route the card runs (K5 / K7's plain
    versions here, the weight cotangents scattered through
    split_drift_params, Dense_0's time rows by autograd, the controller
    reading the in-kernel error sum), against JAX's discrete trainer on the
    generic step VJP; ``_plain`` picks the same plain versions by name."""
    pair = make_pair(**SETUP)
    lj, gj = _jax_discrete_grads(pair)
    lt, gt, stats = _port_grads(pair, use_fused=True, adjoint_mode="discrete",
                                _plain=plain)
    assert abs(lt - lj) <= 2e-4 * abs(lj)
    assert _cos(gt, gj) > 0.999
    assert stats["forward"]["ok"]
    assert stats["vjps"] == stats["forward"]["n_accepted"]


def test_fused_hooks_match_the_generic_vjp():
    """The step hooks (K5 / K7's plain versions on the CPU, the controller
    reading the in-kernel error sum) against the generic step VJP, and
    against the continuous adjoint at the reference's bounds."""
    pair = make_pair(**SETUP)
    lg, gg, sg = _port_grads(pair, use_fused=False, adjoint_mode="discrete")
    lf, gf, sf = _port_grads(pair, use_fused=True, adjoint_mode="discrete")
    lc, gc, _ = _port_grads(pair, use_fused=False)
    assert abs(lf - lg) <= 1e-5 * abs(lg)
    assert _cos(gf, gg) > 0.9999
    assert sf["forward"]["n_accepted"] == sg["forward"]["n_accepted"]
    assert abs(lf - lc) <= 2e-4 * abs(lc)
    assert _cos(gf, gc) > 0.999
    # the parameters the drift never reads get their gradients from the
    # rest of the loss alone: the same as the generic route's
    assert tfd.dopri5_step_fused.launches == 0  # the CPU launches none


def test_hooks_reject_a_bf16_backward_on_the_card_only():
    """A bf16 backward builds on any device and carries the whole-backward
    hook (on the card K7 and K6 take bf16, and K5 a bf16 forward,
    test_torch_cuda.py); an unknown precision is refused everywhere."""
    pair = make_pair(**SETUP)
    step_impl, step_vjp = tfd.make_fused_dopri5_hooks(
        pair.tmodel, bwd_precision="bf16")
    assert callable(step_impl) and callable(step_vjp)
    assert callable(step_vjp.backward_all)
    with pytest.raises(ValueError, match="precision"):
        tfd.make_fused_dopri5_hooks(pair.tmodel, bwd_precision="fp8")


def test_hooks_split_the_weights_once_per_solve(monkeypatch):
    """The hooks split (and on the card pack) the drift's weights once for
    the forward solve and once for the backward, not once per step; an
    optimizer step between two solves reaches the next solve: two training
    steps on the hooks follow two on the generic step VJP."""
    pair = make_pair(**SETUP)
    d = pair.data
    static = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    batch = (t32(d["person_feats"]), tlong(d["home_zone"]),
             tlong(d["zone_ids"]))
    calls = []
    real_split = tfd.split_drift_params
    monkeypatch.setattr(tfd, "split_drift_params",
                        lambda p: calls.append(1) or real_split(p))
    start = {k: v.clone() for k, v in pair.tmodel.state_dict().items()}
    losses = {}
    for fused in (True, False):
        pair.tmodel.load_state_dict(start)
        opt = ttrain.make_optimizer(pair.tmodel, pair.tcfg)
        step, _ = ttrain.make_adjoint_step_fns(
            pair.tmodel, opt, pair.tcfg, static, use_fused=fused,
            adjoint_mode="discrete")
        calls.clear()
        losses[fused] = [step(*batch)[0].item() for _ in range(2)]
        if fused:
            # one split a solve, forward and backward, over many steps
            assert step.stats["forward"]["n_steps"] > 2
            assert len(calls) == 4
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    assert losses[True][1] != losses[True][0]


def test_train_dopri5_matches_jax(tmp_path, monkeypatch):
    """Both packages' train() from the same initial parameters (JAX's
    init_params at the run's key, loaded into the port's model: the two
    packages draw different numbers from one seed)."""
    world = dict(n_agents=32, num_times=4, num_zones=8, seed=3)
    base = dict(zone_dim=16, agent_dim=8, context_dim=8, hidden_dim=16,
                gat_heads=2, gat_layers=1, num_blocks=1, substeps=1,
                batch_size=16, epochs=2, method="dopri5", rtol=1e-4,
                atol=1e-6)
    jres = jtrain.train(str(tmp_path / "jax"), config=jtrain.GATODEConfig(
        **base), **world)
    jparams = []
    real_init = jtrain.init_params

    def keep_init(*a, **kw):
        jparams.append(real_init(*a, **kw))
        return jparams[-1]

    monkeypatch.setattr(jtrain, "init_params", keep_init)
    jtrain.train(str(tmp_path / "jax2"), config=jtrain.GATODEConfig(**base),
                 **world)
    monkeypatch.setattr(ttrain, "init_params",
                        lambda model, gen: load_flax_params(model,
                                                            jparams[0]))
    tres = ttrain.train(str(tmp_path / "port"), config=ttrain.GATODEConfig(
        **base), device="cpu", **world)
    jh = load_checkpoint(jres["ckpt"])["history"]
    th = load_checkpoint(tres["ckpt"])["history"]
    assert len(th) == len(jh) == 2
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
