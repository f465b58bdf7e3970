"""The port's integrators against the JAX package's on the same inputs:
tree helpers, adaptive DOPRI5 (outputs and step counts), ``odeint`` and the
continuous adjoint's generic route.

Tolerances: DOPRI5 outputs within rtol 1e-5 (float32, the same tableau
and controller; the sums of the error norm run in another order), and the
controller takes exactly the same number of attempted and accepted steps.
Adjoint gradients within rtol 1e-4, atol 1e-6 (two adaptive backward
solves at rtol 1e-7 whose steps agree only to float32 rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.ode import odeint as jax_odeint
from ananke_abm_tpu.ode.adjoint import odeint_adjoint as jax_adjoint
from ananke_abm_tpu.ode.dopri5 import dopri5_solve as jax_dopri5
from ananke_abm_tpu.ode.rk4 import euler_solve as jax_euler
from ananke_abm_tpu.ode.tree import tree_error_norm as jax_error_norm
from ananke_abm_tpu_torch.ode import (
    dopri5_solve,
    euler_solve,
    odeint,
    odeint_adjoint,
)
from ananke_abm_tpu_torch.ode.tree import (
    tree_axpy,
    tree_error_norm,
    tree_leaves,
    tree_lincomb,
    tree_where,
    tree_zeros_like,
)

RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _xla_dot(y, a):
    """``y @ a`` in float32 with the bits of XLA's CPU dot at these small
    shapes: one fused multiply-add a term, in k order. torch's CPU matmul
    sums in another order, and the controller's first error estimate (a
    difference of nearly equal sums, at float32 rounding) turns that last
    bit into a different step sequence."""
    out = torch.zeros(y.shape[:-1] + a.shape[-1:], dtype=y.dtype)
    for k in range(a.shape[0]):
        out = torch.addcmul(out, y[..., k:k + 1], a[k])
    return out


def _linear(seed=0, n=3, d=4, scale=0.5):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(d, d)) * scale).astype(np.float32)
    y0 = rng.normal(size=(n, d)).astype(np.float32)
    return A, y0


def _fsin(t):
    """sin of a float32 time, in float32 (as jnp.sin of an f32 scalar)."""
    return float(np.sin(np.float32(t)))


def _close_to_scale(got, want):
    """rtol 1e-5, with an atol of 1e-5 of the output's largest magnitude:
    over a day of the GAT-ODE drift the two float32 drifts' per-call
    rounding (~1e-6 relative) grows to ~1e-5 of the state's scale on
    values near zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _counts(stats):
    return int(stats["n_steps"]), int(stats["n_accepted"])


@pytest.mark.parametrize("seed,t_end,num_out,rtol,atol", [
    (0, 3.0, 7, 1e-5, 1e-5),
    (1, 5.0, 4, 1e-5, 1e-6),
    (2, 2.0, 12, 1e-4, 1e-6),
])
def test_dopri5_linear_matches_jax(seed, t_end, num_out, rtol, atol):
    A, y0 = _linear(seed)
    ts = np.linspace(0.0, t_end, num_out).astype(np.float32)
    want, wst = jax_dopri5(lambda t, y, a: jnp.sin(t) * y + y @ a,
                           jnp.asarray(y0), jnp.asarray(ts), jnp.asarray(A),
                           rtol=rtol, atol=atol)
    got, gst = dopri5_solve(lambda t, y, a: _fsin(t) * y + _xla_dot(y, a),
                            t32(y0), t32(ts), t32(A), rtol=rtol, atol=atol)
    assert tuple(got.shape) == (num_out, 3, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), y0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
    assert _counts(gst) == _counts(wst)
    assert gst["ok"] and bool(wst["ok"])


def test_dopri5_tree_state_matches_jax():
    """A two-leaf state: one controller over every element of the tree."""
    A, y0 = _linear(3)
    z0 = np.linspace(-1.0, 1.0, 5).astype(np.float32)
    ts = np.asarray([0.0, 0.3, 1.0, 2.5], np.float32)
    want, wst = jax_dopri5(lambda t, y, a: (y[0] @ a, -0.5 * y[1]),
                           (jnp.asarray(y0), jnp.asarray(z0)),
                           jnp.asarray(ts), jnp.asarray(A))
    got, gst = dopri5_solve(lambda t, y, a: (y[0] @ a, -0.5 * y[1]),
                            (t32(y0), t32(z0)), t32(ts), t32(A))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-6)
    assert _counts(gst) == _counts(wst)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_dopri5_gatode_drift_matches_jax(num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=48)
    zf, adj, times, pf, hz = pair.arrays()
    m, p = pair.jmodel, {"params": pair.params}
    ze = m.apply(p, zf, adj, method=m.encode_zones)
    x0, h = m.apply(p, pf, hz, ze, method=m.initial_state)
    want, wst = jax_dopri5(
        lambda t, x, a: m.apply(p, t, x, h, ze, method=m.rhs), x0,
        jnp.asarray(times))
    tm = pair.tmodel
    with torch.no_grad():
        got, gst = dopri5_solve(
            lambda t, x, a: tm.rhs(t, x, t32(h), t32(ze)), t32(x0),
            t32(times))
    _close_to_scale(got, want)
    assert _counts(gst) == _counts(wst)


def test_dopri5_exhaustion_poisons_unfilled_rows():
    """As tests/test_ode.py: a stiff system that 4 attempted steps cannot
    carry to t=1 leaves NaN rows and ok False, never stale values."""
    ts = np.linspace(0.0, 1.0, 6).astype(np.float32)
    ys, stats = dopri5_solve(lambda t, y, a: -1e8 * y, torch.ones(3),
                             t32(ts), max_steps=4)
    assert not stats["ok"] and stats["n_steps"] == 4
    assert torch.isfinite(ys[0]).all()
    assert torch.isnan(ys[-1]).all()


def test_odeint_adjoint_exhaustion_reports_not_ok():
    ts = np.linspace(0.0, 1.0, 4).astype(np.float32)
    ys, stats = odeint(lambda t, y, a: -1e8 * y, torch.ones(2), t32(ts),
                       method="dopri5", adjoint=True, max_steps=4,
                       return_stats=True)
    assert not stats["ok"]
    assert torch.isnan(ys[-1]).all()


def test_odeint_return_stats_paths():
    y0 = torch.ones(2)
    ts = t32(np.linspace(0.0, 1.0, 4))
    rhs = lambda t, y, a: -y
    ys, stats = odeint(rhs, y0, ts, method="rk4", return_stats=True)
    assert stats["ok"] and stats["n_steps"] == 3
    ys, stats = odeint(rhs, y0, ts, method="euler", substeps=2,
                       return_stats=True)
    assert stats["n_accepted"] == 6
    ys, stats = odeint(rhs, y0, ts, method="dopri5", adjoint=False,
                       return_stats=True)
    _, wst = jax_odeint(lambda t, y, a: -y, jnp.ones(2), jnp.asarray(ts),
                        method="dopri5", adjoint=False, return_stats=True)
    assert stats["ok"] and _counts(stats) == _counts(wst)
    ys, stats = odeint(rhs, y0, ts, method="dopri5", adjoint=True,
                       return_stats=True)
    assert stats["ok"] and stats["n_steps"] is None
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-4)
    with pytest.raises(ValueError, match="Unknown ODE method"):
        odeint(rhs, y0, ts, method="banana")


@pytest.mark.parametrize("method,substeps", [("euler", 1), ("euler", 3),
                                             ("rk4", 2)])
def test_fixed_step_odeint_matches_jax(method, substeps):
    A, y0 = _linear(4)
    ts = np.asarray([0.0, 0.4, 1.0, 1.7], np.float32)
    want = jax_odeint(lambda t, y, a: jnp.sin(t) * (y @ a),
                      jnp.asarray(y0), jnp.asarray(ts), jnp.asarray(A),
                      method=method, substeps=substeps)
    got = odeint(lambda t, y, a: torch.sin(t) * (y @ a), t32(y0), t32(ts),
                 t32(A), method=method, substeps=substeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_euler_solve_matches_jax():
    A, y0 = _linear(5)
    ts = np.asarray([0.0, 0.5, 1.5], np.float32)
    want = jax_euler(lambda t, y, a: y @ a, jnp.asarray(y0),
                     jnp.asarray(ts), jnp.asarray(A), substeps=4)
    got = euler_solve(lambda t, y, a: y @ a, t32(y0), t32(ts), t32(A),
                      substeps=4)
    assert tuple(got.shape) == (3, 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_tree_error_norm_counts_every_element():
    """Zeros count in the mean: a zero leaf changes the norm's n."""
    rng = np.random.default_rng(6)
    err = (rng.normal(size=(4, 3)).astype(np.float32) * 1e-5,
           np.zeros((7,), np.float32))
    y0 = (rng.normal(size=(4, 3)).astype(np.float32),
          rng.normal(size=(7,)).astype(np.float32))
    y1 = tuple(y * np.float32(1.1) for y in y0)
    want = float(jax_error_norm(tuple(map(jnp.asarray, err)),
                                tuple(map(jnp.asarray, y0)),
                                tuple(map(jnp.asarray, y1)), 1e-5, 1e-6))
    got = tree_error_norm(tuple(map(t32, err)), tuple(map(t32, y0)),
                          tuple(map(t32, y1)), 1e-5, 1e-6)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    alone = tree_error_norm((t32(err[0]),), (t32(y0[0]),), (t32(y1[0]),),
                            1e-5, 1e-6)
    np.testing.assert_allclose(float(got), float(alone) * np.sqrt(12 / 19),
                               rtol=1e-6)


def test_tree_helpers():
    a = (torch.ones(2), (torch.full((3,), 2.0),))
    b = (torch.zeros(2), (torch.ones(3),))
    assert [tuple(t.shape) for t in tree_leaves(a)] == [(2,), (3,)]
    out = tree_axpy(0.5, a, b)
    np.testing.assert_allclose(out[1][0].numpy(), 2.0)
    comb = tree_lincomb([2.0, -1.0], [a, b])
    np.testing.assert_allclose(comb[0].numpy(), 2.0)
    np.testing.assert_allclose(comb[1][0].numpy(), 3.0)
    assert tree_where(True, a, b) is a and tree_where(False, a, b) is b
    assert all(float(t.abs().sum()) == 0 for t in
               tree_leaves(tree_zeros_like(a)))


def test_odeint_adjoint_generic_matches_jax():
    """The linear-tanh system of tests/test_ode.py: gradients of the
    continuous adjoint (torch.autograd.grad route) against JAX's."""
    rng = np.random.default_rng(0)
    D = 4
    y0 = (rng.normal(size=(2, D)) * 0.3).astype(np.float32)
    W = (rng.normal(size=(D, D)) * 0.4).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)

    def jloss(y0, args):
        ys = jax_adjoint(lambda t, y, a: jnp.tanh(y @ a[0] + a[1]) - 0.1 * y,
                         y0, jnp.asarray(ts), args, rtol=1e-7, atol=1e-9)
        return jnp.sum(ys[-1] ** 2) + 0.5 * jnp.sum(ys[2] ** 2)

    jl, (gy, (gW, gb)) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(y0), (jnp.asarray(W), jnp.asarray(b)))

    yt, Wt, bt = (t32(v).requires_grad_(True) for v in (y0, W, b))
    stats = {}
    ys = odeint_adjoint(lambda t, y, a: torch.tanh(y @ a[0] + a[1]) - 0.1 * y,
                        yt, t32(ts), (Wt, bt), rtol=1e-7, atol=1e-9,
                        stats=stats)
    loss = torch.sum(ys[-1] ** 2) + 0.5 * torch.sum(ys[2] ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in ((yt.grad, gy), (Wt.grad, gW), (bt.grad, gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert stats["forward"]["ok"]
    assert len(stats["backward"]) == len(ts) - 1
    assert all(s["ok"] for s in stats["backward"])


def test_odeint_adjoint_gradient_is_zero_for_unused_args():
    """An ``args`` leaf the RHS never reads gets an exact zero gradient
    (and still counts in the backward's error norm)."""
    y0 = t32(np.ones((2, 3)))
    k = t32(np.asarray(0.7)).requires_grad_(True)
    unused = t32(np.ones(5)).requires_grad_(True)
    ys = odeint_adjoint(lambda t, y, a: -a[0] * y, y0.requires_grad_(True),
                        t32(np.asarray([0.0, 0.5, 1.0])), (k, unused))
    ys[-1].sum().backward()
    assert float(unused.grad.abs().max()) == 0.0
    # d/dk sum(y0 exp(-k t)) at t = 1
    np.testing.assert_allclose(k.grad.item(), -6 * np.exp(-0.7), rtol=1e-4)
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-0.7), rtol=1e-4)


def test_gatode_forward_dopri5_matches_jax():
    pair = make_pair(num_blocks=2, n_agents=32)
    zf, adj, times, pf, hz = pair.arrays()
    logits_w, xs_w = pair.jmodel.apply({"params": pair.params}, zf, adj, pf,
                                       hz, times, ode_method="dopri5")
    with torch.no_grad():
        logits, xs = pair.tmodel(t32(zf), t32(adj), t32(pf), tlong(hz),
                                 t32(times), ode_method="dopri5")
    assert tuple(xs.shape) == tuple(xs_w.shape)
    _close_to_scale(xs, xs_w)
    _close_to_scale(logits, logits_w)
