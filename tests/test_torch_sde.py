"""The port's Euler–Maruyama solver (``ananke_abm_tpu_torch/ode/sde.py``)
against ``ananke_abm_tpu.ode.euler_maruyama_solve`` on the CPU, with JAX's
own noise injected (the same tensors, not the same seeds): both modes at
rel 1e-5, the reference's duplicate-snap, partial-last-step and
undersized-``num_steps`` cases, the fixed grid's independence of the
output grid (bit-equal within the port), ``checkpoint`` changing nothing,
and gradients against ``jax.grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.ode import euler_maruyama_solve as j_em
from ananke_abm_tpu_torch.ode import euler_maruyama_solve as t_em

KEY = jax.random.PRNGKey(5)


def fixed_noise(key, num_steps, shape):
    """Step i's draw of the reference's fixed grid: normal(split(
    fold_in(key, i), 1)[0])."""
    def one(i):
        k = jax.random.split(jax.random.fold_in(key, i), 1)[0]
        return jax.random.normal(k, shape, jnp.float32)

    return torch.tensor(np.asarray(jax.vmap(one)(jnp.arange(num_steps + 1))))


def interval_noise(key, n_intervals, substeps, shape):
    """Step s of interval k of the per-interval mode: fold_in(key,
    k * substeps + s)."""
    return fixed_noise(key, n_intervals * substeps - 1, shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def j_drift(t, y, args):
    return -0.8 * y * args + jnp.sin(t) * jnp.tanh(y)


def t_drift(t, y, args):
    return -0.8 * y * args + float(np.sin(np.float32(t))) * torch.tanh(y)


def j_diff(t, y, args):
    return 0.3 * jnp.cos(y)


def t_diff(t, y, args):
    return 0.3 * torch.cos(y)


Y0 = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
SCALE = np.float32(1.3)


@pytest.mark.parametrize("ts", [
    [0.0, 0.7, 1.9, 4.0],
    [0.0, 0.5, 0.501, 1.0, 1.004],  # duplicate snaps
    [0.25, 1.0, 2.333],  # partial last step: 2.083 / 0.1
])
def test_fixed_grid_matches_jax(ts):
    ts = np.asarray(ts, np.float32)
    dt, num_steps = 0.1, 45
    want = j_em(j_drift, j_diff, jnp.asarray(Y0), jnp.asarray(ts), KEY,
                jnp.asarray(SCALE), dt=dt, num_steps=num_steps)
    noise = fixed_noise(KEY, num_steps, Y0.shape)
    for ck in (True, False):
        got = t_em(t_drift, t_diff, torch.tensor(Y0), ts, None,
                   torch.tensor(SCALE), dt=dt, num_steps=num_steps,
                   noise=noise, checkpoint=ck)
        assert got.shape == (len(ts),) + Y0.shape
        assert _rel(got, want) <= 1e-5


def test_fixed_grid_duplicate_snaps_repeat_the_first_row():
    ts = np.asarray([0.0, 0.5, 0.501, 1.0], np.float32)
    got = t_em(t_drift, t_diff, torch.tensor(Y0), ts,
               torch.Generator().manual_seed(0), torch.tensor(SCALE),
               dt=0.01, num_steps=150)
    assert torch.equal(got[1], got[2])
    # zero diffusion is fixed-step Euler: (1 - dt)^(1 / dt)
    got = t_em(lambda t, y, a: -y, lambda t, y, a: torch.zeros_like(y),
               torch.ones(3), ts, torch.Generator().manual_seed(0),
               dt=0.01, num_steps=150)
    np.testing.assert_allclose(got[3].numpy(), (1 - 0.01) ** 100 *
                               np.ones(3), rtol=1e-5)


def test_fixed_grid_undersized_num_steps_raises():
    ts = np.asarray([0.0, 0.5, 2.0], np.float32)
    with pytest.raises(ValueError, match="does not cover"):
        t_em(t_drift, t_diff, torch.tensor(Y0), ts,
             torch.Generator().manual_seed(0), dt=0.01, num_steps=100)
    with pytest.raises(ValueError, match="num_steps"):
        t_em(t_drift, t_diff, torch.tensor(Y0), ts,
             torch.Generator().manual_seed(0), dt=0.01)


def test_fixed_grid_is_output_grid_independent():
    """Coarse and dense output grids over one span give bit-equal states
    at the internal points they share (the same generator seed)."""
    coarse = np.asarray([0.0, 0.7, 1.9, 4.0], np.float32)
    dense = np.linspace(0.0, 4.0, 81).astype(np.float32)
    kw = dict(dt=0.01, num_steps=400)
    y0 = torch.tensor(Y0)
    a = t_em(t_drift, t_diff, y0, coarse, torch.Generator().manual_seed(3),
             torch.tensor(SCALE), **kw)
    b = t_em(t_drift, t_diff, y0, dense, torch.Generator().manual_seed(3),
             torch.tensor(SCALE), **kw)
    shared = 0
    for tc, row in zip(coarse, a):
        j = int(np.argmin(np.abs(dense - tc)))
        if abs(float(dense[j]) - tc) < 0.005:
            assert torch.equal(row, b[j])
            shared += 1
    assert shared == 4


@pytest.mark.parametrize("substeps", [1, 4])
def test_per_interval_matches_jax(substeps):
    ts = np.asarray([0.0, 0.3, 0.35, 1.2], np.float32)
    want = j_em(j_drift, j_diff, jnp.asarray(Y0), jnp.asarray(ts), KEY,
                jnp.asarray(SCALE), substeps=substeps)
    noise = interval_noise(KEY, len(ts) - 1, substeps, Y0.shape)
    for ck in (True, False):
        got = t_em(t_drift, t_diff, torch.tensor(Y0), ts, None,
                   torch.tensor(SCALE), substeps=substeps, noise=noise,
                   checkpoint=ck)
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got[0], torch.tensor(Y0))


@pytest.mark.parametrize("mode", ["fixed", "interval"])
def test_gradients_match_jax_and_ignore_checkpoint(mode):
    ts = np.asarray([0.0, 0.4, 1.0], np.float32)
    kw = (dict(dt=0.05, num_steps=20) if mode == "fixed"
          else dict(substeps=3))
    noise = (fixed_noise(KEY, 20, Y0.shape) if mode == "fixed"
             else interval_noise(KEY, 2, 3, Y0.shape))

    def j_loss(y0, s):
        ys = j_em(j_drift, j_diff, y0, jnp.asarray(ts), KEY, s, **kw)
        return jnp.sum(ys[1:] ** 2)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(Y0),
                                            jnp.asarray(SCALE))
    got = []
    for ck in (True, False):
        y0 = torch.tensor(Y0, requires_grad=True)
        s = torch.tensor(SCALE, requires_grad=True)
        ys = t_em(t_drift, t_diff, y0, ts, None, s, noise=noise,
                  checkpoint=ck, **kw)
        (ys[1:] ** 2).sum().backward()
        got.append((y0.grad, s.grad))
        for g, w in zip((y0.grad, s.grad), want):
            assert _rel(g, w) <= 1e-5
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def test_generator_draws_are_reproducible_and_required():
    ts = np.asarray([0.0, 1.0], np.float32)
    run = lambda seed: t_em(t_drift, t_diff, torch.tensor(Y0), ts,
                            torch.Generator().manual_seed(seed),
                            torch.tensor(SCALE), substeps=10)
    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    with pytest.raises(ValueError, match="generator or noise"):
        t_em(t_drift, t_diff, torch.tensor(Y0), ts, None,
             torch.tensor(SCALE), substeps=2)
