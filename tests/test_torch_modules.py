"""Port modules in float32 against the JAX package on the same inputs:
zone encoder, initial state, drift RHS, decode, the whole-day forward,
and the RK4 solver."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.ode.rk4 import rk4_solve as jax_rk4_solve
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.ode.rk4 import rk4_solve

# per-call modules: float32 rounding only
ATOL, RTOL = 1e-5, 1e-5
# whole-day quantities: 9 intervals x 2 substeps of RK4 accumulate rounding
DAY_ATOL = 1e-4

CASES = {
    "tiny-nb1": dict(num_blocks=1),
    "tiny-nb2": dict(num_blocks=2),
    "full-nb2": dict(num_blocks=2, full=True, num_zones=64),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    pair = make_pair(n_agents=64, **CASES[request.param])
    zf, adj, times, pf, hz = pair.arrays()
    m, p = pair.jmodel, {"params": pair.params}
    ze = m.apply(p, zf, adj, method=m.encode_zones)
    x0, h = m.apply(p, pf, hz, ze, method=m.initial_state)
    return pair, np.asarray(ze), np.asarray(x0), np.asarray(h)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_encode_zones_matches_jax(case):
    pair, ze, _, _ = case
    zf, adj, *_ = pair.tensors()
    with torch.no_grad():
        _close(pair.tmodel.encode_zones(zf, adj), ze)


def test_initial_state_matches_jax(case):
    pair, ze, x0, h = case
    *_, pf, hz = pair.tensors()
    with torch.no_grad():
        x0_t, h_t = pair.tmodel.initial_state(pf, hz, t32(ze))
    _close(x0_t, x0)
    _close(h_t, h)


@pytest.mark.parametrize("t", [0.0, 7.3, 23.5])
def test_rhs_matches_jax(case, t):
    pair, ze, x0, h = case
    m = pair.jmodel
    want = m.apply({"params": pair.params}, jnp.float32(t), x0, h, ze,
                   method=m.rhs)
    with torch.no_grad():
        got = pair.tmodel.rhs(torch.tensor(t), t32(x0), t32(h), t32(ze))
    _close(got, want)


def test_decode_matches_jax(case):
    pair, ze, x0, _ = case
    m = pair.jmodel
    want = m.apply({"params": pair.params}, x0, ze, method=m.decode)
    with torch.no_grad():
        _close(pair.tmodel.decode(t32(x0), t32(ze)), want)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_forward_matches_jax(num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=64)
    zf, adj, times, pf, hz = pair.arrays()
    logits_j, xs_j = pair.jmodel.apply(
        {"params": pair.params}, zf, adj, pf, hz, times,
        ode_method="rk4", substeps=2,
    )
    zf, adj, times, pf, hz = pair.tensors()
    with torch.no_grad():
        logits_t, xs_t = pair.tmodel(zf, adj, pf, hz, times, substeps=2)
    assert tuple(logits_t.shape) == (64, 10, 12)
    assert tuple(xs_t.shape) == (64, 10, pair.tcfg.agent_dim)
    _close(xs_t, xs_j, atol=DAY_ATOL)
    _close(logits_t, logits_j, atol=DAY_ATOL)


def test_bf16_compute_dtype_rhs_tracks_jax():
    """compute_dtype='bfloat16' rounds where flax's dtype=bfloat16 does;
    the two frameworks' bf16 kernels differ in accumulation, so the
    comparison is at bf16 resolution (2^-8 relative)."""
    pair = make_pair(num_blocks=2, n_agents=64, full=True, num_zones=64,
                     compute_dtype="bfloat16")
    zf, adj, _, pf, hz = pair.arrays()
    m, p = pair.jmodel, {"params": pair.params}
    ze = m.apply(p, zf, adj, method=m.encode_zones)
    x0, h = m.apply(p, pf, hz, ze, method=m.initial_state)
    want = np.asarray(m.apply(p, jnp.float32(9.0), x0, h, ze, method=m.rhs))
    with torch.no_grad():
        got = pair.tmodel.rhs(torch.tensor(9.0), t32(x0), t32(h), t32(ze))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-2 * scale


@pytest.mark.parametrize("substeps", [1, 3])
def test_rk4_solve_matches_jax(substeps):
    rng = np.random.default_rng(0)
    y0 = rng.normal(size=(5, 3)).astype(np.float32)
    A = (rng.normal(size=(3, 3)) * 0.3).astype(np.float32)
    ts = np.asarray([0.0, 0.4, 1.0, 1.7], np.float32)
    want = jax_rk4_solve(lambda t, y, a: jnp.sin(t) * (y @ a), y0, ts, A,
                         substeps=substeps)
    got = rk4_solve(lambda t, y, a: torch.sin(t) * (y @ a), t32(y0),
                    t32(ts), t32(A), substeps=substeps)
    assert tuple(got.shape) == (4, 5, 3)
    np.testing.assert_array_equal(got[0].numpy(), y0)
    _close(got, want, atol=1e-6)


def test_rk4_solve_is_fourth_order():
    """Halving the step cuts the error of dy/dt = -y by ~16x."""
    y0 = torch.ones(1)
    ts = torch.tensor([0.0, 2.0])
    exact = np.exp(-2.0)
    errs = [
        abs(rk4_solve(lambda t, y, a: -y, y0.double(), ts.double(),
                      substeps=s)[-1].item() - exact)
        for s in (4, 8)
    ]
    assert 12.0 < errs[0] / errs[1] < 20.0


def test_sparse_and_adaptive_paths_raise_not_implemented():
    """The sparse and adaptive paths, once refused, run: the encoder over
    the world's edge list (adj=None) equals the dense encoder, and the
    discrete adjoint's loss is built."""
    pair = make_pair(num_blocks=1, n_agents=8)
    zf, adj, times, pf, hz = pair.tensors()
    src, dst = np.nonzero(pair.data["adj"])[::-1]
    with torch.no_grad():
        _close(pair.tmodel.encode_zones(zf, None, (tlong(src), tlong(dst))),
               pair.tmodel.encode_zones(zf, adj).numpy(), atol=2e-5,
               rtol=2e-5)
    # the adaptive paths run: the discrete adjoint's loss is built
    loss_fn = ttrain.build_adjoint_loss_fn_g(pair.tmodel, pair.tcfg,
                                             (zf, adj, times),
                                             adjoint_mode="discrete")
    assert callable(loss_fn)
