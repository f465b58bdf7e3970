"""The adjoint RHS (kernels K8 and K8a): the port's plain versions against
the JAX Pallas kernels run in interpret mode, through
``make_fused_adjoint_rhs`` on both sides, the continuous adjoint over the
fused pair, and the wrappers' CPU dispatch.

Tolerances, as tests/test_ops_kernels.py holds the Pallas kernel against
the float32 model: both sides round at the same bf16 points but sum in
another order, so now and then a bf16 rounding lands on the other side:
f within 2e-2 of its scale, cosine > 0.999 on gx, gh, gze and the whole
parameter gradient; parameters outside the drift get exact zeros."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair, t32
from ananke_abm_tpu.ops.pallas.fused_rhs import (
    drift_rhs_fused as jax_drift_rhs_fused,
)
from ananke_abm_tpu.ops.pallas.fused_rhs import (
    make_fused_adjoint_rhs as jax_make_fused_adjoint_rhs,
)
from ananke_abm_tpu.ops.pallas.fused_rhs import (
    split_drift_params as jax_split,
)
from ananke_abm_tpu.ops.pallas.fused_rhs import time_row as jax_time_row
from ananke_abm_tpu_torch.models.gnn_embed.params import flax_leaf_params
from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
    drift_rhs_and_vjp,
    drift_rhs_and_vjp_reference,
    drift_rhs_fused,
    drift_rhs_reference,
    grad_layout,
    make_fused_adjoint_rhs,
    split_drift_params,
    time_row,
)

F_RTOL = 2e-2
COS_MIN = 0.999
OUTSIDE_DRIFT = ("zone_gat", "context_encoder", "init_proj", "decode_proj")


def _cos(a, b):
    a = np.concatenate([np.ravel(np.asarray(x)) for x in a])
    b = np.concatenate([np.ravel(np.asarray(x)) for x in b])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _operands(pair, n, num_zones, seed):
    rng = np.random.default_rng(seed)
    c = pair.jcfg
    x = rng.normal(size=(n, c.agent_dim)).astype(np.float32)
    h = rng.normal(size=(n, c.context_dim)).astype(np.float32)
    ze = rng.normal(size=(num_zones, c.zone_dim)).astype(np.float32)
    a = rng.normal(size=(n, c.agent_dim)).astype(np.float32)
    return x, h, ze, a


def _port_params(pair):
    leaves = flax_leaf_params(pair.tmodel)
    return leaves, tuple(p for _, p in leaves)


@pytest.mark.parametrize("num_blocks,full,n,num_zones", [
    (1, False, 150, 12),
    (2, False, 150, 12),
    (1, True, 96, 64),
    (2, True, 256, 64),
])
def test_fused_adjoint_rhs_matches_jax_interpret(num_blocks, full, n,
                                                 num_zones):
    pair = make_pair(num_blocks=num_blocks, n_agents=16, full=full)
    x, h, ze, a = _operands(pair, n, num_zones, seed=3)
    t = np.float32(7.3)
    _, jv = jax_make_fused_adjoint_rhs(pair.params, interpret=True)
    fj, gxj, (gpj, ghj, gzej) = jv(
        jnp.asarray(t), jnp.asarray(x),
        (pair.params, jnp.asarray(h), jnp.asarray(ze)), jnp.asarray(a))
    leaves, params = _port_params(pair)
    _, tv = make_fused_adjoint_rhs(pair.tmodel)
    with torch.no_grad():
        ft, gxt, (gpt, ght, gzet) = tv(float(t), t32(x),
                                       (params, t32(h), t32(ze)), t32(a))
    fj = np.asarray(fj)
    assert np.abs(ft.numpy() - fj).max() / np.abs(fj).max() < F_RTOL
    assert _cos([ft], [fj]) > 0.9995
    assert _cos([gxt], [gxj]) > COS_MIN
    assert _cos([ght], [ghj]) > COS_MIN
    assert _cos([gzet], [gzej]) > COS_MIN
    # the JAX tree's leaves in its flattening order == flax_leaf_params
    jleaves = jax.tree_util.tree_leaves_with_path(gpj)
    assert [tuple(k.key for k in path) for path, _ in jleaves] == \
        [p for p, _ in leaves]
    port = [(g.T if p[-1] == "kernel" else g) for (p, _), g in
            zip(leaves, gpt)]
    assert _cos(port, [v for _, v in jleaves]) > COS_MIN
    for (path, _), g in zip(leaves, gpt):
        if path[0] in OUTSIDE_DRIFT:
            assert float(g.abs().max()) == 0.0, path


def test_drift_rhs_fused_matches_jax_interpret():
    pair = make_pair(num_blocks=2, n_agents=16)
    x, h, ze, _ = _operands(pair, 70, 12, seed=4)
    t = np.float32(12.0)
    (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = jax_split(pair.params)
    want = np.asarray(jax_drift_rhs_fused(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(ze),
        jax_time_row(jnp.asarray(t), W1t, b1), Wq, W1xc, W1h, blocks, W3,
        b3, interpret=True))
    leaves, _ = _port_params(pair)
    w = split_drift_params(dict(leaves))
    with torch.no_grad():
        got = drift_rhs_fused(t32(x), t32(h), t32(ze),
                              time_row(float(t), w[3], w[4]), w[0], w[1],
                              w[2], w[5], w[6], w[7])
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < F_RTOL
    assert _cos([got], [want]) > 0.9995


def test_split_drift_params_and_time_row_match_jax():
    pair = make_pair(num_blocks=2, n_agents=16, full=True)
    want = jax_split(pair.params)
    leaves, _ = _port_params(pair)
    got = split_drift_params(dict(leaves))
    flat = lambda w: [w[0], w[1], w[2], w[3], w[4], *[m for b in w[5]
                                                       for m in b],
                      w[6], w[7]]
    for g, wv in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(wv))
    tr = jax_time_row(jnp.float32(17.25), want[3], want[4])
    with torch.no_grad():
        np.testing.assert_allclose(
            time_row(17.25, got[3], got[4]).numpy(), np.asarray(tr),
            atol=1e-6)


def _args(pair, n, num_zones, seed=5):
    x, h, ze, a = (t32(v) for v in _operands(pair, n, num_zones, seed))
    leaves, _ = _port_params(pair)
    (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = (
        split_drift_params(dict(leaves)))
    d = lambda w: w.detach()
    return (x, h, ze, time_row(3.1, d(W1t), d(b1)), d(Wq), d(W1xc), d(W1h),
            tuple(tuple(d(w) for w in b) for b in blocks), d(W3), d(b3), a)


def test_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    pair = make_pair(num_blocks=2, n_agents=16)
    args = _args(pair, 40, 12)
    before = drift_rhs_and_vjp.launches
    got = drift_rhs_and_vjp(*args)
    want = drift_rhs_and_vjp_reference(*args)
    flat = lambda o: [*o[:8], *[w for b in o[8] for w in b], o[9], o[10]]
    for g, w in zip(flat(got), flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert drift_rhs_and_vjp.launches == before == 0


def test_reference_output_shapes_follow_the_kernel_layout():
    """The summed gradients come in the shapes ``grad_layout`` gives the
    kernel's one output vector."""
    pair = make_pair(num_blocks=2, n_agents=16)
    c = pair.jcfg
    out = drift_rhs_and_vjp_reference(*_args(pair, 9, 5))
    summed = [out[3], out[4], out[5], out[6], out[7],
              *[w for b in out[8] for w in b], out[9], out[10]]
    layout = grad_layout(5, c.zone_dim, c.agent_dim, c.context_dim,
                         c.hidden_dim, 2)
    assert [tuple(t.shape) for t in summed] == [s for _, s in layout]
    assert tuple(out[0].shape) == tuple(out[1].shape) == (9, c.agent_dim)
    assert tuple(out[2].shape) == (9, c.context_dim)


def test_wrapper_rejects_bad_operands():
    pair = make_pair(num_blocks=1, n_agents=16)
    args = list(_args(pair, 8, 12))
    drift_rhs_and_vjp(*args)  # well-formed
    bad = list(args)
    bad[2] = args[2].to(torch.bfloat16)
    with pytest.raises(TypeError, match="ze"):
        drift_rhs_and_vjp(*bad)
    bad = list(args)
    bad[10] = args[10][:4]
    with pytest.raises(ValueError, match="a must"):
        drift_rhs_and_vjp(*bad)
    bad = list(args)
    bad[7] = ()
    with pytest.raises(ValueError, match="residual block"):
        drift_rhs_and_vjp(*bad)
    bad = list(args)
    bad[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="meta"):
        drift_rhs_and_vjp(*bad)


def test_block_free_drift_is_refused():
    pair = make_pair(num_blocks=0, n_agents=16)
    with pytest.raises(ValueError, match="num_blocks >= 1"):
        make_fused_adjoint_rhs(pair.tmodel)


def _adjoint_pair_case(pair, n, num_zones, seed, rtol):
    """Loss ``sum(w ys^2)`` of ``odeint_adjoint`` over each package's fused
    pair (JAX: both Pallas kernels in interpret mode) from the same numpy
    operands, and its gradient with respect to the drift's parameters
    (flax order, kernels as JAX lays them out), x0, h and the zones."""
    from ananke_abm_tpu.ode import odeint_adjoint as jax_odeint_adjoint
    from ananke_abm_tpu_torch.ode import odeint_adjoint

    x, h, ze, _ = _operands(pair, n, num_zones, seed)
    ts = np.asarray([6.0, 6.5, 7.25, 8.0], np.float32)
    w = np.random.default_rng(seed + 1).uniform(
        0.5, 1.5, size=(len(ts), n, x.shape[1])).astype(np.float32)
    rhs_j, vjp_j = jax_make_fused_adjoint_rhs(pair.params, interpret=True)

    def jloss(p, x0, hh, zz):
        ys = jax_odeint_adjoint(rhs_j, x0, jnp.asarray(ts), (p, hh, zz),
                                rtol=rtol, atol=rtol, rhs_vjp=vjp_j)
        return jnp.sum(ys * ys * jnp.asarray(w))

    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        pair.params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(ze))
    gj = [np.asarray(v) for v in jax.tree_util.tree_leaves(gj)]
    leaves, params = _port_params(pair)
    rhs_t, vjp_t = make_fused_adjoint_rhs(pair.tmodel)
    xt, ht, zt = (t32(v).requires_grad_(True) for v in (x, h, ze))
    pair.tmodel.zero_grad()
    ys = odeint_adjoint(rhs_t, xt, torch.from_numpy(ts), (params, ht, zt),
                        rtol=rtol, atol=rtol, rhs_vjp=vjp_t)
    loss = torch.sum(ys * ys * t32(w))
    loss.backward()
    gt = [(p.grad.T if path[-1] == "kernel" else p.grad).numpy()
          for path, p in leaves] + [v.grad.numpy() for v in (xt, ht, zt)]
    return loss.item(), gt, float(lj), gj


def test_continuous_adjoint_over_the_fused_pair_matches_jax():
    """``odeint_adjoint`` with both halves of the fused pair (K8a forward,
    K8 backward; their plain versions here) against JAX's same solve at
    rtol = atol = 1e-3: loss within 1e-3 relative (read 2e-5 to 1e-4 at
    1e-3 and 1e-4 on the CPU: the bf16 stage noise of the two forwards
    moves the step controller a little), gradient cosine > 0.999 (read 1 -
    cos <= 1.6e-6)."""
    pair = make_pair(num_blocks=2, n_agents=16)
    lt, gt, lj, gj = _adjoint_pair_case(pair, 40, 12, seed=6, rtol=1e-3)
    assert abs(lt - lj) <= 1e-3 * abs(lj)
    assert _cos(gt, gj) > COS_MIN
    assert drift_rhs_fused.launches == drift_rhs_and_vjp.launches == 0


def test_drift_rhs_wrapper_on_cpu_takes_the_plain_version():
    pair = make_pair(num_blocks=2, n_agents=16)
    args = _args(pair, 21, 9)[:-1]
    got = drift_rhs_fused(*args)
    torch.testing.assert_close(got, drift_rhs_reference(*args), rtol=0,
                               atol=0)
    bad = list(args)
    bad[1] = args[1][:5]
    with pytest.raises(ValueError, match="h must"):
        drift_rhs_fused(*bad)
    assert drift_rhs_fused.launches == 0
