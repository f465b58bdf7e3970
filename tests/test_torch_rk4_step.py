"""The serving step (kernel K0) and the per-step rollout: the port's plain
version against the JAX Pallas kernel ``rk4_step_fused`` run in interpret
mode, ``make_pallas_rollout(fuse_decode=False)`` against the JAX one and
against the port's interval body, and the wrapper's CPU dispatch.

Tolerances as tests/test_torch_fused_step.py: both sides round activations
to bf16 at the same points, their float32 sums run in other orders, so now
and then one bf16 rounding lands on the other side: x_new within 2e-3.
Such a flip moves a decoded id only at a near tie: at the rollout test's
tiny widths the two packages' per-step ids agree exactly (at full width,
256 agents x 6 times, 0.998 on the CPU). The two rollouts of the port share
the same plain stage math and the same bf16 decode, so their ids agree
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair, t32
from ananke_abm_tpu.ops.pallas.fused_step import (
    make_pallas_rollout as jax_make_pallas_rollout,
)
from ananke_abm_tpu.ops.pallas.fused_step import (
    pack_weights_bf16 as jax_pack,
)
from ananke_abm_tpu.ops.pallas.fused_step import (
    rk4_step_fused as jax_rk4_step,
)
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    _per_step_body,
    make_pallas_rollout,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    interval_stage_times,
    pack_weights_bf16,
    rk4_interval_decode_reference,
    rk4_step_fused,
    rk4_step_reference,
    time_feature_table,
)

X_ATOL = 2e-3
T0, DT = np.float32(6.5), np.float32(0.125)


def _inputs(pair, n, num_zones, seed=0):
    rng = np.random.default_rng(seed)
    c = pair.jcfg
    x = rng.normal(size=(n, c.agent_dim)).astype(np.float32)
    h = rng.normal(size=(n, c.context_dim)).astype(np.float32)
    ze = rng.normal(size=(num_zones, c.zone_dim)).astype(np.float32)
    return x, h, ze


def _port_args(pair, x, h, ze, t0=T0, dt=DT):
    w = pack_weights_bf16(pair.tmodel)
    tf = time_feature_table(
        torch.from_numpy(interval_stage_times(t0, dt, 1)), w[3], w[4])
    return (t32(x), t32(h), t32(ze).to(torch.bfloat16), w, tf, float(dt))


@pytest.mark.parametrize("num_blocks,full,n,num_zones", [
    (1, False, 96, 12),
    (2, False, 96, 12),
    (2, True, 300, 64),
])
def test_step_matches_jax_interpret(num_blocks, full, n, num_zones):
    pair = make_pair(num_blocks=num_blocks, n_agents=16, full=full)
    x, h, ze = _inputs(pair, n, num_zones)
    want = np.asarray(jax_rk4_step(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(ze, jnp.bfloat16),
        jax_pack(pair.params), T0, DT, interpret=True))
    with torch.no_grad():
        got = rk4_step_reference(*_port_args(pair, x, h, ze)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= X_ATOL


def test_step_stage_times_are_the_references():
    """One substep of ``interval_stage_times`` is the reference's step
    table ``[t0, t0 + dt/2, t0 + dt/2, t0 + dt]`` in float32, and substep
    ``s`` of an interval starts at the reference's per-step ``t0 + s dt``."""
    f32 = np.float32
    for t0, dt in ((T0, DT), (f32(23.5), f32(0.25)), (f32(0.1), f32(1 / 3))):
        want = np.asarray(jnp.stack([t0, t0 + dt / 2, t0 + dt / 2, t0 + dt]))
        np.testing.assert_array_equal(interval_stage_times(t0, dt, 1), want)
        both = interval_stage_times(t0, dt, 2)
        start = np.asarray(jnp.asarray(t0) + 1 * jnp.asarray(dt))
        np.testing.assert_array_equal(both[4:],
                                      interval_stage_times(start, dt, 1))


def test_two_steps_are_the_interval_without_its_decode():
    """Two plain steps over an interval's stage rows give the plain
    interval's x bit for bit."""
    pair = make_pair(num_blocks=2, n_agents=16)
    x, h, ze = _inputs(pair, 40, 12, seed=1)
    xs, hs, zes, w, _, _ = _port_args(pair, x, h, ze)
    tf = time_feature_table(
        torch.from_numpy(interval_stage_times(T0, DT, 2)), w[3], w[4])
    wd = pair.tmodel.decode_proj.weight.T.to(torch.bfloat16)
    with torch.no_grad():
        want, _ = rk4_interval_decode_reference(xs, hs, zes, w, wd, tf,
                                                float(DT))
        got = xs
        for s in range(2):
            got = rk4_step_reference(got, hs, zes, w, tf[4 * s: 4 * s + 4],
                                     float(DT))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    pair = make_pair(num_blocks=1, n_agents=16)
    args = _port_args(pair, *_inputs(pair, 33, 7, seed=2))
    with torch.no_grad():
        got = rk4_step_fused(*args)
        want = rk4_step_reference(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rk4_step_fused.launches == 0


def test_wrapper_rejects_bad_operands():
    pair = make_pair(num_blocks=1, n_agents=16)
    x, h, ze, w, tf, dt = _port_args(pair, *_inputs(pair, 8, 5))
    with pytest.raises(ValueError, match="4 rows"):
        rk4_step_fused(x, h, ze, w, torch.cat([tf, tf]), dt)
    with pytest.raises(TypeError, match="ze"):
        rk4_step_fused(x, h, ze.float(), w, tf, dt)
    with pytest.raises(ValueError, match="h must have shape"):
        rk4_step_fused(x, h[:4], ze, w, tf, dt)
    with pytest.raises(ValueError, match="meta"):
        rk4_step_fused(x.to("meta"), h, ze, w, tf, dt)


def _jax_ids(pair, fuse_decode):
    zf, adj, times, pf, hz = pair.arrays()
    return np.asarray(jax_make_pallas_rollout(
        pair.jmodel, jnp.asarray(zf), jnp.asarray(adj), jnp.asarray(times),
        substeps=pair.jcfg.substeps, fuse_decode=fuse_decode,
    )(pair.params, jnp.asarray(pf), jnp.asarray(hz)))


def _port_ids(pair, fuse_decode):
    zf, adj, times, pf, hz = pair.tensors()
    got = make_pallas_rollout(pair.tmodel, zf, adj, times,
                              substeps=pair.tcfg.substeps,
                              fuse_decode=fuse_decode)(pf, hz)
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_per_step_rollout_matches_jax(num_blocks):
    """The per-step rollout against JAX's (Pallas K0 in interpret mode) and
    against the port's interval body on the same weights: the same ids."""
    pair = make_pair(num_blocks=num_blocks, n_agents=96, num_times=6,
                     num_zones=10)
    got = _port_ids(pair, fuse_decode=False)
    want = _jax_ids(pair, fuse_decode=False)
    assert got.shape == want.shape == (96, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_ids(pair, fuse_decode=True))
    assert rk4_step_fused.launches == 0


def test_per_step_body_is_the_plain_step():
    """On CPU tensors the rollout's step is the plain version."""
    pair = make_pair(num_blocks=2, n_agents=48, num_times=4)
    args = pair.tensors()
    got = make_pallas_rollout(pair.tmodel, *args[:3],
                              substeps=pair.tcfg.substeps)(*args[3:])
    with torch.inference_mode():
        want = _per_step_body(pair.tmodel, pair.tcfg.substeps,
                              rk4_step_reference)(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_per_step_rollout_sees_updated_params_and_refuses_a_mesh():
    pair = make_pair(num_blocks=1, n_agents=32, num_times=4)
    zf, adj, times, pf, hz = pair.tensors()
    rollout = make_pallas_rollout(pair.tmodel, zf, adj, times)
    out0 = rollout(pf, hz)
    with torch.no_grad():
        for p in pair.tmodel.parameters():
            p.add_(0.5)
    assert (rollout(pf, hz) != out0).any()
    with pytest.raises(NotImplementedError, match="item 11"):
        make_pallas_rollout(pair.tmodel, zf, adj, times, mesh=object())
