"""The serving interval (kernel K1): the port's plain version against the
JAX Pallas kernel run in interpret mode, and the wrapper's CPU dispatch.

Tolerances: both sides round activations to bf16 at the same points, but
their float32 sums run in different orders, so now and then one bf16
rounding of an activation lands on the other side — a bf16 ulp (2^-8
relative) in a drift term, ~1e-3 in x after an interval (8.5e-4 measured
at full width). Hence x_new within 2e-3 and decode ids >= 99.5% equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import agreement, make_pair, t32
from ananke_abm_tpu.ops.pallas.fused_step import (
    _time_feature_table as jax_time_feature_table,
)
from ananke_abm_tpu.ops.pallas.fused_step import (
    pack_weights_bf16 as jax_pack,
)
from ananke_abm_tpu.ops.pallas.fused_step import (
    rk4_interval_decode_fused as jax_interval,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    interval_stage_times,
    pack_weights_bf16,
    rk4_interval_decode_fused,
    rk4_interval_decode_reference,
    time_feature_table,
)

X_ATOL = 2e-3
IDS_MIN = 0.995
T0, DT, SUBSTEPS = np.float32(6.5), np.float32(0.25), 2


def _inputs(pair, n, num_zones, seed=0, ze_scale=1.0):
    rng = np.random.default_rng(seed)
    c = pair.jcfg
    x = rng.normal(size=(n, c.agent_dim)).astype(np.float32)
    h = rng.normal(size=(n, c.context_dim)).astype(np.float32)
    ze = (rng.normal(size=(num_zones, c.zone_dim)) * ze_scale).astype(
        np.float32)
    return x, h, ze


def _jax(pair, x, h, ze):
    wd = jnp.asarray(pair.params["decode_proj"]["kernel"], jnp.bfloat16)
    x_new, ids = jax_interval(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(ze, jnp.bfloat16),
        jax_pack(pair.params), wd, T0, DT, SUBSTEPS, interpret=True,
    )
    return np.asarray(x_new), np.asarray(ids)


def _port(pair, x, h, ze, fn=rk4_interval_decode_reference):
    w = pack_weights_bf16(pair.tmodel)
    wd = pair.tmodel.decode_proj.weight.T.to(torch.bfloat16)
    tf = time_feature_table(
        torch.from_numpy(interval_stage_times(T0, DT, SUBSTEPS)), w[3], w[4]
    )
    with torch.no_grad():
        x_new, ids = fn(t32(x), t32(h), t32(ze).to(torch.bfloat16), w, wd,
                        tf, float(DT))
    return x_new.numpy(), ids.numpy()


@pytest.mark.parametrize("num_blocks,full,n,num_zones", [
    (1, False, 96, 12),
    (2, False, 96, 12),
    (2, True, 512, 64),
])
def test_interval_matches_jax_interpret(num_blocks, full, n, num_zones):
    pair = make_pair(num_blocks=num_blocks, n_agents=16, full=full)
    x, h, ze = _inputs(pair, n, num_zones)
    xj, idj = _jax(pair, x, h, ze)
    xt, idt = _port(pair, x, h, ze)
    assert xt.dtype == np.float32 and idt.dtype == np.int32
    assert np.abs(xt - xj).max() <= X_ATOL
    assert agreement(idt, idj) >= IDS_MIN


def test_interval_tied_logits_pick_the_first_zone():
    """Zones 12..23 duplicate zones 0..11: every logit has an exact twin,
    so only the first-index rule decides, on both sides."""
    pair = make_pair(num_blocks=1, n_agents=16)
    x, h, ze = _inputs(pair, 96, 12, seed=1)
    ze = np.concatenate([ze, ze])
    xj, idj = _jax(pair, x, h, ze)
    xt, idt = _port(pair, x, h, ze)
    assert idt.max() < 12 and idj.max() < 12
    assert agreement(idt, idj) >= IDS_MIN
    assert np.abs(xt - xj).max() <= X_ATOL


def test_interval_clamps_scores_above_80():
    pair = make_pair(num_blocks=2, n_agents=16)
    x, h, ze = _inputs(pair, 96, 12, seed=2, ze_scale=60.0)
    # the first stage's attention scores already exceed the clamp
    wq = np.asarray(pair.params["query_proj"]["kernel"])
    scores = (x @ wq) @ ze.T / np.sqrt(ze.shape[1])
    assert scores.max() > 80.0
    xj, idj = _jax(pair, x, h, ze)
    xt, idt = _port(pair, x, h, ze)
    assert np.isfinite(xt).all() and np.isfinite(xj).all()
    assert np.abs(xt - xj).max() <= X_ATOL
    assert agreement(idt, idj) >= IDS_MIN


def test_time_feature_table_matches_jax():
    pair = make_pair(num_blocks=2, n_agents=16, full=True)
    stage_t = interval_stage_times(np.float32(23.5), np.float32(0.25), 2)
    want = jax_time_feature_table(jnp.asarray(stage_t),
                                  *jax_pack(pair.params)[3:5])
    w = pack_weights_bf16(pair.tmodel)
    got = time_feature_table(torch.from_numpy(stage_t), w[3], w[4])
    assert tuple(got.shape) == (8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_interval_stage_times_follow_the_reference():
    t0, dt = np.float32(11.2), np.float32(1.0 / 3.0)
    # the reference's expression (fused_step.py rk4_interval_decode_fused)
    sub = t0 + dt * jnp.arange(3)
    offs = jnp.asarray([0.0, 0.5, 0.5, 1.0]) * dt
    want = np.asarray((sub[:, None] + offs[None, :]).reshape(-1))
    got = interval_stage_times(t0, dt, 3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    pair = make_pair(num_blocks=2, n_agents=16)
    x, h, ze = _inputs(pair, 40, 12)
    before = rk4_interval_decode_fused.launches
    xf, idf = _port(pair, x, h, ze, fn=rk4_interval_decode_fused)
    xr, idr = _port(pair, x, h, ze)
    np.testing.assert_array_equal(xf, xr)
    np.testing.assert_array_equal(idf, idr)
    assert rk4_interval_decode_fused.launches == before == 0


def test_wrapper_rejects_bad_operands():
    pair = make_pair(num_blocks=1, n_agents=16)
    x, h, ze = (t32(a) for a in _inputs(pair, 8, 12))
    w = pack_weights_bf16(pair.tmodel)
    wd = pair.tmodel.decode_proj.weight.T.to(torch.bfloat16)
    ze16 = ze.to(torch.bfloat16)
    tf = torch.zeros(8, pair.tcfg.hidden_dim)
    fn = rk4_interval_decode_fused
    fn(x, h, ze16, w, wd, tf, 0.1)  # well-formed
    with pytest.raises(TypeError, match="ze"):
        fn(x, h, ze, w, wd, tf, 0.1)
    with pytest.raises(TypeError, match="x"):
        fn(x.double(), h, ze16, w, wd, tf, 0.1)
    with pytest.raises(ValueError, match="h"):
        fn(x, h[:4], ze16, w, wd, tf, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(x.shape[::-1]).T, h, ze16, w, wd, tf, 0.1)
    with pytest.raises(ValueError, match="substeps"):
        fn(x, h, ze16, w, wd, tf[:6], 0.1)
    with pytest.raises(ValueError, match="meta"):
        fn(x.to("meta"), h, ze16, w, wd, tf, 0.1)
