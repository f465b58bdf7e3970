"""The CUDA kernels against their plain versions, on the card: the
serving interval (K1) and the adjoint RHS (K8) with the trainer around it.

Marked ``cuda``: every test here skips on a host without a CUDA device.
On a card without JAX installed, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax; this file needs neither it nor the JAX package).
Kernel and plain version round at the same points; their float32 sums
run in different orders, so now and then a value rounds the other way.
The bounds are chip_smoke.py's, set from H100 readings (PERF.md).
"""
import pytest
import torch

from ananke_abm_tpu_torch.data_generator import generate_agent_population
from ananke_abm_tpu_torch.models.gnn_embed.params import flax_leaf_params
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    _kernel_body,
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    _adjoint_loss_fn,
    build_model,
    init_params,
    make_adjoint_step_fns,
)
from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
    drift_rhs_and_vjp,
    drift_rhs_and_vjp_reference,
    drift_rhs_fused,
    make_fused_adjoint_rhs,
    split_drift_params,
    time_row,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    interval_stage_times,
    pack_weights_bf16,
    rk4_interval_decode_fused,
    rk4_interval_decode_reference,
    time_feature_table,
)

pytestmark = pytest.mark.cuda

X_MEAN_ATOL = 1e-4
X_MAX_RTOL = 2e-3
IDS_MIN = 0.999
# a whole rollout: an id flipped in one interval carries into later ones
ROLLOUT_IDS_MIN = 0.995
# K8 against its plain version, per output: mean |d| / mean |ref|, max |d|
# / max |ref|, 1 - cosine, for 2 residual blocks and scaled by
# (2 + blocks) / 4: bf16 flips compound through the blocks (chip_smoke.py's
# k8_bounds)
K8_REL_MEAN = 3e-3
K8_REL_MAX = 1e-2
K8_ONE_MINUS_COS = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _model(cuda, num_blocks):
    model = build_model(GATODEConfig(num_blocks=num_blocks), 7, 8,
                        device=cuda)
    init_params(model, torch.Generator().manual_seed(num_blocks))
    return model


def _operands(model, cuda, n, num_zones, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, 32, device=cuda, generator=g)
    h = torch.randn(n, 32, device=cuda, generator=g)
    ze = torch.randn(num_zones, 64, device=cuda, generator=g).bfloat16()
    w = pack_weights_bf16(model)
    wd = model.decode_proj.weight.T.bfloat16()
    stage_t = torch.from_numpy(interval_stage_times(6.5, 0.25, 2)).to(cuda)
    return x, h, ze, w, wd, time_feature_table(stage_t, w[3], w[4]), 0.25


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (65_536, 64, 2), (1_000, 500, 1), (4_096, 2_048, 2), (17, 5, 3),
])
def test_kernel_matches_plain_version(cuda, n, num_zones, num_blocks):
    ops = _operands(_model(cuda, num_blocks), cuda, n, num_zones)
    with torch.inference_mode():
        before = rk4_interval_decode_fused.launches
        xk, ik = rk4_interval_decode_fused(*ops)
        torch.cuda.synchronize()
        assert rk4_interval_decode_fused.launches == before + 1
        xr, ir = rk4_interval_decode_reference(*ops)
    assert torch.isfinite(xk).all()
    d = (xk - xr).abs()
    assert d.mean().item() <= X_MEAN_ATOL
    assert d.max().item() <= X_MAX_RTOL * xr.abs().max().item()
    assert (ik == ir).float().mean().item() >= IDS_MIN
    assert 0 <= ik.min().item() and ik.max().item() < num_zones


def test_kernel_rollout_matches_plain_rollout(cuda):
    config = GATODEConfig()
    d = generate_agent_population(4_096, num_times=12, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    args = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    agents = (on(d["person_feats"]), on(d["home_zone"], torch.long))
    before = rk4_interval_decode_fused.launches
    got = make_decoded_rollout(model, config, *args)(*agents)
    assert rk4_interval_decode_fused.launches == before + 11
    with torch.inference_mode():
        want = _kernel_body(model, config.substeps,
                            rk4_interval_decode_reference)(*args, *agents)
    assert got.shape == (4_096, 12)
    assert (got == want).float().mean().item() >= ROLLOUT_IDS_MIN


@pytest.mark.parametrize("change,match", [
    ({"hidden_dim": 64}, "compiled for"), ({"num_blocks": 9}, "at most"),
])
def test_auto_rollout_raises_where_the_kernel_cannot_serve(cuda, change,
                                                          match):
    """``use_kernel="auto"`` on the card never moves to the float32 body:
    a configuration the kernel is not compiled for raises."""
    config = GATODEConfig(**change)
    d = generate_agent_population(64, num_times=3, num_zones=8, seed=0)
    model = build_model(config, d["zone_features"].shape[-1],
                        d["person_feats"].shape[-1], device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    rollout = make_decoded_rollout(model, config, on(d["zone_features"]),
                                   on(d["adj"]), on(d["times"]))
    with pytest.raises(ValueError, match=match):
        rollout(on(d["person_feats"]), on(d["home_zone"], torch.long))


def test_kernel_rejects_widths_it_is_not_compiled_for(cuda):
    config = GATODEConfig(hidden_dim=64)
    model = build_model(config, 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    w = pack_weights_bf16(model)
    x = torch.zeros(16, 32, device=cuda)
    ze = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    tf = torch.zeros(8, 64, device=cuda)
    wd = model.decode_proj.weight.T.bfloat16()
    with pytest.raises(ValueError, match="compiled for"):
        rk4_interval_decode_fused(x, x.clone(), ze, w, wd, tf, 0.1)


def _k8_args(model, n, num_zones, cuda, seed=0):
    with torch.no_grad():
        (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = split_drift_params(
            dict(flax_leaf_params(model)))
        g = torch.Generator(device=cuda).manual_seed(seed)
        x, h, a = (torch.randn(n, 32, device=cuda, generator=g)
                   for _ in range(3))
        ze = torch.randn(num_zones, 64, device=cuda, generator=g)
        d = lambda w: w.detach()
        return (x, h, ze, time_row(7.3, d(W1t), d(b1)), d(Wq), d(W1xc),
                d(W1h), tuple(tuple(d(w) for w in b) for b in blocks),
                d(W3), d(b3), a)


def _k8_flat(out):
    return [*out[:8], *[w for b in out[8] for w in b], out[9], out[10]]


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (4_096, 64, 2), (1_000, 500, 1), (4_096, 2_048, 2), (17, 5, 1),
    (200, 64, 8),
])
def test_adjoint_kernel_matches_plain_version(cuda, n, num_zones,
                                              num_blocks):
    """Every output within the bounds, and a repeat on the same operands
    gives the same bits (the sums over agents run in a fixed order)."""
    args = _k8_args(_model(cuda, num_blocks), n, num_zones, cuda)
    with torch.inference_mode():
        before = drift_rhs_and_vjp.launches
        got = drift_rhs_and_vjp(*args)
        again = drift_rhs_and_vjp(*args)
        torch.cuda.synchronize()
        assert drift_rhs_and_vjp.launches == before + 2
        want = drift_rhs_and_vjp_reference(*args)
    depth = (2 + num_blocks) / 4
    for u, u2, v in zip(_k8_flat(got), _k8_flat(again), _k8_flat(want)):
        assert torch.equal(u, u2)
        assert torch.isfinite(u).all()
        d = (u - v).abs()
        assert d.mean() <= K8_REL_MEAN * depth * v.abs().mean()
        assert d.max() <= K8_REL_MAX * depth * v.abs().max()
        cos = torch.dot(u.flatten().double(), v.flatten().double()) / (
            u.double().norm() * v.double().norm())
        assert 1 - cos <= K8_ONE_MINUS_COS * depth


def test_adjoint_trainer_runs_its_backward_through_the_kernel(cuda):
    """use_fused="auto" on the card: 2 + 6 x (attempted steps) launches per
    backward interval, and the gradient of the plain-version trainer."""
    config = GATODEConfig(method="dopri5")
    d = generate_agent_population(1_024, num_times=5, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    _, loss_fn = make_adjoint_step_fns(model, None, config, static)
    before = drift_rhs_and_vjp.launches
    loss, _ = loss_fn(*batch)
    loss.backward()
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    want = sum(2 + 6 * s["n_steps"] for s in loss_fn.stats["backward"])
    assert drift_rhs_and_vjp.launches - before == want
    plain = _adjoint_loss_fn(
        model, config,
        make_fused_adjoint_rhs(model, drift_rhs_and_vjp_reference)[1])
    model.zero_grad()
    loss_p, _ = plain(*batch, static)
    loss_p.backward()
    grads_p = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert abs(loss.item() - loss_p.item()) <= 2e-3 * abs(loss_p.item())
    cos = torch.dot(grads.double(), grads_p.double()) / (
        grads.double().norm() * grads_p.double().norm())
    assert cos > 0.999


@pytest.mark.parametrize("change,match", [
    ({"hidden_dim": 64}, "compiled for"), ({"num_blocks": 9}, "at most"),
])
def test_auto_adjoint_raises_where_the_kernel_cannot_serve(cuda, change,
                                                           match):
    """``use_fused="auto"`` on the card never moves to the plain version:
    a configuration the kernel is not compiled for raises."""
    config = GATODEConfig(method="dopri5", **change)
    d = generate_agent_population(64, num_times=3, num_zones=8, seed=0)
    model = build_model(config, d["zone_features"].shape[-1],
                        d["person_feats"].shape[-1], device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    _, loss_fn = make_adjoint_step_fns(
        model, None, config,
        (on(d["zone_features"]), on(d["adj"]), on(d["times"])))
    loss, _ = loss_fn(on(d["person_feats"]), on(d["home_zone"], torch.long),
                      on(d["zone_ids"], torch.long))
    with pytest.raises(ValueError, match=match):
        loss.backward()


def test_drift_rhs_fused_has_no_cuda_kernel_yet(cuda):
    args = _k8_args(_model(cuda, 1), 16, 8, cuda)
    with pytest.raises(NotImplementedError, match="queue 2"):
        drift_rhs_fused(*args[:-1])
