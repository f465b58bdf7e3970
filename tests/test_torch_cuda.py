"""The CUDA kernels against their plain versions, on the card: the
serving interval (K1) and step (K0) with the per-step rollout, the adjoint
RHS (K8) and the drift alone (K8a) with the trainer and the fused pair
around them, the training-day kernels (K2f, K2b, K3f, K3b) and the
zone-encoder kernels (K4f, K4b) with the fixed-step trainer and
``train()``, the DOPRI5 kernels (K5 and K7 at float32 and bf16, K6) with
the discrete-adjoint trainer and a bf16 forward, the CSR edge kernels with
``train(sparse_world=True)``, and the segment sum (K9e); and, card against
CPU, the plain-PyTorch paths of the schedule VAE (a step, the CRF), of
the traj_syn family (the semi-CRF, a traj_embed step) and of the
trajectory ODE families (a latent_ode step over 2,401 Euler-Maruyama
steps, a mode_sep RK4 step).

Marked ``cuda``: every test here skips on a host without a CUDA device.
On a card without JAX installed, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax; this file needs neither it nor the JAX package).
Kernel and plain version round at the same points; their float32 sums
run in different orders, so now and then a value rounds the other way.
The bounds are chip_smoke.py's, set from H100 readings (PERF.md).
"""
import numpy as np
import pytest
import torch

from ananke_abm_tpu_torch.data_generator import generate_agent_population
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    _kernel_body,
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    _adjoint_loss_fn,
    build_adjoint_loss_fn_g,
    build_fused_loss_fn,
    build_model,
    init_params,
    make_adjoint_step_fns,
    make_fused_train_step,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import train
from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
from ananke_abm_tpu_torch.ops.cuda.checks import (
    CE_BOUNDS,
    CE_CORRECT_MIN,
    DAY_BWD_BOUNDS,
    DAY_FWD_BOUNDS,
    EDGE_BWD_BOUNDS,
    EDGE_FWD_BOUNDS,
    EDGE_HUB_SHAPE,
    GAT_BWD_BOUNDS,
    GAT_FWD_BOUNDS,
    SERVING_EDGE_SHAPES,
    SERVING_WITNESS_RATIO,
    WITNESS_BWD_BOUNDS,
    bf16_control,
    bf16_features,
    day_bounds,
    day_operands,
    edge_operands,
    float64_witness,
    gat_grad_outputs,
    gat_operands,
    k8_bounds,
    k8_operands,
    kernel_kink_sides,
    on_kernel_sides,
    tf32_control,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
    drift_rhs_and_vjp,
    drift_rhs_and_vjp_reference,
    drift_rhs_fused,
    drift_rhs_reference,
    make_fused_adjoint_rhs,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    interval_stage_times,
    pack_weights_bf16,
    rk4_interval_decode_fused,
    rk4_interval_decode_reference,
    rk4_step_fused,
    rk4_step_reference,
    time_feature_table,
)

pytestmark = pytest.mark.cuda

X_MEAN_ATOL = 1e-4
X_MAX_RTOL = 2e-3
IDS_MIN = 0.999
# a whole rollout: an id flipped in one interval carries into later ones
ROLLOUT_IDS_MIN = 0.995


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
    (3_001, 300, 4),
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
    """Where K1 is not compiled for the configuration, ``use_kernel="auto"``
    on the card serves through the float32 body, as the reference's
    ``_pallas_eligible`` sends it to its XLA body: no K1 launch, and the
    float32 body's ids. ``use_kernel=True`` still raises."""
    config = GATODEConfig(**change)
    d = generate_agent_population(64, num_times=3, num_zones=8, seed=0)
    model = build_model(config, d["zone_features"].shape[-1],
                        d["person_feats"].shape[-1], device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    graph = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    agents = (on(d["person_feats"]), on(d["home_zone"], torch.long))
    before = rk4_interval_decode_fused.launches
    auto = make_decoded_rollout(model, config, *graph)(*agents)
    f32 = make_decoded_rollout(model, config, *graph,
                               use_kernel=False)(*agents)
    assert rk4_interval_decode_fused.launches == before
    assert torch.equal(auto, f32)
    with pytest.raises(ValueError, match=match):
        make_decoded_rollout(model, config, *graph,
                             use_kernel=True)(*agents)
    assert rk4_interval_decode_fused.launches == before


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


def _readings(u, v):
    """(mean |d| / mean |ref|, max |d| / max |ref|, 1 - cosine) of ``u``
    against the reference ``v``; 0 each where they are equal (a reference
    of zeros, as a_src's gradient at one zone, would read 0 / 0)."""
    if torch.equal(u, v):
        return 0.0, 0.0, 0.0
    u, v = u.double(), v.double()
    d = (u - v).abs()
    cos = torch.dot(u.flatten(), v.flatten()) / (u.norm() * v.norm())
    return ((d.mean() / v.abs().mean()).item(),
            (d.max() / v.abs().max()).item(), (1 - cos).item())


def _within(got, want, bounds):
    return all(r <= b for u, v in zip(got, want)
               for r, b in zip(_readings(u, v), bounds))


def _assert_close(got, want, bounds):
    """Per output: mean |d| / mean |ref|, max |d| / max |ref| and 1 -
    cosine within ``bounds`` (``ops/cuda/checks.py``)."""
    for u, v in zip(got, want):
        assert torch.isfinite(u).all()
        assert all(r <= b for r, b in zip(_readings(u, v), bounds)), (
            _readings(u, v), bounds)


def _k8_flat(out):
    return [*out[:8], *[w for b in out[8] for w in b], out[9], out[10]]


# K8's tile heights (96 rows up to 2 blocks, 64 up to 5, 32 beyond) at
# 1,000 rows, which no tile divides; zones ending half-way into the ring's
# last 32-zone box (Z = 40, 72, 8: zp = 48, 80, 16) with a last tile of
# one row
RHS_TILE_CASES = [(1_000, z, nb) for nb in (1, 2, 5, 8)
                  for z in (64, 500, 2_048)]
RAGGED_CASES = [(97, 40, 2), (65, 72, 3), (33, 8, 8)]


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (4_096, 64, 2), (4_096, 2_048, 2), (17, 5, 1), (200, 64, 8),
    *RHS_TILE_CASES, *RAGGED_CASES,
])
def test_adjoint_kernel_matches_plain_version(cuda, n, num_zones,
                                              num_blocks):
    """Every output within the bounds, and a repeat on the same operands
    gives the same bits (the sums over agents run in a fixed order)."""
    args = k8_operands(_model(cuda, num_blocks), n, num_zones, cuda, seed=0)
    with torch.inference_mode():
        before = drift_rhs_and_vjp.launches
        got = drift_rhs_and_vjp(*args)
        again = drift_rhs_and_vjp(*args)
        torch.cuda.synchronize()
        assert drift_rhs_and_vjp.launches == before + 2
        want = drift_rhs_and_vjp_reference(*args)
    assert all(torch.equal(u, v) for u, v in zip(_k8_flat(got),
                                                 _k8_flat(again)))
    _assert_close(_k8_flat(got), _k8_flat(want), k8_bounds(num_blocks))


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
    """``use_fused="auto"`` chooses from the configuration before anything
    launches: where the kernel is not compiled for it, the plain route
    trains with no launch; ``use_fused=True`` there raises from the
    kernel's wrapper, never moving to the plain version."""
    config = GATODEConfig(method="dopri5", **change)
    d = generate_agent_population(64, num_times=3, num_zones=8, seed=0)
    model = build_model(config, d["zone_features"].shape[-1],
                        d["person_feats"].shape[-1], device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    before = drift_rhs_and_vjp.launches
    _, loss_fn = make_adjoint_step_fns(model, None, config, static)
    loss, _ = loss_fn(*batch)
    loss.backward()
    assert drift_rhs_and_vjp.launches == before
    _, loss_fn = make_adjoint_step_fns(model, None, config, static,
                                       use_fused=True)
    loss, _ = loss_fn(*batch)
    with pytest.raises(ValueError, match=match):
        loss.backward()


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (4_096, 64, 2), (17, 5, 1), (200, 64, 8), *RHS_TILE_CASES,
])
def test_drift_rhs_fused_matches_plain_version(cuda, n, num_zones,
                                               num_blocks):
    """K8a: f within k8_bounds' bounds, the same bits on a repeat."""
    args = k8_operands(_model(cuda, num_blocks), n, num_zones, cuda,
                       seed=n)[:-1]
    with torch.inference_mode():
        before = drift_rhs_fused.launches
        got = drift_rhs_fused(*args)
        again = drift_rhs_fused(*args)
        torch.cuda.synchronize()
        assert drift_rhs_fused.launches == before + 2
        want = drift_rhs_reference(*args)
    assert torch.equal(got, again)
    _assert_close([got], [want], k8_bounds(num_blocks))


def test_drift_rhs_fused_rejects_what_it_is_not_compiled_for(cuda):
    args = list(k8_operands(_model(cuda, 1), 16, 8, cuda, seed=0)[:-1])
    before = drift_rhs_fused.launches
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="h is on cpu"):
        drift_rhs_fused(*bad)
    bad = list(args)
    bad[2] = args[2].bfloat16()
    with pytest.raises(TypeError, match="ze"):
        drift_rhs_fused(*bad)
    model = build_model(GATODEConfig(hidden_dim=64), 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="compiled for"):
        drift_rhs_fused(*k8_operands(model, 16, 8, cuda, seed=0)[:-1])
    assert drift_rhs_fused.launches == before


def test_continuous_adjoint_over_the_fused_pair_runs_both_kernels(cuda):
    """``odeint_adjoint`` with both halves of ``make_fused_adjoint_rhs`` at
    rtol = atol = 1e-3: K8a once per forward evaluation (2 + 6 x attempted
    steps), K8 as the trainer launches it; the loss and gradient of the
    same pair on the plain versions (loss rel 2e-3, cosine > 0.999), and of
    the trainer's route (``model.rhs`` forward in float32, K8 backward):
    its forward rounds to bf16 where that one does not, a model apart by
    the bf16 rounding (chip_smoke.py's FUSED_PAIR_LOSS_RTOL, cosine >
    0.999)."""
    config = GATODEConfig(method="dopri5", rtol=1e-3, atol=1e-3)
    d = generate_agent_population(1_024, num_times=5, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    stats = {}
    loss_fn = _adjoint_loss_fn(model, config,
                               make_fused_adjoint_rhs(model)[1], stats,
                               rhs=make_fused_adjoint_rhs(model)[0])
    before = (drift_rhs_fused.launches, drift_rhs_and_vjp.launches)
    loss, _ = loss_fn(*batch, static)
    loss.backward()
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert drift_rhs_fused.launches - before[0] == \
        2 + 6 * stats["forward"]["n_steps"]
    assert drift_rhs_and_vjp.launches - before[1] == sum(
        2 + 6 * s["n_steps"] for s in stats["backward"])
    plain_rhs, plain_vjp = make_fused_adjoint_rhs(
        model, drift_rhs_and_vjp_reference, drift_rhs_reference)
    for (fwd, vjp), rtol in (((plain_rhs, plain_vjp), 2e-3),
                             ((None, make_fused_adjoint_rhs(model)[1]),
                              1e-2)):
        model.zero_grad()
        loss_r, _ = _adjoint_loss_fn(model, config, vjp, rhs=fwd)(*batch,
                                                                   static)
        loss_r.backward()
        grads_r = torch.cat([p.grad.flatten() for p in model.parameters()])
        assert abs(loss.item() - loss_r.item()) <= rtol * abs(loss_r.item())
        cos = torch.dot(grads.double(), grads_r.double()) / (
            grads.double().norm() * grads_r.double().norm())
        assert cos > 0.999


def _day_args(cuda, n, num_zones, num_blocks, num_times):
    model = _model(cuda, num_blocks)
    args = day_operands(model, n, num_zones, num_times, 2, cuda, seed=n)
    return model, args, torch.Generator(device=cuda).manual_seed(n + 1)


def _flat_day(out):
    return [*out[:7], *[w for b in out[7] for w in b], out[8], out[9]]


@pytest.mark.parametrize("n,num_zones,num_blocks,num_times", [
    (1_000, 64, 1, 5), (4_096, 500, 2, 4), (70, 5, 3, 3), (4_096, 64, 8, 5),
    # K2b's tiles of 96 rows (up to 2 blocks), 64 (up to 5) and 32: ragged
    # row counts, and more tiles than CTAs (the weight ring carried from a
    # CTA's tile into its next)
    (1_001, 500, 1, 3), (203, 2_048, 2, 3), (13_001, 40, 2, 3),
    (9_001, 40, 4, 3), (5_003, 64, 8, 3), (333, 2_048, 4, 2),
])
def test_day_kernels_match_plain_versions(cuda, n, num_zones, num_blocks,
                                          num_times):
    """K2f and K2b within the bounds; K2b twice gives the same bits."""
    _, args, g = _day_args(cuda, n, num_zones, num_blocks, num_times)
    with torch.inference_mode():
        before = (ft.day_forward_fused.launches,
                  ft.day_backward_fused.launches)
        xs = ft.day_forward_fused(*args)
        xs_ref = ft.day_forward_reference(*args)
        gxs = torch.randn(xs_ref.shape, device=cuda, generator=g)
        bargs = (xs_ref, gxs, *args[1:])
        got = _flat_day(ft.day_backward_fused(*bargs))
        again = _flat_day(ft.day_backward_fused(*bargs))
        torch.cuda.synchronize()
        assert (ft.day_forward_fused.launches,
                ft.day_backward_fused.launches) == (before[0] + 1,
                                                    before[1] + 2)
        want = _flat_day(ft.day_backward_reference(*bargs))
    assert xs.shape == (2 * (num_times - 1) + 1, n, 32)
    _assert_close([xs], [xs_ref], day_bounds(DAY_FWD_BOUNDS, num_blocks))
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _assert_close(got, want, day_bounds(DAY_BWD_BOUNDS, num_blocks))


@pytest.mark.parametrize("n,num_zones,num_blocks,num_times", [
    (200, 64, 8, 3), (201, 64, 8, 3), (233, 40, 8, 3), (150, 64, 7, 3),
])
def test_day_backward_kernel_against_a_float64_witness(cuda, n, num_zones,
                                                       num_blocks, num_times):
    """chip_smoke.py's WITNESS_SHAPES (the first, 200 agents and 8 blocks,
    where kernel and plain version read farther apart than DAY_BWD_BOUNDS
    allow): each lies within WITNESS_BWD_BOUNDS of the float64 witness, and
    the bf16-product control does not."""
    _, args, g = _day_args(cuda, n, num_zones, num_blocks, num_times)
    with torch.inference_mode():
        xs = ft.day_forward_reference(*args)
        gxs = torch.randn(xs.shape, device=cuda, generator=g)
        bargs = (xs, gxs, *args[1:])
        got = _flat_day(ft.day_backward_fused(*bargs))
        torch.cuda.synchronize()
        plain = _flat_day(ft.day_backward_reference(*bargs))
        control = _flat_day(bf16_control(ft.day_backward_reference, *bargs))
        witness = _flat_day(float64_witness(ft.day_backward_reference,
                                            *bargs))
    _assert_close(got, witness, WITNESS_BWD_BOUNDS)
    _assert_close(plain, witness, WITNESS_BWD_BOUNDS)
    assert not _within(control, witness, WITNESS_BWD_BOUNDS)


@pytest.mark.parametrize("m,num_zones", [(5_000, 64), (16_384, 500),
                                         (210, 5), (4_096, 2_048)])
def test_ce_kernels_match_plain_versions(cuda, m, num_zones):
    """K3f and K3b within the bounds; K3b twice gives the same bits."""
    model = _model(cuda, 1)
    g = torch.Generator(device=cuda).manual_seed(m)
    rows = torch.randn(m, 32, device=cuda, generator=g)
    tgt = torch.randint(0, num_zones, (m,), device=cuda, generator=g,
                        dtype=torch.int32)
    ze = torch.randn(num_zones, 64, device=cuda, generator=g).bfloat16()
    wd = model.decode_proj.weight.T.detach().bfloat16()
    gnll = torch.rand(m, device=cuda, generator=g)
    with torch.inference_mode():
        nll, corr = ft.ce_forward_fused(rows, tgt, wd, ze)
        got = ft.ce_backward_fused(rows, tgt, wd, ze, gnll)
        again = ft.ce_backward_fused(rows, tgt, wd, ze, gnll)
        torch.cuda.synchronize()
        nll_ref, corr_ref = ft.ce_forward_reference(rows, tgt, wd, ze)
        want = ft.ce_backward_reference(rows, tgt, wd, ze, gnll)
    assert (corr == corr_ref).float().mean() >= CE_CORRECT_MIN
    _assert_close([nll], [nll_ref], CE_BOUNDS)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _assert_close(got, want, CE_BOUNDS)


@pytest.mark.parametrize("num_zones", [1, 31, 500, 577, 2_048])
def test_ce_forward_kernel_at_ragged_tiles_boxes_and_ties(cuda, num_zones):
    """K3f on K3b's ring at 1,000 rows (no 128-row tile divides them) and
    zone counts that fill one box in part (1, 31), end in a part box (500,
    577) or fill many (2,048): nll within CE_BOUNDS of its plain version,
    the flags within CE_CORRECT_MIN, both the same bits on a repeat. With
    every zone the same every logit ties at the max: the flag is the first
    index's, correct exactly where the target is zone 0."""
    m = 1_000
    model = _model(cuda, 1)
    g = torch.Generator(device=cuda).manual_seed(num_zones)
    rows = torch.randn(m, 32, device=cuda, generator=g)
    tgt = torch.randint(0, num_zones, (m,), device=cuda, generator=g,
                        dtype=torch.int32)
    ze = torch.randn(num_zones, 64, device=cuda, generator=g).bfloat16()
    tied = ze[:1].expand(num_zones, 64).contiguous()
    wd = model.decode_proj.weight.T.detach().bfloat16()
    with torch.inference_mode():
        before = ft.ce_forward_fused.launches
        got = ft.ce_forward_fused(rows, tgt, wd, ze)
        again = ft.ce_forward_fused(rows, tgt, wd, ze)
        tie = ft.ce_forward_fused(rows, tgt, wd, tied)
        torch.cuda.synchronize()
        want = ft.ce_forward_reference(rows, tgt, wd, ze)
        tie_want = ft.ce_forward_reference(rows, tgt, wd, tied)
    assert ft.ce_forward_fused.launches == before + 3
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert (got[1] == want[1]).float().mean() >= CE_CORRECT_MIN
    assert torch.equal(tie[1], (tgt == 0).to(torch.int32))
    assert torch.equal(tie_want[1], tie[1])
    if num_zones == 1:  # one zone: every nll is log(1) + l - l
        assert (got[0] == 0).all() and (tie[0] == 0).all()
    else:
        _assert_close([got[0], tie[0]], [want[0], tie_want[0]], CE_BOUNDS)


@pytest.mark.parametrize("m,num_zones", [(20_000, 500), (3_000, 700)])
def test_ce_backward_inside_and_past_its_resident_zones(cuda, m, num_zones):
    """K3b keeps gze in shared memory for as many zones as fit beside its
    tiles (576) and sends the zones past them to its slab box by box: at
    rung 2's Z = 500 and at Z = 700 within CE_BOUNDS of its plain version,
    the same bits on a repeat, the bf16-product control outside."""
    model = _model(cuda, 1)
    g = torch.Generator(device=cuda).manual_seed(m)
    rows = torch.randn(m, 32, device=cuda, generator=g)
    tgt = torch.randint(0, num_zones, (m,), device=cuda, generator=g,
                        dtype=torch.int32)
    ze = torch.randn(num_zones, 64, device=cuda, generator=g).bfloat16()
    wd = model.decode_proj.weight.T.detach().bfloat16()
    gnll = torch.rand(m, device=cuda, generator=g) / m
    args = (rows, tgt, wd, ze, gnll)
    with torch.inference_mode():
        got = ft.ce_backward_fused(*args)
        again = ft.ce_backward_fused(*args)
        torch.cuda.synchronize()
        want = ft.ce_backward_reference(*args)
        control = bf16_control(ft.ce_backward_reference, *args)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _assert_close(got, want, CE_BOUNDS)
    assert not _within(control, want, CE_BOUNDS)


def test_training_kernels_reject_widths_they_are_not_compiled_for(cuda):
    config = GATODEConfig(hidden_dim=64)
    model = build_model(config, 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    args = day_operands(model, 16, 8, 2, 2, cuda, seed=0)
    with pytest.raises(ValueError, match="compiled for"):
        ft.day_forward_fused(*args)
    ze = args[2]
    rows = torch.zeros(16, 16, device=cuda)
    with pytest.raises(ValueError, match="compiled for"):
        ft.ce_forward_fused(rows, torch.zeros(16, dtype=torch.int32,
                                              device=cuda),
                            torch.zeros(16, 64, dtype=torch.bfloat16,
                                        device=cuda), ze)


def test_fixed_step_trainer_runs_through_the_kernels(cuda):
    """One launch of each kernel per step, and the loss and gradient of the
    plain-version step (the JAX tests' bounds for the fused step)."""
    config = GATODEConfig()
    d = generate_agent_population(1_024, num_times=6, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               fg.gat_forward_fused, fg.gat_backward_fused)
    before = [k.launches for k in kernels]
    _, loss_fn = make_fused_train_step(model, None, config, static)
    model.zero_grad()
    loss, _ = loss_fn(*batch)
    loss.backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1] * 6
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    plain = build_fused_loss_fn(model, config, *static, _plain=True)
    model.zero_grad()
    loss_p, _ = plain(*batch)
    loss_p.backward()
    grads_p = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert abs(loss.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item())
    cos = torch.dot(grads.double(), grads_p.double()) / (
        grads.double().norm() * grads_p.double().norm())
    assert cos > 0.999


def test_one_rank_nccl_mesh_fused_step_gives_the_single_device_bits(
        cuda, tmp_path):
    """``make_sharded_fused_train_step`` under a one-rank NCCL mesh: the
    loss, the accuracy and the updated parameters of
    ``make_fused_train_step``, bit for bit (a sum over one rank is a
    copy); each kernel launched once a step."""
    import torch.distributed as dist

    from ananke_abm_tpu_torch.models.gnn_embed.train import make_optimizer
    from ananke_abm_tpu_torch.parallel import (
        make_mesh,
        make_sharded_fused_train_step,
        maybe_initialize,
    )

    config = GATODEConfig()
    d = generate_agent_population(1_024, num_times=6, num_zones=64, seed=0)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               fg.gat_forward_fused, fg.gat_backward_fused)
    maybe_initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                     backend="nccl", device=cuda, timeout_s=60)
    try:
        mesh = make_mesh()
        out = {}
        for tag in ("single", "mesh"):
            model = _model(cuda, config.num_blocks)
            opt = make_optimizer(model, config)
            if tag == "single":
                step, _ = make_fused_train_step(model, opt, config, static)
            else:
                step = make_sharded_fused_train_step(model, opt, config,
                                                     mesh, static)
            before = [k.launches for k in kernels]
            loss, acc = step(*batch)
            assert [k.launches - b for k, b in zip(kernels, before)] == \
                [1] * 6
            out[tag] = (loss.reshape(()), acc.reshape(()), torch.cat(
                [p.detach().flatten() for p in model.parameters()]))
    finally:
        dist.destroy_process_group()
    for a, b in zip(out["single"], out["mesh"]):
        assert torch.equal(a.float(), b.float())


def test_build_model_defaults_to_the_card(cuda):
    model = build_model(GATODEConfig(), 7, 8)
    assert next(model.parameters()).device.type == "cuda"


@pytest.mark.parametrize("num_zones,num_layers,isolated", [
    (500, 2, None), (64, 2, None), (2_048, 2, None), (37, 1, 5), (300, 4, 0),
])
def test_encoder_kernels_match_plain_versions(cuda, num_zones, num_layers,
                                              isolated):
    """K4f and K4b within the bounds, every parameter gradient (the plain
    backward on the kernel's side of each leaky-relu's kink); each twice
    gives the same bits; the TF32 control fails the same bounds."""
    _encoder_case(cuda, num_zones, num_layers, isolated, 0.1)


@pytest.mark.parametrize("num_zones,num_layers,isolated,density", [
    (500, 2, None, 1.0), (300, 2, [0, 17, 150], 0.1), (129, 1, [5], 0.02),
    (2_048, 2, None, 1.0), (1, 2, None, 0.1), (70, 2, [0, 33, 69], 0.1),
])
def test_encoder_kernels_at_dense_graphs_and_rows_without_entries(
        cuda, num_zones, num_layers, isolated, density):
    """The kernels' lists of the graph's entries full length (every
    adjacency entry on; at Z = 2048 a row's list runs past 32 words, so the
    walks loop), one zone, and rows with no entry at Z > 64 and at a Z that
    is not a multiple of 32, where every column's list takes those rows:
    the same bounds, control and repeats."""
    _encoder_case(cuda, num_zones, num_layers, isolated, density)


@pytest.mark.parametrize("num_zones,num_layers,hub", [
    (100, 2, 3), (70, 1, 69),
])
def test_encoder_kernels_at_a_long_row_beside_self_loops(
        cuda, num_zones, num_layers, hub):
    """A row of more than 32 entries (K4f's max by its scan of every
    column, its sums in two batches) beside rows whose only entry is the
    self loop: the same bounds, control and repeats."""
    _encoder_case(cuda, num_zones, num_layers, None, 0.0, hub=hub)


def _list_words(adj):
    """Each row's on-graph columns as ceil(Z / 32) bitmask words, as int64
    holding the unsigned words."""
    z = adj.shape[0]
    words = -(-z // 32)
    on = torch.zeros(z, 32 * words, dtype=torch.int64, device=adj.device)
    on[:, :z] = (adj > 0).long()
    bits = 2 ** torch.arange(32, dtype=torch.int64, device=adj.device)
    return (on.view(z, words, 32) * bits).sum(-1)


def _encoder_case(cuda, num_zones, num_layers, isolated, density, hub=None):
    args, g = gat_operands(num_zones, 7, num_layers, cuda, seed=num_zones,
                           isolated=isolated, density=density)
    if hub is not None:
        args[1][hub, :48] = 1.0
    bargs = (*args[:3], g, *args[3:])
    with torch.no_grad():
        before = (fg.gat_forward_fused.launches,
                  fg.gat_backward_fused.launches)
        out, res = fg.gat_forward_fused(*args)
        again, res2 = fg.gat_forward_fused(*args)
        got = fg.gat_backward_fused(*bargs, res)
        got2 = fg.gat_backward_fused(*bargs, res)
        torch.cuda.synchronize()
        assert (fg.gat_forward_fused.launches,
                fg.gat_backward_fused.launches) == (before[0] + 2,
                                                    before[1] + 2)
        want, _ = fg.gat_forward_reference(*args)
        sides = kernel_kink_sides(res, num_layers, 4)
        plain = lambda *a: on_kernel_sides(sides, fg.gat_backward_reference,
                                           *a)
        want_g = plain(*bargs)
        control = tf32_control(fg.gat_forward_reference, *args)[0]
        control_g = tf32_control(plain, *bargs)
    assert out.shape == (num_zones, 64)
    assert torch.equal(out, again)
    # every residual repeats bit for bit, and RS's tail holds each row's
    # on-graph columns
    assert all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(res, res2))
    lists = res[5][num_layers * num_zones:].view(torch.int32)
    assert torch.equal(lists.long().view(num_zones, -1) & 0xFFFFFFFF,
                       _list_words(args[1]))
    assert all(torch.equal(u, v) for u, v in zip(got, got2))
    params = lambda grads: [t for _, t in gat_grad_outputs(grads,
                                                           num_layers)]
    _assert_close([out], [want], GAT_FWD_BOUNDS)
    _assert_close(params(got), params(want_g), GAT_BWD_BOUNDS)
    assert not _within([control], [want], GAT_FWD_BOUNDS)
    assert not _within(params(control_g), params(want_g), GAT_BWD_BOUNDS)


def test_encoder_kernels_reject_what_they_are_not_compiled_for(cuda):
    model = build_model(GATODEConfig(gat_heads=2), 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    flat = tuple(w.detach() for w in fg.flatten_gat_params(model.zone_gat))
    zf = torch.zeros(8, 7, device=cuda)
    adj = torch.eye(8, device=cuda)
    with pytest.raises(ValueError, match="compiled for"):
        fg.gat_forward_fused(zf, adj, flat, 2, 2)
    args, g = gat_operands(8, 7, 1, cuda, seed=0)
    with pytest.raises(ValueError, match="residuals"):
        fg.gat_backward_fused(*args[:3], g, *args[3:], None)


def test_train_on_the_card_resumes_the_straight_run(cuda, tmp_path):
    """train() on the card: the fused step (one launch of each kernel per
    step), resume reproducing the straight run, one accumulated update."""
    config = GATODEConfig(batch_size=512, epochs=3)
    kw = dict(n_agents=1_024, num_times=4, num_zones=64, seed=2,
              device="cuda")
    kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
               ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused)
    before = [k.launches for k in kernels]
    straight = train(str(tmp_path / "a"), config=config, **kw)
    assert [k.launches - b for k, b in zip(kernels, before)] == [6] * 6
    short = GATODEConfig(batch_size=512, epochs=2)
    train(str(tmp_path / "b"), config=short, ckpt_every=1, **kw)
    resumed = train(str(tmp_path / "b"), config=config, resume=True, **kw)
    h_a = load_checkpoint(straight["ckpt"])["history"]
    h_b = load_checkpoint(resumed["ckpt"])["history"]
    assert len(h_a) == len(h_b) == 3
    for a, b in zip(h_a, h_b):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    acc = train(str(tmp_path / "c"), config=GATODEConfig(batch_size=512,
                                                         epochs=1),
                accum_steps=2, ckpt_every=1, **kw)
    assert torch.isfinite(torch.tensor(acc["final_loss"]))
    last = load_checkpoint(str(tmp_path / "c" / "gatode_last.ckpt"))
    assert last["opt_state"]["step"] == 1


# ---- K5 / K7: the DOPRI5 step and its VJP ---------------------------------

def _dopri5_args(cuda, n, num_zones, num_blocks):
    from ananke_abm_tpu_torch.ops.cuda.checks import dopri5_operands

    return dopri5_operands(_model(cuda, num_blocks), n, num_zones, cuda,
                           seed=n)


def _worst(got, want):
    """(mean |d| / mean |ref|, max |d| / max |ref|, 1 - cosine), the worst
    over the (name, tensor) outputs."""
    worst = [0.0, 0.0, 0.0]
    for (_, u), (_, v) in zip(got, want):
        u, v = u.double().flatten(), v.double().flatten()
        assert torch.isfinite(u).all()
        d = (u - v).abs()
        worst[0] = max(worst[0], (d.mean() / v.abs().mean()).item())
        worst[1] = max(worst[1], (d.max() / v.abs().max()).item())
        worst[2] = max(worst[2], 1 - (u @ v / (u.norm() * v.norm())).item())
    return worst


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (98_304, 64, 2), (1_000, 500, 1), (2_000, 64, 8), (33, 3, 5),
])
def test_dopri5_kernels_match_plain_versions(cuda, n, num_zones, num_blocks):
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BOUNDS,
        DOPRI5_VJP_BOUNDS,
        dopri5_step_outputs,
        dopri5_vjp_outputs,
    )

    args, cot = _dopri5_args(cuda, n, num_zones, num_blocks)
    with torch.no_grad():
        for stats in (None, (1e-5, 1e-5)):
            got = dopri5_step_outputs(fd.dopri5_step_fused(*args,
                                                           err_stats=stats))
            again = dopri5_step_outputs(fd.dopri5_step_fused(
                *args, err_stats=stats))
            want = dopri5_step_outputs(fd.dopri5_step_reference(
                *args, err_stats=stats))
            assert all(torch.equal(u, v) for (_, u), (_, v) in
                       zip(got, again))
            assert all(w <= b for w, b in zip(_worst(got, want),
                                              DOPRI5_STEP_BOUNDS))
        got = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        again = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        want = dopri5_vjp_outputs(fd.dopri5_step_vjp_reference(*args, *cot))
    assert all(torch.equal(u, v) for (_, u), (_, v) in zip(got, again))
    assert all(w <= b for w, b in zip(_worst(got, want), DOPRI5_VJP_BOUNDS))


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (3_001, 45, 1), (1_000, 77, 8),
])
def test_dopri5_step_kernel_at_ragged_zone_boxes(cuda, n, num_zones,
                                                  num_blocks):
    """K5 at float32 (3xTF32 products, its weights through a ring of boxes
    of 32 zones) where no box is full at the end and no tile of 128 rows
    at the last, at 1 and 8 blocks: within DOPRI5_STEP_BOUNDS of its plain
    version with and without the error sum, the same bits on a repeat, the
    TF32-product control outside."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BOUNDS,
        dopri5_step_outputs,
        tf32_products,
    )

    args, _ = _dopri5_args(cuda, n, num_zones, num_blocks)
    with torch.no_grad():
        for stats in (None, (1e-5, 1e-5)):
            got = dopri5_step_outputs(fd.dopri5_step_fused(*args,
                                                           err_stats=stats))
            again = dopri5_step_outputs(fd.dopri5_step_fused(
                *args, err_stats=stats))
            want = dopri5_step_outputs(fd.dopri5_step_reference(
                *args, err_stats=stats))
            control = dopri5_step_outputs(tf32_products(
                lambda *a: fd.dopri5_step_reference(*a, err_stats=stats),
                *args))
            assert all(torch.equal(u, v) for (_, u), (_, v) in
                       zip(got, again))
            assert all(w <= b for w, b in zip(_worst(got, want),
                                              DOPRI5_STEP_BOUNDS))
            assert not all(w <= b for w, b in zip(_worst(control, want),
                                                  DOPRI5_STEP_BOUNDS))


def test_dopri5_kernels_against_a_float64_witness(cuda):
    """Kernel within the check's bounds of a float64 run; the TF32-product
    control not."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BOUNDS,
        DOPRI5_VJP_BOUNDS,
        dopri5_step_outputs,
        dopri5_vjp_outputs,
        float64_operands,
        tf32_products,
    )

    args, cot = _dopri5_args(cuda, 1_000, 64, 2)
    a64, c64 = float64_operands(args), float64_operands(cot)
    with torch.no_grad():
        for outs, kernel, plain, kargs, wargs, bounds in (
                (dopri5_step_outputs, fd.dopri5_step_fused,
                 fd.dopri5_step_reference, args, a64,
                 DOPRI5_STEP_BOUNDS),
                (dopri5_vjp_outputs, fd.dopri5_step_vjp_fused,
                 fd.dopri5_step_vjp_reference, args + cot, a64 + c64,
                 DOPRI5_VJP_BOUNDS)):
            exact = outs(plain(*wargs))
            k = _worst(outs(kernel(*kargs)), exact)
            c = _worst(outs(tf32_products(plain, *kargs)), exact)
            assert all(w <= b for w, b in zip(k, bounds))
            assert not all(w <= b for w, b in zip(c, bounds))


def test_dopri5_kernels_reject_what_they_are_not_compiled_for(cuda):
    """A bf16 backward and a bf16 forward launch (K7, K6 and K5 take bf16),
    and the hooks build at a bf16 forward; widths the kernels are not
    compiled for, operands on another device and of another type raise
    before anything launches."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd

    args, cot = _dopri5_args(cuda, 64, 8, 1)
    before = fd.dopri5_step_vjp_fused.launches
    fd.dopri5_step_vjp_fused(*args, *cot, precision="bf16")
    assert fd.dopri5_step_vjp_fused.launches == before + 1
    before = fd.dopri5_step_fused.launches
    fd.dopri5_step_fused(*args, precision="bf16")
    assert fd.dopri5_step_fused.launches == before + 1
    model = _model(cuda, 2)
    static = (torch.zeros(8, 7, device=cuda), torch.eye(8, device=cuda),
              torch.linspace(0.0, 1.0, 4, device=cuda))
    step_impl, step_vjp = fd.make_fused_dopri5_hooks(model, precision="bf16")
    assert callable(step_impl) and callable(step_vjp.backward_all)
    assert callable(build_adjoint_loss_fn_g(
        model, GATODEConfig(method="dopri5"), static,
        adjoint_mode="discrete", bwd_precision="bf16"))
    before = [k.launches for k in fd.KERNELS]
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="h is on cpu"):
        fd.dopri5_step_fused(*bad, precision="bf16")
    bad = list(args)
    bad[1] = args[1].bfloat16()
    with pytest.raises(TypeError, match="f0"):
        fd.dopri5_step_fused(*bad, precision="bf16")
    model = build_model(GATODEConfig(hidden_dim=64), 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        dopri5_backward_operands,
        dopri5_operands,
    )

    args, cot = dopri5_operands(model, 64, 8, cuda, seed=0)
    for precision in ("f32", "bf16"):
        with pytest.raises(ValueError, match="compiled for"):
            fd.dopri5_step_fused(*args, precision=precision)
        with pytest.raises(ValueError, match="compiled for"):
            fd.dopri5_step_vjp_fused(*args, *cot, precision=precision)
        with pytest.raises(ValueError, match="compiled for"):
            fd.dopri5_backward_fused(*dopri5_backward_operands(
                model, 64, 8, cuda, 0, 4, 3, 3), precision=precision)
    assert [k.launches for k in fd.KERNELS] == before


def _k6_k7_bf16_checks(cuda, n, num_zones, num_blocks, control=False):
    """(label, kernel outputs, plain outputs, bounds, control outputs or
    None) of K7 at bf16 and of K6 at both precisions and checkpoint types,
    each kernel output checked for the same bits on a repeat."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_BWD_BF16_BOUNDS,
        DOPRI5_BWD_BOUNDS,
        DOPRI5_VJP_BF16_BOUNDS,
        K6_RECORD,
        bf16_control,
    bf16_features,
        day_bounds,
        dopri5_backward_operands,
        dopri5_vjp_outputs,
        tf32_products,
    )

    out = []
    model = _model(cuda, num_blocks)
    args, cot = _dopri5_args(cuda, n, num_zones, num_blocks)
    with torch.no_grad():
        runs = [("K7 bf16", lambda p, *a: p(*a, precision="bf16"),
                 (fd.dopri5_step_vjp_fused, fd.dopri5_step_vjp_reference),
                 args + cot, day_bounds(DOPRI5_VJP_BF16_BOUNDS, num_blocks),
                 bf16_control)]
        for prec, bounds, ctl in (("bf16", day_bounds(
                DOPRI5_BWD_BF16_BOUNDS, num_blocks), bf16_control),
                                  ("f32", DOPRI5_BWD_BOUNDS, tf32_products)):
            for dt in (torch.bfloat16, torch.float32):
                bargs = dopri5_backward_operands(
                    model, n, num_zones, cuda, n, *K6_RECORD, ckpt_dtype=dt)
                runs.append((f"K6 {prec} {dt}",
                             lambda p, *a, prec=prec: p(*a, precision=prec),
                             (fd.dopri5_backward_fused,
                              fd.dopri5_backward_reference),
                             bargs, bounds, ctl))
        for label, call, (kernel, plain), a, bounds, ctl in runs:
            got = dopri5_vjp_outputs(call(kernel, *a))
            again = dopri5_vjp_outputs(call(kernel, *a))
            assert all(torch.equal(u, v) for (_, u), (_, v) in
                       zip(got, again)), label
            want = dopri5_vjp_outputs(call(plain, *a))
            c = (dopri5_vjp_outputs(ctl(lambda *b: call(plain, *b), *a))
                 if control else None)
            out.append((label, got, want, bounds, c))
    return out


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (98_304, 64, 2), (1_000, 500, 1), (2_000, 64, 8), (333, 7, 5),
    (33, 3, 5), (9_001, 300, 3),
])
def test_dopri5_bf16_and_backward_kernels_match_plain_versions(
        cuda, n, num_zones, num_blocks):
    """K7 at bf16 and K6 (both precisions, both checkpoint types) within
    ``checks.py``'s bounds of their plain versions; repeats give the same
    bits."""
    for label, got, want, bounds, _ in _k6_k7_bf16_checks(
            cuda, n, num_zones, num_blocks):
        assert all(w <= b for w, b in zip(_worst(got, want), bounds)), label


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (1_001, 64, 1), (1_001, 500, 1), (1_001, 40, 2), (999, 64, 4),
    (999, 500, 4), (515, 64, 8), (515, 500, 8), (1_001, 40, 1),
    (2_017, 64, 2), (2_017, 500, 2), (999, 40, 4), (515, 40, 8),
])
def test_step_vjp_bodies_match_plain_versions_at_ragged_tiles(
        cuda, n, num_zones, num_blocks):
    """The step VJP's bodies at agent counts no tile divides (the bf16
    body's 96 rows up to 2 blocks, 64 up to 5, 32 beyond; the float32
    body's 128 at any depth), 1, 2, 4 and 8 blocks, and zones that fill 2
    or 16 of the 32-zone weight boxes or end in a part box (40): K7 at
    float32 and K7-bf16 and K6 (both precisions, both checkpoint types)
    within ``checks.py``'s bounds of their plain versions, each repeat
    bit-identical."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_VJP_BOUNDS,
        dopri5_vjp_outputs,
    )

    args, cot = _dopri5_args(cuda, n, num_zones, num_blocks)
    with torch.no_grad():
        got = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        again = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        want = dopri5_vjp_outputs(fd.dopri5_step_vjp_reference(*args, *cot))
    assert all(torch.equal(u, v) for (_, u), (_, v) in zip(got, again))
    assert all(w <= b for w, b in zip(_worst(got, want), DOPRI5_VJP_BOUNDS))
    for label, got, want, bounds, _ in _k6_k7_bf16_checks(
            cuda, n, num_zones, num_blocks):
        assert all(w <= b for w, b in zip(_worst(got, want), bounds)), label


def test_dopri5_bf16_and_backward_controls_fail(cuda):
    """The bf16-product control fails K7-bf16's and K6-bf16's bounds, the
    TF32-product control K6-f32's: the bounds tell a kernel that lost its
    float32 sums (or took TF32) from a sound one."""
    for label, _, want, bounds, ctl in _k6_k7_bf16_checks(
            cuda, 2_000, 64, 2, control=True):
        assert not all(w <= b for w, b in zip(_worst(ctl, want), bounds)), \
            label


def test_bf16_discrete_route_launches_k6_once(cuda):
    """Bench rung 3's settings (max_accepted=256, ckpt_every=1,
    bwd_precision="bf16"): K5 once per attempted forward step, K6 once per
    backward, K7 never; the gradient of the same route on the plain
    versions."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd

    config = GATODEConfig(method="dopri5")
    d = generate_agent_population(1_024, num_times=6, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    rung3 = dict(adjoint_mode="discrete", max_accepted=256, ckpt_every=1,
                 bwd_precision="bf16")
    before = [k.launches for k in fd.KERNELS]
    _, loss_fn = make_adjoint_step_fns(model, None, config, static, **rung3)
    model.zero_grad()
    loss, _ = loss_fn(*batch)
    loss.backward()
    st = loss_fn.stats
    assert [k.launches - b for k, b in zip(fd.KERNELS, before)] == [
        st["forward"]["n_steps"], 0, 1]
    assert st["vjps"] == st["replays"] == 0
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    plain = build_adjoint_loss_fn_g(model, config, static, use_fused=True,
                                    _plain=True, **rung3)
    model.zero_grad()
    loss_p, _ = plain(*batch, static)
    loss_p.backward()
    grads_p = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert abs(loss.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    cos = torch.dot(grads.double(), grads_p.double()) / (
        grads.double().norm() * grads_p.double().norm())
    assert cos > 0.999


def test_discrete_trainer_runs_through_the_kernels(cuda):
    """One K5 launch per attempted step and replay, one K7 launch per
    accepted step; the loss and gradient of the plain-version step."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd

    config = GATODEConfig(method="dopri5")
    d = generate_agent_population(1_024, num_times=6, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    before = [k.launches for k in fd.KERNELS]
    _, loss_fn = make_adjoint_step_fns(model, None, config, static,
                                       adjoint_mode="discrete")
    model.zero_grad()
    loss, _ = loss_fn(*batch)
    loss.backward()
    st = loss_fn.stats
    assert [k.launches - b for k, b in zip(fd.KERNELS, before)] == [
        st["forward"]["n_steps"] + st["replays"],
        st["forward"]["n_accepted"], 0]
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    plain = build_adjoint_loss_fn_g(model, config, static,
                                    adjoint_mode="discrete", use_fused=True,
                                    _plain=True)
    model.zero_grad()
    loss_p, _ = plain(*batch, static)
    loss_p.backward()
    grads_p = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert abs(loss.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    cos = torch.dot(grads.double(), grads_p.double()) / (
        grads.double().norm() * grads_p.double().norm())
    assert cos > 0.9999


@pytest.mark.parametrize("change,want", [
    ({"gat_heads": 2}, [0, 0, 2, 2, 2, 2]), ({"hidden_dim": 64}, [0] * 6),
])
def test_train_takes_only_the_kernels_that_fit(cuda, tmp_path, change, want):
    """train() routes by what each kernel is compiled for: at two heads the
    encoder runs through ``model.encode_zones`` and the day and
    cross-entropy kernels once a step; at hidden 64 the plain step."""
    kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
               ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused)
    before = [k.launches for k in kernels]
    res = train(str(tmp_path), n_agents=512, num_times=4, num_zones=16,
                config=GATODEConfig(batch_size=256, epochs=1, **change),
                device=cuda)
    assert np.isfinite(res["final_loss"])
    assert [k.launches - b for k, b in zip(kernels, before)] == want


@pytest.mark.parametrize("kind,z,heads,d", [("rung2", 500, 4, 16),
                                            ("random", 3_000, 2, 32),
                                            ("random", 700, 4, 12)])
def test_edge_kernels_match_plain_versions(cuda, kind, z, heads, d):
    """The CSR forward and backward within the bounds of their plain
    versions; each twice gives the same bits; the bf16-feature control
    fails the same bounds."""
    _edge_case(cuda, kind, z, heads, d)


@pytest.mark.parametrize("kind,z,heads,d", [
    EDGE_HUB_SHAPE, ("random", 700, 3, 5), ("random", 700, 2, 16),
    ("single", 1_000, 1, 256), ("random", 700, 3, 48)])
def test_edge_kernels_at_hubs_and_every_row_layout(cuda, kind, z, heads, d):
    """Both CSR kernels walk a row's edge indices in batches of one
    lane group: a hub of in- and out-degree 128 takes several batches (the
    forward walks them twice, for its max and for its sums), and
    destinations and sources with no edge take none (the forward writes
    out and lse 0). Both share the row layouts: 16-byte rows in groups of
    8 lanes (32 features) and of 32 lanes in two slots (a head of 256
    features: one head over both slots; heads of 48: the backward sums
    them through shared memory), and rows of single features (heads of 5;
    the backward's head sums through shared memory). The same bounds on
    out, lse and the gradients, control and repeats."""
    _edge_case(cuda, kind, z, heads, d)


def _edge_case(cuda, kind, z, heads, d):
    (wh, er, esd, lay), g = edge_operands(kind, z, heads, d, cuda, seed=0)
    before = (es.gat_edge_csr_forward.launches,
              es.gat_edge_csr_backward.launches)
    out, lse = es.gat_edge_csr_forward(wh, er, esd, lay)
    out2, lse2 = es.gat_edge_csr_forward(wh, er, esd, lay)
    corr = torch.sum(g * out, dim=-1)
    bargs = (g, wh, er, esd, lse, corr, lay)
    got = es.gat_edge_csr_backward(*bargs)
    got2 = es.gat_edge_csr_backward(*bargs)
    torch.cuda.synchronize()
    assert (es.gat_edge_csr_forward.launches,
            es.gat_edge_csr_backward.launches) == (before[0] + 2,
                                                   before[1] + 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(u, v) for u, v in zip(got, got2))
    want, want_lse = es.gat_edge_csr_forward_reference(wh, er, esd, lay)
    want_g = es.gat_edge_csr_backward_reference(*bargs)
    _assert_close([out, lse], [want, want_lse], EDGE_FWD_BOUNDS)
    _assert_close(got, want_g, EDGE_BWD_BOUNDS)
    wh16 = bf16_features(wh)
    control = es.gat_edge_csr_forward_reference(wh16, er, esd, lay)[0]
    control_g = es.gat_edge_csr_backward_reference(g, wh16, *bargs[2:])
    assert not _within([control], [want], EDGE_FWD_BOUNDS)
    assert not _within(control_g, want_g, EDGE_BWD_BOUNDS)


def test_edge_kernels_reject_what_they_are_not_compiled_for(cuda):
    """Operands split across devices, a type the kernels are not compiled
    for, head widths they do not take and ids out of range raise before
    anything launches."""
    (wh, er, esd, lay), _ = edge_operands("random", 300, 2, 32, cuda,
                                          seed=1)
    before = es.gat_edge_csr_forward.launches
    with pytest.raises(ValueError, match="is on cpu"):
        es.gat_edge_csr_forward(wh, er.cpu(), esd, lay)
    with pytest.raises(TypeError, match="float32"):
        es.gat_edge_csr_forward(wh.double(), er, esd, lay)
    odd = es.build_csr(lay.src, lay.dst, lay.num_nodes, 300)
    with pytest.raises(ValueError, match="compiled for"):
        es.gat_edge_csr_forward(torch.zeros(300, 3, 96, device=cuda),
                                torch.zeros(300, 3, device=cuda),
                                torch.zeros(300, 3, device=cuda), odd)
    src = lay.src.long()
    with pytest.raises(IndexError, match="source"):
        es.build_csr(torch.cat([src, src.new_tensor([300])]),
                     torch.cat([lay.dst.long(), src.new_tensor([0])]),
                     lay.num_nodes, 300)
    with pytest.raises(IndexError, match="negative"):
        es.build_csr(src, -lay.dst.long() - 1, lay.num_nodes, 300)
    assert es.gat_edge_csr_forward.launches == before


def test_sparse_train_runs_through_the_csr_kernels(cuda, tmp_path):
    """train(sparse_world=True) on the card: each CSR kernel launched
    gat_layers times a step, the dense encoder, day and cross-entropy
    kernels never."""
    kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
               ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               es.gat_edge_csr_forward, es.gat_edge_csr_backward)
    before = [k.launches for k in kernels]
    config = GATODEConfig(batch_size=256, epochs=1)
    res = train(str(tmp_path), n_agents=512, num_times=4, num_zones=300,
                config=config, sparse_world=True, device=cuda)
    steps = 2
    assert np.isfinite(res["final_loss"])
    assert load_checkpoint(res["ckpt"])["sparse_world"] is True
    assert [k.launches - b for k, b in zip(kernels, before)] == (
        [0] * 6 + [config.gat_layers * steps] * 2)


def test_sparse_train_takes_the_composition_past_the_kernels_width(
        cuda, tmp_path):
    """``train(sparse_world=True)`` at ``zone_dim=512`` (4 heads of 128
    features, past the CSR kernels' 256 a row) on the card: the encoder
    takes the float32 composition, chosen before anything launches, so no
    CSR kernel runs; ``serve()`` of what it trained neither."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import serve

    kernels = (es.gat_edge_csr_forward, es.gat_edge_csr_backward,
               rk4_interval_decode_fused)
    before = [k.launches for k in kernels]
    config = GATODEConfig(batch_size=256, epochs=1, zone_dim=512)
    res = train(str(tmp_path), n_agents=512, num_times=4, num_zones=300,
                config=config, sparse_world=True, device=cuda)
    assert np.isfinite(res["final_loss"])
    out = tmp_path / "served.npz"
    info = serve(res["ckpt"], str(out), n_agents=256, device=cuda)
    assert info["n_agents"] == 256
    with np.load(out) as f:
        assert f["zone_ids"].shape == (256, 4)
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 0]


# ---- K0: the serving step, and the per-step rollout -------------------------

def _step_operands(cuda, n, num_zones, num_blocks, seed=0):
    x, h, ze, w, _, tf, _ = _operands(_model(cuda, num_blocks), cuda, n,
                                      num_zones, seed)
    return x, h, ze, w, tf[:4].contiguous(), 0.125


@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (65_536, 64, 2), (1_000, 500, 1), (17, 5, 3), (3_001, 300, 4),
])
def test_step_kernel_matches_plain_version(cuda, n, num_zones, num_blocks):
    """K0 within the interval kernel's bounds of its plain version, the
    same bits on a repeat."""
    ops = _step_operands(cuda, n, num_zones, num_blocks)
    with torch.inference_mode():
        before = rk4_step_fused.launches
        xk = rk4_step_fused(*ops)
        again = rk4_step_fused(*ops)
        torch.cuda.synchronize()
        assert rk4_step_fused.launches == before + 2
        xr = rk4_step_reference(*ops)
    assert torch.equal(xk, again)
    d = (xk - xr).abs()
    assert d.mean().item() <= X_MEAN_ATOL
    assert d.max().item() <= X_MAX_RTOL * xr.abs().max().item()


@pytest.mark.parametrize("n,num_zones,num_blocks", SERVING_EDGE_SHAPES)
def test_serving_kernels_at_the_edges_of_their_tiles(cuda, n, num_zones,
                                                     num_blocks):
    """K1 and K0 against their plain versions where the CTA's agent rows
    (N not a multiple of them, warps with no valid row), the zone boxes (Z
    = 8: one 16-zone chunk; Z = 500: a part-filled last box) and the
    residual blocks (1 and 8) reach their edges; a repeat on the same
    operands gives the same bits. Past 2 blocks, where X_MEAN_ATOL was not
    read, the mean is held to the float64 witness: the kernel within
    SERVING_WITNESS_RATIO times the plain version's distance, the
    bf16-product control not."""
    ops = _operands(_model(cuda, num_blocks), cuda, n, num_zones, seed=n)
    step = (*ops[:4], ops[5][:4].contiguous(), 0.125)
    with torch.inference_mode():
        xk, ik = rk4_interval_decode_fused(*ops)
        xk2, ik2 = rk4_interval_decode_fused(*ops)
        sk = rk4_step_fused(*step)
        sk2 = rk4_step_fused(*step)
        torch.cuda.synchronize()
        xr, ir = rk4_interval_decode_reference(*ops)
        sr = rk4_step_reference(*step)
        deep = num_blocks > 2
        if deep:
            runs = ((rk4_interval_decode_reference, ops),
                    (rk4_step_reference, step))
            first = lambda out: out[0] if isinstance(out, tuple) else out
            witness = [first(float64_witness(fn, *a)) for fn, a in runs]
            control = [first(bf16_control(fn, *a)) for fn, a in runs]
    assert torch.equal(xk, xk2) and torch.equal(ik, ik2)
    assert torch.equal(sk, sk2)
    for i, (got, want) in enumerate(((xk, xr), (sk, sr))):
        assert torch.isfinite(got).all()
        d = (got - want).abs()
        assert d.max().item() <= X_MAX_RTOL * want.abs().max().item()
        if not deep:
            assert d.mean().item() <= X_MEAN_ATOL
            continue
        dist = lambda a: (a.double() - witness[i]).abs().mean().item()
        assert dist(got) <= SERVING_WITNESS_RATIO * dist(want)
        assert dist(control[i]) > SERVING_WITNESS_RATIO * dist(want)
    assert (ik == ir).float().mean().item() >= IDS_MIN
    assert 0 <= ik.min().item() and ik.max().item() < num_zones


def test_step_kernel_rejects_what_it_is_not_compiled_for(cuda):
    x, h, ze, w, tf, dt = _step_operands(cuda, 64, 8, 1)
    before = rk4_step_fused.launches
    with pytest.raises(ValueError, match="h is on cpu"):
        rk4_step_fused(x, h.cpu(), ze, w, tf, dt)
    with pytest.raises(TypeError, match="ze"):
        rk4_step_fused(x, h, ze.float(), w, tf, dt)
    model = build_model(GATODEConfig(hidden_dim=64), 7, 8, device=cuda)
    init_params(model, torch.Generator().manual_seed(0))
    w64 = pack_weights_bf16(model)
    with pytest.raises(ValueError, match="compiled for"):
        rk4_step_fused(x, h, ze, w64, torch.zeros(4, 64, device=cuda), dt)
    assert rk4_step_fused.launches == before


def test_per_step_rollout_runs_the_step_kernel(cuda):
    """``make_pallas_rollout(fuse_decode=False)``: ``substeps`` K0 launches
    per interval, no K1 launch; its ids against the interval body's (the
    in-kernel decode sums in another order than the plain one: near ties)
    and against its own body on the plain step."""
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        _per_step_body,
        make_pallas_rollout,
    )

    config = GATODEConfig()
    d = generate_agent_population(4_096, num_times=12, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    args = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    agents = (on(d["person_feats"]), on(d["home_zone"], torch.long))
    before = (rk4_step_fused.launches, rk4_interval_decode_fused.launches)
    got = make_pallas_rollout(model, *args, substeps=config.substeps)(
        *agents)
    assert rk4_step_fused.launches - before[0] == 11 * config.substeps
    assert rk4_interval_decode_fused.launches == before[1]
    fused = make_pallas_rollout(model, *args, substeps=config.substeps,
                                fuse_decode=True)(*agents)
    with torch.inference_mode():
        plain = _per_step_body(model, config.substeps,
                               rk4_step_reference)(*args, *agents)
    assert got.shape == (4_096, 12)
    assert (got == fused).float().mean().item() >= ROLLOUT_IDS_MIN
    assert (got == plain).float().mean().item() >= ROLLOUT_IDS_MIN


# ---- K5 at bf16 ---------------------------------------------------------------

@pytest.mark.parametrize("n,num_zones,num_blocks", [
    (98_304, 64, 2), (333, 7, 5), (200, 64, 8),
    (1_000, 77, 1), (1_000, 77, 2), (1_000, 77, 5), (1_000, 77, 8),
])
def test_dopri5_bf16_step_kernel_matches_plain_version(cuda, n, num_zones,
                                                       num_blocks):
    """K5's bf16 branch within DOPRI5_STEP_BF16_BOUNDS of its plain version
    (y1, f1, r5, and the error sum where it is asked for; the raw error, a
    difference of sums that the bf16 stage noise dominates, only finite),
    the same bits on a repeat; K5's float32 kernel on the same operands (it
    rounds no stage) outside them. 1,000 agents at every depth: no tile of
    192 rows, nor of 128, divides them, and 77 zones fill a second 64-zone
    box mostly past the zones."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BF16_BOUNDS,
        dopri5_step_outputs,
    )

    bounds = day_bounds(DOPRI5_STEP_BF16_BOUNDS, num_blocks)
    args, _ = _dopri5_args(cuda, n, num_zones, num_blocks)
    with torch.no_grad():
        for stats in (None, (1e-3, 1e-3)):
            run = lambda fn, p="bf16": [o for o in dopri5_step_outputs(
                fn(*args, precision=p, err_stats=stats))
                if stats is not None or o[0] != "err"]
            before = fd.dopri5_step_fused.launches
            got, again = run(fd.dopri5_step_fused), run(fd.dopri5_step_fused)
            assert fd.dopri5_step_fused.launches == before + 2
            want = run(fd.dopri5_step_reference)
            assert all(torch.equal(u, v) for (_, u), (_, v) in
                       zip(got, again))
            assert all(w <= b for w, b in zip(_worst(got, want), bounds))
            if stats is None:
                err = fd.dopri5_step_fused(*args, precision="bf16")[2]
                assert torch.isfinite(err).all()
            ctl = run(fd.dopri5_step_fused, "f32")
            assert not all(w <= b for w, b in zip(_worst(ctl, want),
                                                  bounds))


def test_bf16_forward_discrete_adjoint_runs_k5_bf16_and_k6(cuda):
    """``make_fused_dopri5_hooks(precision="bf16", bwd_precision="bf16")``
    under ``odeint_discrete_adjoint`` at rtol = atol = 1e-3, bench rung 3's
    recording (max_accepted=256, ckpt_every=1): K5 once per attempted
    forward step, K6 once, K7 never; the gradient of the float32-forward
    route at the same tolerance (cosine > 0.999)."""
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd

    config = GATODEConfig(method="dopri5", rtol=1e-3, atol=1e-3)
    d = generate_agent_population(1_024, num_times=6, num_zones=64, seed=0)
    model = _model(cuda, config.num_blocks)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(cuda)
    static = (on(d["zone_features"]), on(d["adj"]), on(d["times"]))
    batch = (on(d["person_feats"]), on(d["home_zone"], torch.long),
             on(d["zone_ids"], torch.long))
    grads = []
    for precision in ("bf16", "f32"):
        stats = {}
        step_impl, step_vjp = fd.make_fused_dopri5_hooks(
            model, precision=precision, bwd_precision="bf16",
            err_stats=(config.rtol, config.atol))
        loss_fn = _adjoint_loss_fn(model, config, None, stats, dict(
            max_accepted=256, ckpt_every=1, store_f="bf16",
            ckpt_dtype="bf16", step_impl=step_impl, step_vjp=step_vjp))
        before = [k.launches for k in fd.KERNELS]
        model.zero_grad()
        loss, _ = loss_fn(*batch, static)
        loss.backward()
        launched = [k.launches - b for k, b in zip(fd.KERNELS, before)]
        assert stats["forward"]["ok"] and torch.isfinite(loss)
        assert launched == [stats["forward"]["n_steps"], 0, 1]
        grads.append(torch.cat([p.grad.flatten() for p in
                                model.parameters()]).double())
    cos = grads[0] @ grads[1] / (grads[0].norm() * grads[1].norm())
    assert cos > 0.999


# ---- K9e: the segment sum ---------------------------------------------------

@pytest.mark.parametrize("kind,e,d,z", [
    ("rung2", 32_768, 32, 500), ("random", 20_000, 32, 2_048),
    ("random", 5, 3, 7), ("rung1", 100_000, 100, 64),
    ("random", 200, 7, 3), ("random", 70_001, 33, 130),
])
def test_segment_sum_kernel_matches_plain_version(cuda, kind, e, d, z):
    """K9e within SEGMENT_BOUNDS of its plain version for int64 and int32
    ids, the same bits on a repeat; empty segments and dropped ids 0; the
    unrounded sum (the control) outside the bounds where the segments hold
    many rows. The stream's edges: warps of fewer rows than one batch (5
    and 200 rows), of rows not a multiple of it (70,001 rows in 35
    chunks, none a multiple of 8 chunk groups), rows of D % 4 != 0 and of
    more than one 32-column pass (D = 33, 100), and a chunk sum whose last
    CTA holds fewer than 32 outputs (130 x 33)."""
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        SEGMENT_BOUNDS,
        segment_operands,
    )

    vals, ids, z = segment_operands(kind, e, d, z, cuda, seed=e)
    before = es.segment_sum.launches
    got = es.segment_sum(vals, ids, z)
    again = es.segment_sum(vals, ids.int(), z)
    torch.cuda.synchronize()
    assert es.segment_sum.launches == before + 2
    want = es.segment_sum_reference(vals, ids, z)
    assert torch.equal(got, again)
    kept = (ids >= 0) & (ids < z)
    empty = torch.ones(z, dtype=torch.bool, device=cuda)
    empty[ids[kept]] = False
    assert (got[empty] == 0).all()
    _assert_close([got], [want], SEGMENT_BOUNDS)
    if e >= 20_000:
        ctl = torch.zeros_like(want).index_add_(0, ids[kept], vals[kept])
        assert not _within([ctl], [want], SEGMENT_BOUNDS)


def test_segment_sum_kernel_rejects_what_it_is_not_compiled_for(cuda):
    vals = torch.randn(64, 8, device=cuda)
    ids = torch.zeros(64, dtype=torch.long, device=cuda)
    before = es.segment_sum.launches
    with pytest.raises(ValueError, match="segment_ids is on cpu"):
        es.segment_sum(vals, ids.cpu(), 4)
    with pytest.raises(TypeError, match="float32"):
        es.segment_sum(vals.bfloat16(), ids, 4)
    with pytest.raises(ValueError, match="rows of 1 to"):
        es.segment_sum(torch.zeros(4, es.MAX_SEGMENT_FEATURES + 1,
                                   device=cuda), ids[:4], 4)
    assert es.segment_sum.launches == before
    assert es._lib().ananke_segment_sum_max_features() == \
        es.MAX_SEGMENT_FEATURES


# ---- the schedule VAE and its CRF (chip_smoke.py phases 40 and 44) ---------

def _smoke():
    """chip_smoke.py's module (its configs and bounds)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0 and nb == 0:
        return 1.0
    return float((a @ b).item() / max(na * nb, 1e-300))


def test_schedule_vae_step_matches_the_cpu(cuda):
    """One VAE step at phase1's widths on 288 bins, card against CPU: the
    same weights, rows and noise, dropout off; every loss component within
    SCHED_STEP_RTOL and every gradient at cosine above SCHED_STEP_COS_MIN
    (phase 40's check)."""
    from ananke_abm_tpu_torch.models.gen_schedule import factory, params
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import (
        train as strain,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.vae import (
        init_params as init_vae,
    )

    cs = _smoke()
    cfg = cs.schedule_config("phase1")
    cfg["model"]["cnn_dropout"] = 0.0
    names = ["Education", "Escort", "Home", "Other", "Shopping", "Social",
             "Work"]
    meta = {"purpose_map": {k: i for i, k in enumerate(names)}, "L": 288,
            "grid_min": 5, "horizon_min": 1440}
    rows = cs.SCHED_STEP_ROWS
    rng = np.random.default_rng(0)
    Y = torch.as_tensor(rng.integers(0, 7, size=(rows, 288)))
    eps = torch.as_tensor(rng.standard_normal(
        (rows, cfg["model"]["z_dim"])).astype(np.float32))
    weights, out = None, {}
    for where in ("cpu", cuda):
        model, pds = factory.build_model(cfg, meta, device=where)
        if weights is None:
            init_vae(model, torch.Generator().manual_seed(0))
            weights = params.to_flax_params(model)
        params.load_flax_params(model, weights)
        loss_fn = strain.make_loss_fn(model, 2, strain.loss_weights(cfg),
                                      None)
        model.train()
        _, comps = loss_fn(Y.to(where), torch.ones(rows, device=where), 1.0,
                           eps=eps.to(where))
        comps["loss"].backward()
        out[str(where)] = ({k: v.item() for k, v in comps.items()},
                           {n: p.grad.cpu()
                            for n, p in model.named_parameters()})
    (cc, cg), (gc, gg) = out["cpu"], out[str(cuda)]
    for k, v in cc.items():
        if v != 0.0:
            assert abs(gc[k] - v) / abs(v) <= cs.SCHED_STEP_RTOL, k
    for n in cg:
        assert _cosine(gg[n], cg[n]) > cs.SCHED_STEP_COS_MIN, n


def test_crf_recursions_match_the_cpu(cuda):
    """log Z, the Viterbi decode and the constrained decode on
    CRF_CHECK_ROWS rows of 288 x 7 unaries, card against CPU: log Z and the
    paths' scores within CRF_RTOL, no all-home constrained path (phase
    44's check)."""
    from ananke_abm_tpu_torch.ops.crf import (
        crf_log_partition,
        crf_path_score,
        viterbi_decode,
        viterbi_decode_no_all_home,
    )

    cs = _smoke()
    g = torch.Generator().manual_seed(0)
    U = torch.randn(cs.CRF_CHECK_ROWS, 288, 7, generator=g) * 2.0
    U[:, :, 2] += 3.0  # home-heavy unaries: the constraint binds
    A = torch.randn(7, 7, generator=g)
    got = {}
    for where in ("cpu", cuda):
        u, a = U.to(where), A.to(where)
        got[str(where)] = (crf_log_partition(u, a).cpu(),
                           viterbi_decode(u, a).cpu(),
                           viterbi_decode_no_all_home(u, a, 2).cpu())
    (zc, pc, qc), (zg, pg, qg) = got["cpu"], got[str(cuda)]

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()

    assert rel(zg, zc) <= cs.CRF_RTOL
    assert rel(crf_path_score(U, pg, A), crf_path_score(U, pc, A)) <= \
        cs.CRF_RTOL
    assert rel(crf_path_score(U, qg, A), crf_path_score(U, qc, A)) <= \
        cs.CRF_RTOL
    assert not (qg == 2).all(dim=1).any()


def test_semi_crf_matches_the_cpu(cuda):
    """log Z at both ``allow_self``, the gold marginal, the NLL and its
    gradients, and the decode on 16 rows of 360 x 7 unaries with D = 60,
    card against CPU (phase 52's check and bounds)."""
    from ananke_abm_tpu_torch.ops import semi_crf as sc

    cs = _smoke()
    g = torch.Generator().manual_seed(0)
    U = torch.randn(16, 360, 7, generator=g) * 2.0
    dur = torch.randn(7, 60, generator=g) * 0.5
    A = torch.randn(7, 7, generator=g) * 0.5
    y = torch.repeat_interleave(torch.randint(0, 7, (16, 12), generator=g),
                                30, dim=1)  # runs of 30 bins
    y[:, :90] = 2  # a 90-bin run: longer than D
    out = {}
    for where in ("cpu", cuda):
        u, d, a, lab = (t.to(where) for t in (U, dur, A, y))
        leaves = [t.clone().requires_grad_(True) for t in (u, d, a)]
        nll = sc.semicrf_nll(leaves[0], lab, leaves[1], leaves[2],
                             exact_long=True)
        nll.backward()
        out[str(where)] = (
            [sc.semicrf_log_partition(u, d, a).cpu(),
             sc.semicrf_log_partition(u, d, a, True).cpu(),
             sc.semicrf_gold_log_marginal(u, lab, d, a).cpu(),
             nll.detach().cpu().reshape(1)],
            [t.grad.cpu() for t in leaves],
            [sc.semicrf_decode(u, d, a, s).cpu() for s in (False, True)])
    (vc, gc, dc), (vg, gg, dg) = out["cpu"], out[str(cuda)]
    for a, b in zip(vg, vc):
        assert ((a - b).abs().max() / b.abs().max()).item() <= cs.SEMI_RTOL
    for a, b in zip(gg, gc):
        assert _cosine(a, b) > cs.SEMI_COS_MIN
    for a, b in zip(dg, dc):
        assert (a == b).float().mean().item() >= cs.SEMI_LABELS_MIN


def test_traj_embed_step_matches_the_cpu(cuda):
    """One semi-CRF traj_embed step (exact_long) at full width on 32 rows,
    card against CPU: the same weights, rows and noise, dropout off; the
    loss components within SEMI_RTOL, every gradient at cosine above
    SEMI_COS_MIN."""
    from ananke_abm_tpu_torch.models.traj_syn import model as tmodel
    from ananke_abm_tpu_torch.models.traj_syn.configs import (
        CRFConfig,
        TrajEmbedConfig,
    )
    from ananke_abm_tpu_torch.models.traj_syn.pipeline import (
        train_full as tf,
    )

    cs = _smoke()
    cfg = TrajEmbedConfig(cnn_dropout=0.0)
    crf_cfg = CRFConfig("semi")
    rng = np.random.default_rng(0)
    Y = torch.as_tensor(np.repeat(rng.integers(0, 7, (32, 12)), 30, axis=1))
    eps = torch.as_tensor(rng.standard_normal((32, cfg.z_dim)),
                          dtype=torch.float32)
    feats = torch.as_tensor(rng.random((7, 8)), dtype=torch.float32)
    crf0 = {"A": torch.as_tensor(rng.standard_normal((7, 7)) * 0.1,
                                 dtype=torch.float32),
            "dur": torch.as_tensor(rng.standard_normal((7, 60)) * 0.1,
                                   dtype=torch.float32)}
    weights, out = None, {}
    for where in ("cpu", cuda):
        model = tf.build_model(cfg, 360, 7, where)
        if weights is None:
            tmodel.init_params(model, torch.Generator().manual_seed(0))
            weights = tmodel.to_flax_params(model)
        tmodel.load_flax_params(model, weights)
        crf = {k: v.detach().to(where).requires_grad_(True)
               for k, v in crf0.items()}
        loss_fn = tf.make_loss_fn(model, crf, crf_cfg, 1.0, feats.to(where))
        model.train()
        _, comps = loss_fn(Y.to(where), torch.ones(32, device=where), 1.0,
                           eps=eps.to(where))
        comps["loss"].backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        grads.update({k: v.grad.cpu() for k, v in crf.items()})
        out[str(where)] = ({k: v.item() for k, v in comps.items()}, grads)
    (cc, cg), (gc, gg) = out["cpu"], out[str(cuda)]
    for k, v in cc.items():
        assert abs(gc[k] - v) <= cs.SEMI_RTOL * abs(v), k
    for n in cg:
        assert _cosine(gg[n], cg[n]) > cs.SEMI_COS_MIN, n


# ---- the trajectory ODE families (chip_smoke.py phases 57 and 60) -----------

def test_latent_ode_step_matches_the_cpu(cuda):
    """One GenerativeODE loss-and-gradient at its defaults (the fixed grid,
    2,401 Euler-Maruyama steps, the same injected draws), card against
    CPU: components within ODE_RTOL, every gradient at cosine above
    ODE_COS_MIN, the decoded ids agreeing at ODE_IDS_MIN (phase 57)."""
    from ananke_abm_tpu_torch.models.latent_ode.config import (
        GenerativeODEConfig,
    )

    cs = _smoke()
    r = cs.card_cpu_readings(cs.latent_ode_step(GenerativeODEConfig()),
                             cuda)
    assert r["ok"], cs.describe_readings(r)


def test_mode_sep_step_matches_the_cpu(cuda, tmp_path):
    """One ModeSepModel loss-and-gradient at its defaults (RK4 x 4 over the
    mock world's union grid, K_internal 8), card against CPU, at phase
    57's bounds, the travel-margin component within ODE_RTOL of the travel
    points' distances (phase 60)."""
    from ananke_abm_tpu_torch.data_generator.export_csvs import (
        write_mock_world_csvs,
    )
    from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig

    cs = _smoke()
    paths = write_mock_world_csvs(str(tmp_path))
    csvs = tuple(paths[k] for k in ("periods.csv", "snaps.csv", "zones.csv",
                                    "persons.csv", "dist_mat.csv"))
    r, w, ok = cs.mode_sep_readings(cs.mode_sep_step(csvs, ModeSepConfig()),
                                    cuda)
    assert ok, cs.describe_readings(r) + "; " + cs.describe_witness(w)


# ---- the NaN-check mode on the kernels, throughput's sync -------------------

def test_nan_mode_sees_the_step_kernels_output(cuda):
    """Under ``debug_nan_mode``, K0 on a state holding one NaN raises
    before it returns (its wrapper checks the kernel's output, which the
    dispatcher never sees); without the mode it returns the state with
    its NaN; both calls launch the kernel."""
    from ananke_abm_tpu_torch.utils.profiling import debug_nan_mode

    x, h, ze, w, tf, dt = _step_operands(cuda, 4_096, 64, 2)
    x[7, 3] = float("nan")
    with torch.inference_mode():
        before = rk4_step_fused.launches
        assert torch.isnan(rk4_step_fused(x, h, ze, w, tf, dt)).any()
        with debug_nan_mode(), pytest.raises(FloatingPointError,
                                             match="rk4_step_fused"):
            rk4_step_fused(x, h, ze, w, tf, dt)
        assert rk4_step_fused.launches == before + 2


def test_nan_mode_sees_a_backward_on_the_cards_threads(cuda):
    """A NaN that first appears in a CUDA gradient, in the backward that
    autograd's engine runs on a device thread of its own, raises."""
    from ananke_abm_tpu_torch.utils.profiling import debug_nan_mode

    x = torch.tensor([0.0, 1.0], device=cuda, requires_grad=True)
    with debug_nan_mode():
        y = (torch.sqrt(x) * 0).sum()
        with pytest.raises(FloatingPointError):
            y.backward()


def test_throughput_waits_for_the_kernels(cuda):
    """``throughput``'s one sync ends its timed calls: its time per call
    is no less than the device time CUDA events read over the same calls
    (K0 at 65,536 agents)."""
    from ananke_abm_tpu_torch.utils.profiling import throughput

    ops = _step_operands(cuda, 65_536, 64, 2)
    with torch.inference_mode():
        r = throughput(rk4_step_fused, *ops, items=65_536, iters=20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            rk4_step_fused(*ops)
        end.record()
        torch.cuda.synchronize()
    assert r["ms_per_call"] >= 0.95 * start.elapsed_time(end) / 20
