"""The CUDA interval kernel against its plain version, on the card.

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
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    _kernel_body,
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    build_model,
    init_params,
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
