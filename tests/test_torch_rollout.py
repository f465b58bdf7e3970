"""The serving slice: the port's decoded rollout against the JAX one, on
the float32 body and on the kernel body (JAX: Pallas in interpret mode;
port: the interval's plain version, which the wrapper takes on CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import agreement, make_pair
from ananke_abm_tpu.models.gnn_embed.rollout import (
    make_decoded_rollout as jax_rollout,
)
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    _kernel_body,
    _kernel_eligible,
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import GATODEConfig
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    rk4_interval_decode_fused,
    rk4_interval_decode_reference,
    stage_kernels_fit,
)

# float32 body: the same math in both frameworks; an id moves only where
# two logits are within float32 rounding of each other
F32_IDS_MIN = 0.999
# kernel body: bf16 activations, see tests/test_torch_fused_step.py
KERNEL_IDS_MIN = 0.995


def _ids(pair, use_kernel, use_pallas):
    zf, adj, times, pf, hz = pair.arrays()
    want = jax_rollout(
        pair.jmodel, pair.jcfg, jnp.asarray(zf), jnp.asarray(adj),
        jnp.asarray(times), use_pallas=use_pallas,
    )(pair.params, jnp.asarray(pf), jnp.asarray(hz))
    zf_t, adj_t, times_t, pf_t, hz_t = pair.tensors()
    got = make_decoded_rollout(
        pair.tmodel, pair.tcfg, zf_t, adj_t, times_t, use_kernel=use_kernel
    )(pf_t, hz_t)
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_f32_rollout_matches_jax(num_blocks):
    pair = make_pair(num_blocks=num_blocks)
    got, want = _ids(pair, use_kernel=False, use_pallas=False)
    assert got.shape == (128, 10)
    assert agreement(got, want) >= F32_IDS_MIN


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_kernel_body_on_cpu_matches_jax_pallas_interpret(num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=96, num_times=6,
                     num_zones=10)
    got, want = _ids(pair, use_kernel=True, use_pallas=True)
    assert got.shape == (96, 6)
    assert agreement(got, want) >= KERNEL_IDS_MIN
    assert rk4_interval_decode_fused.launches == 0


def test_kernel_body_full_width_matches_jax_pallas_interpret():
    pair = make_pair(num_blocks=2, n_agents=256, num_times=4, num_zones=64,
                     full=True)
    got, want = _ids(pair, use_kernel=True, use_pallas=True)
    assert got.shape == (256, 4)
    assert agreement(got, want) >= KERNEL_IDS_MIN


def test_reference_mode_is_the_kernel_body_through_the_plain_version():
    """On CPU tensors ``use_kernel=True`` is the kernel body with the
    interval's plain version, the baseline the card's kernel is held to."""
    pair = make_pair(num_blocks=2, n_agents=64, num_times=5)
    args = pair.tensors()
    forced = make_decoded_rollout(pair.tmodel, pair.tcfg, *args[:3],
                                  use_kernel=True)(*args[3:])
    with torch.inference_mode():
        plain = _kernel_body(pair.tmodel, pair.tcfg.substeps,
                             rk4_interval_decode_reference)(*args)
    torch.testing.assert_close(forced, plain, rtol=0, atol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_rollout_sees_updated_params(use_kernel):
    """The rollout reads the module's parameters at each call."""
    pair = make_pair(num_blocks=1, n_agents=64)
    zf, adj, times, pf, hz = pair.tensors()
    rollout = make_decoded_rollout(pair.tmodel, pair.tcfg, zf, adj, times,
                                   use_kernel=use_kernel)
    out0 = rollout(pf, hz)
    with torch.no_grad():
        for p in pair.tmodel.parameters():
            p.add_(0.5)
    out1 = rollout(pf, hz)
    assert (out0 != out1).any(), "updated params did not change the rollout"


def test_kernel_eligibility():
    ship = GATODEConfig()
    assert _kernel_eligible(ship, torch.device("cuda", 0))
    assert not _kernel_eligible(ship, "cpu")
    assert not _kernel_eligible(GATODEConfig(num_blocks=0), "cuda")
    # the TPU dispatch rules do not carry over: no zone cap, no N threshold
    assert _kernel_eligible(GATODEConfig(num_blocks=1), "cuda")
    assert _kernel_eligible(GATODEConfig(num_blocks=8), "cuda")
    # widths or block counts the CUDA kernel is not compiled for take the
    # float32 body, chosen before anything launches, as the reference's
    # _pallas_eligible sends them to its XLA body; use_kernel=True still
    # raises on the card (tests/test_torch_cuda.py)
    assert not _kernel_eligible(GATODEConfig(num_blocks=9), "cuda")
    assert not _kernel_eligible(GATODEConfig(hidden_dim=256), "cuda")


@pytest.mark.parametrize("change,want", [
    ({}, True), ({"hidden_dim": 64}, False), ({"num_blocks": 9}, False),
    ({"zone_dim": 32}, False), ({"agent_dim": 16}, False),
    ({"context_dim": 64}, False),
])
def test_kernel_eligible_follows_the_kernel_widths(change, want):
    """On the card the kernel body serves exactly where K1 is compiled for
    the configuration (``fused_step.stage_kernels_fit``)."""
    config = GATODEConfig(**change)
    assert _kernel_eligible(config, "cuda") is want
    assert want is stage_kernels_fit(config.agent_dim, config.zone_dim,
                                     config.context_dim, config.hidden_dim,
                                     config.num_blocks)
    assert _kernel_eligible(config, "cpu") is False


def test_auto_on_cpu_takes_the_f32_body():
    pair = make_pair(num_blocks=1, n_agents=32, num_times=4)
    args = pair.tensors()
    auto = make_decoded_rollout(pair.tmodel, pair.tcfg, *args[:3])(*args[3:])
    f32 = make_decoded_rollout(pair.tmodel, pair.tcfg, *args[:3],
                               use_kernel=False)(*args[3:])
    torch.testing.assert_close(auto, f32, rtol=0, atol=0)


def test_rollout_rejects_unknown_use_kernel():
    pair = make_pair(num_blocks=1, n_agents=8, num_times=3)
    zf, adj, times, *_ = pair.tensors()
    with pytest.raises(ValueError, match="use_kernel"):
        make_decoded_rollout(pair.tmodel, pair.tcfg, zf, adj, times,
                             use_kernel="pallas")
