"""The helpers the kernel checks share (``ops/cuda/checks.py``), on the CPU:
the float64 witness and the bf16-product control of a plain version, and
the depth scaling of the bounds."""
import pytest
import torch

from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    build_model,
    init_params,
)
from ananke_abm_tpu_torch.ops.cuda import checks, fused_step
from ananke_abm_tpu_torch.ops.cuda import fused_train as ft

CPU = torch.device("cpu")


def _far(u, v):
    """mean |u - v| / mean |v|, in float64."""
    u, v = u.double(), v.double()
    return ((u - v).abs().mean() / v.abs().mean()).item()


@pytest.fixture(scope="module")
def day():
    model = build_model(GATODEConfig(num_blocks=2), 7, 8, device=CPU)
    init_params(model, torch.Generator().manual_seed(0))
    fargs = checks.day_operands(model, 24, 12, 3, 2, CPU, seed=1)
    with torch.inference_mode():
        xs = ft.day_forward_reference(*fargs)
    gxs = torch.randn(xs.shape, generator=torch.Generator().manual_seed(2))
    return fargs, (xs, gxs, *fargs[1:])


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_float64_witness_is_nearer_the_plain_version_than_the_control(
        day, which):
    """The witness runs in float64 at the plain version's bf16 rounding
    points: the float32 plain version lies near it, a version whose
    products round to bf16 several times farther (the gradient of the time
    table, a sum over agents, is the first output, gx0 the second)."""
    args = day[0] if which == "forward" else day[1]
    fn = getattr(ft, f"day_{which}_reference")
    pick = (lambda o: [o]) if which == "forward" else (lambda o: [o[6], o[0]])
    dots = (fused_step._dot, fused_step._nt_dot, ft._dot, ft._nt_dot)
    with torch.inference_mode():
        plain = pick(fn(*args))
        witness = pick(checks.float64_witness(fn, *args))
        control = pick(checks.bf16_control(fn, *args))
    assert (fused_step._dot, fused_step._nt_dot, ft._dot, ft._nt_dot) == dots
    for p, w, c in zip(plain, witness, control):
        assert p.shape == w.shape
        assert _far(p, w) < 1e-2
        assert _far(c, w) > 3 * _far(p, w)


def test_day_bounds_scale_with_depth():
    at2 = checks.day_bounds(checks.DAY_BWD_BOUNDS, 2)
    at6 = checks.day_bounds(checks.DAY_BWD_BOUNDS, 6)
    assert at2 == tuple(b for b, _ in checks.DAY_BWD_BOUNDS)
    assert at6 == tuple(b * 2.0 ** p for b, p in checks.DAY_BWD_BOUNDS)
    assert checks.k8_bounds(6) == tuple(
        2 * b for b in (checks.K8_REL_MEAN, checks.K8_REL_MAX,
                        checks.K8_ONE_MINUS_COS))
