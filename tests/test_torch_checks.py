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


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.14159, 0.0])
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.140625, 0.0]
    assert checks.round_tf32(x).tolist() == want


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_tf32_control_lies_farther_from_float64_than_the_plain_encoder(
        which):
    """The encoder's plain version in float32 lies near its float64 run
    (the same code on float64 tensors); the TF32 control, whose products
    round their operands to 10 mantissa bits, far from it."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg

    args, g = checks.gat_operands(48, 7, 2, CPU, seed=1, isolated=3)
    f64 = tuple(a.double() if torch.is_tensor(a) else
                tuple(w.double() for w in a) if isinstance(a, tuple) else a
                for a in args)
    if which == "forward":
        run = lambda fn, a: fn(fg.gat_forward_reference, *a)[0]
    else:
        # all gradients as one vector (the last layer's bias gradient, the
        # sum of the cotangent, has no product to round)
        run = lambda fn, a: torch.cat([x.reshape(-1) for x in fn(
            fg.gat_backward_reference, *a[:3],
            g.double() if a is f64 else g, *a[3:])])
    witness = run(lambda f, *a: f(*a), f64)
    plain = run(lambda f, *a: f(*a), args)
    control = run(checks.tf32_control, args)
    assert fg._mm.__name__ == "_mm"
    assert _far(plain, witness) < 1e-5
    assert _far(control, witness) > 10 * _far(plain, witness)


def test_gat_grad_outputs_join_the_heads_into_module_parameters():
    args, _ = checks.gat_operands(9, 7, 2, CPU, seed=0)
    out = dict(checks.gat_grad_outputs(args[2], 2))
    assert list(out) == ["Win", "bin"] + [
        f"{p}[{k}]" for k in range(2)
        for p in ("W", "a_src", "a_dst", "scale", "bias")]
    assert out["a_src[1]"].shape == (4, 16)
    # flatten_gat_params: Win, bin, W[0], a_src[0] rows 0-3, a_dst[0] rows
    torch.testing.assert_close(out["a_dst[0]"], torch.cat(args[2][7:11]))


def test_kink_sides_from_residuals_steer_the_plain_encoder():
    """kernel_kink_sides reads e_src / e_dst from K4f's residual layout;
    the plain backward on those sides equals its own where they agree, and
    one score moved across the kink changes the gradient by a step."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg

    args, g = checks.gat_operands(9, 7, 1, CPU, seed=4)
    zf, adj, flat, heads, num_layers = args
    h0 = zf @ flat[0] + flat[1]
    wh = h0 @ flat[2]
    e_src = torch.stack([(wh[:, 16 * h:16 * h + 16] * flat[3 + h]).sum(1)
                         for h in range(heads)], 1)
    e_dst = torch.stack([(wh[:, 16 * h:16 * h + 16] * flat[7 + h]).sum(1)
                         for h in range(heads)], 1)
    st = torch.stack([e_src, e_dst, e_src, e_src])[:, None]  # (4, 1, Z, H)
    sides = checks.kernel_kink_sides((None, None, None, st), 1, heads)
    assert len(sides) == heads and sides[0].shape == (9, 9)
    bargs = (*args[:3], g, *args[3:])
    own = fg.gat_backward_reference(*bargs)
    steered = checks.on_kernel_sides(sides, fg.gat_backward_reference, *bargs)
    for a, b in zip(own, steered):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    i, j = torch.nonzero(adj > 0)[1].tolist()
    sides[2][i, j] = ~sides[2][i, j]
    moved = checks.on_kernel_sides(sides, fg.gat_backward_reference, *bargs)
    assert fg._kink_side.__name__ == "_kink_side"
    assert not all(torch.allclose(a, b) for a, b in zip(own, moved))
    assert checks.kernel_kink_sides(None, 1, heads) is None


@pytest.mark.parametrize("kind,z,heads,d", [("rung2", 500, 4, 16),
                                            ("random", 300, 2, 32),
                                            ("random", 300, 3, 48)])
def test_edge_operands_and_the_bf16_feature_control(kind, z, heads, d):
    """The CSR checks' operands (a random graph: rows past num_nodes
    dropped, isolated rows, duplicates) and their control, whose
    bf16-rounded features lie outside the forward's mean bound."""
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es

    (wh, er, esd, lay), g = checks.edge_operands(kind, z, heads, d, CPU,
                                                 seed=0)
    assert wh.shape == (z, heads, d) and g.shape == (lay.num_nodes, heads,
                                                     d)
    deg = lay.row_ptr[1:] - lay.row_ptr[:-1]
    if kind == "random":
        assert lay.num_nodes < z and (deg == 0).any()
        assert lay.src.numel() < 9 * z  # some of the 9 z edges dropped
    with torch.no_grad():
        out, _ = es.gat_edge_csr_forward_reference(wh, er, esd, lay)
        ctl, _ = es.gat_edge_csr_forward_reference(
            checks.bf16_features(wh), er, esd, lay)
    assert _far(ctl, out) > 10 * checks.EDGE_FWD_BOUNDS[0]


def test_split_tf32_rebuilds_float32_and_its_product_is_float32_class():
    """K5's operand split: both parts are TF32 values (13 low mantissa bits
    clear) that rebuild x within 2^-21 |x|; its three-term product lies as
    near a float64 product as float32 does, a TF32 product ~1000x farther."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * torch.exp(
        8 * torch.randn(4096, generator=g))
    hi, lo = checks.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()
    a = torch.randn(64, 128, generator=g)
    b = torch.randn(128, 96, generator=g)
    exact = a.double() @ b.double()
    far = lambda u: _far(u, exact)
    f32 = far(a @ b)
    assert far(checks.tf32x3_dot(a, b)) <= 4 * f32
    assert far(checks.round_tf32(a) @ checks.round_tf32(b)) >= 100 * f32
