"""The DOPRI5 step kernels' plain versions (K5 ``dopri5_step_reference``,
K7 ``dopri5_step_vjp_reference``) against the JAX package's Pallas kernels
run in interpret mode on the CPU, on the same float32 operands made with
numpy from a seed, at narrow widths with a small tile (several tiles and a
ragged last one); the kernels' width predicates and train()'s gate.

Bounds: both sides compute the same float32 arithmetic with sums in other
orders, so y1, f1 and r5 lie within 1e-5 of their largest |ref|; err, the
difference of the 5th- and 4th-order increments, within 1e-5 of the largest
increment |y1 - x| it cancels from (at h = 0.125 err itself is ~1e-4 of
the increment, and float32 rounding of the increments shows there as
~1e-5 of err's own largest value); the
in-kernel error sum within rtol 1e-5 of ``tree_error_norm``'s, and every
VJP output at cosine > 1 - 1e-6 and within 1e-4 of its largest |ref|; at
``precision="bf16"`` every VJP output at cosine > 0.999, the bf16 class
(ROADMAP.md, North star): both round the same bf16 points, but a float32
sum in another order now and then rounds the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.ode.tree import tree_error_norm
from ananke_abm_tpu.ops.pallas import fused_dopri5 as jfd
from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as tfd
from ananke_abm_tpu_torch.ops.cuda import (
    fused_gat,
    fused_rhs,
    fused_train,
)

N, DA, DZ, DC, H, Z = 40, 8, 16, 8, 16, 10
TILE = 16
# K5's bf16 branch against the Pallas one, and the discrete adjoint with a
# bf16 forward against JAX's (test_bf16_* below). Read on the CPU: y1 <=
# 9e-8, f1 <= 1.0e-3, r5 <= 1.9e-3 of their largest |ref|, the error sum
# 3.4e-4 relative (the float32 branch on the same operands: f1 4.0e-3, r5
# 1.5e-2, the error sum 1.7e-2 to 3.5e-2 away); the trainer's loss 3.9e-4
# relative, gradient 1 - cosine 1.1e-4.
BF16_STEP_REL = 5e-3
BF16_SQ_REL = 5e-3
BF16_LOSS_REL = 1e-3


def _operands(num_blocks, seed=0):
    """(x, f0, h, ze, W1t, b1, Wq, W1xc, W1h, blocks, W3, b3) as float32
    numpy arrays, and five cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    w = lambda i, o: f(i, o, scale=1.0 / np.sqrt(i))
    x, f0, h = f(N, DA), f(N, DA, scale=0.3), f(N, DC)
    ze = f(Z, DZ)
    W1t, b1 = w(2, H), f(H, scale=0.1)
    blocks = tuple((w(H, H), f(H, scale=0.1), w(H, H), f(H, scale=0.1))
                   for _ in range(num_blocks))
    ops = (x, f0, h, ze, W1t, b1, w(DA, DZ), w(DA + DZ, H), w(DC, H),
           blocks, w(H, DA), f(DA, scale=0.1))
    return ops, tuple(f(N, DA) for _ in range(5))


def _jax_args(ops, t0, h_step):
    x, f0, h, ze, W1t, b1, Wq, W1xc, W1h, blocks, W3, b3 = (
        jax.tree_util.tree_map(jnp.asarray, ops))
    tf = jfd.stage_time_rows(jnp.float32(t0), jnp.float32(h_step), W1t, b1)
    return (x, f0, h, ze, tf, Wq, W1xc, W1h, blocks, W3, b3,
            jnp.float32(h_step))


def _port_args(ops, t0, h_step):
    t = lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                   else tuple(t(b) for b in a))
    x, f0, h, ze, W1t, b1, Wq, W1xc, W1h, blocks, W3, b3 = t(ops)
    tf = tfd.stage_time_rows(t0, h_step, W1t, b1)
    return (x, f0, h, ze, tf, Wq, W1xc, W1h, blocks, W3, b3, h_step)


def _close(got, want, rel, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.max(np.abs(want)) if scale is None else scale
    assert np.max(np.abs(got - want)) <= rel * scale, (
        np.max(np.abs(got - want)), scale)


@pytest.mark.parametrize("num_blocks,h_step", [(1, 0.125), (1, 2.0),
                                               (2, 0.125), (2, 2.0)])
def test_step_matches_pallas(num_blocks, h_step):
    ops, _ = _operands(num_blocks, seed=num_blocks)
    want = jfd.dopri5_step_fused(*_jax_args(ops, 6.5, h_step),
                                 interpret=True, tile=TILE)
    got = tfd.dopri5_step_fused(*_port_args(ops, 6.5, h_step))
    increment = np.max(np.abs(np.asarray(want[0]) - ops[0]))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, 1e-5, increment if i == 2 else None)


def test_error_sum_matches_tree_error_norm():
    rtol, atol = 1e-3, 1e-4
    ops, _ = _operands(2, seed=3)
    jargs = _jax_args(ops, 2.0, 0.5)
    y1, _, err, _ = jfd.dopri5_step_fused(*jargs, interpret=True, tile=TILE)
    want = float(tree_error_norm(err, jargs[0], y1, rtol, atol))
    args = _port_args(ops, 2.0, 0.5)
    _, _, sq, _ = tfd.dopri5_step_fused(*args, err_stats=(rtol, atol))
    got = np.sqrt(sq.item() / (N * DA))
    assert tuple(sq.shape) == (1, 1)
    assert got == pytest.approx(want, rel=1e-5)
    # and the Pallas kernel's own reduction
    _, _, jsq, _ = jfd.dopri5_step_fused(*jargs, interpret=True, tile=TILE,
                                         err_stats=(rtol, atol))
    assert sq.item() == pytest.approx(float(jsq[0, 0]), rel=1e-5)


def _vjp_items(out):
    (gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3) = out
    flat = [gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gW3, gb3]
    return flat + [w for blk in gblocks for w in blk]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("num_blocks", [1, 2])
def test_step_vjp_matches_pallas(num_blocks, precision):
    ops, cot = _operands(num_blocks, seed=10 + num_blocks)
    jout = jfd.dopri5_step_vjp_fused(*_jax_args(ops, 3.0, 0.4),
                                     *map(jnp.asarray, cot), interpret=True,
                                     tile=TILE, precision=precision)
    tout = tfd.dopri5_step_vjp_fused(*_port_args(ops, 3.0, 0.4),
                                     *map(torch.from_numpy, cot),
                                     precision=precision)
    for g, w in zip(_vjp_items(tout), _vjp_items(jout)):
        g = g.numpy().astype(np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        assert g.shape == w.shape
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        if precision == "bf16":
            assert cos > 0.999
            continue
        assert cos > 1 - 1e-6
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w))


def test_step_vjp_is_autograd_of_the_step():
    """K7's plain version against torch.autograd through K5's, f32 and
    bf16."""
    ops, cot = _operands(2, seed=4)
    args = _port_args(ops, 1.0, 0.3)
    g_dy, g_r5, g_k1x, g_k7x, g_y0d = map(torch.from_numpy, cot)
    for precision, tol in (("f32", 1e-5), ("bf16", 1e-5)):
        leaves = [a.clone().requires_grad_(True) for a in args[:3]]
        y1, f1, _, r5 = tfd.dopri5_step_reference(*leaves, *args[3:],
                                                  precision=precision)
        loss = (torch.sum((y1 - leaves[0]) * g_dy) + torch.sum(r5 * g_r5)
                + torch.sum(f1 * g_k7x))
        gx, gf, gh = torch.autograd.grad(loss, leaves)
        out = tfd.dopri5_step_vjp_reference(*args, g_dy, g_r5, g_k1x, g_k7x,
                                            g_y0d, precision=precision)
        # the bf16 VJP rounds its cotangents too: a looser class
        t = tol if precision == "f32" else 3e-2
        _close(out[0].numpy(), (gx + g_y0d).numpy(), t)
        _close(out[1].numpy(), (gf + g_k1x).numpy(), t)
        _close(out[2].numpy(), gh.numpy(), t)


def test_wrappers_check_their_operands():
    ops, cot = _operands(1)
    args = _port_args(ops, 0.0, 0.1)
    with pytest.raises(TypeError, match="x must be float32"):
        tfd.dopri5_step_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="tf_rows"):
        tfd.dopri5_step_fused(*args[:4], args[4][:3], *args[5:])
    with pytest.raises(ValueError, match="precision"):
        tfd.dopri5_step_fused(*args, precision="fp16")
    with pytest.raises(ValueError, match="g_r5"):
        tfd.dopri5_step_vjp_fused(*args, *[torch.from_numpy(c)
                                           for c in cot[:1]],
                                  torch.zeros(3, DA), *[
                                      torch.from_numpy(c) for c in cot[2:]])
    before = [k.launches for k in tfd.KERNELS]
    tfd.dopri5_step_fused(*args)
    tfd.dopri5_step_vjp_fused(*args, *map(torch.from_numpy, cot))
    assert [k.launches for k in tfd.KERNELS] == before  # the CPU launches none


@pytest.mark.parametrize("fits,case", [
    (True, ("dopri5", (32, 64, 32, 128, 2))),
    (True, ("dopri5", (32, 64, 32, 128, 8))),
    (False, ("dopri5", (32, 64, 32, 128, 9))),
    (False, ("dopri5", (32, 64, 32, 64, 2))),
    (False, ("dopri5", (32, 64, 32, 128, 0))),
    (True, ("rhs", (32, 64, 32, 128, 1))),
    (False, ("rhs", (16, 64, 32, 128, 1))),
    (True, ("day", (32, 64, 32, 128, 2))),
    (False, ("day", (32, 64, 32, 64, 2))),
    (False, ("day", (32, 64, 32, 128, 9))),
    (True, ("ce", (32, 64))),
    (False, ("ce", (32, 16))),
    (True, ("gat", (500, 7, 64, 4, 2))),
    (False, ("gat", (500, 7, 64, 2, 2))),
    (False, ("gat", (500, 7, 32, 4, 2))),
    (False, ("gat", (500, 7, 64, 4, 5))),
    (False, ("gat", (20_000, 7, 64, 4, 2))),
])
def test_kernel_predicates(fits, case):
    """Each kernel's predicate: the configurations its CUDA kernel is
    compiled for, as its wrapper enforces them."""
    kind, args = case
    fn = {"dopri5": tfd.kernels_fit, "rhs": fused_rhs.kernel_fits,
          "day": fused_train.day_kernels_fit,
          "ce": fused_train.ce_kernels_fit, "gat": fused_gat.kernels_fit}
    assert fn[kind](*args) is fits


def test_fused_step_gate_follows_the_predicates():
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        fused_step_fits,
    )

    assert fused_step_fits(GATODEConfig())
    assert fused_step_fits(GATODEConfig(gat_heads=2))  # K4 only is out
    assert not fused_step_fits(GATODEConfig(hidden_dim=64))
    assert not fused_step_fits(GATODEConfig(num_blocks=9))
    assert not fused_step_fits(GATODEConfig(zone_dim=32))


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_bf16_step_matches_pallas(num_blocks):
    """K5's bf16 branch: every stage activation and weight rounded to
    bf16, float32 sums; the tableau, y1, f1, r5 and the error sum float32.
    Both round the same bf16 points, a float32 sum in another order now and
    then rounds the other way: y1, f1 and r5 within BF16_STEP_REL of their
    largest |ref|, the in-kernel error sum within BF16_SQ_REL."""
    ops, _ = _operands(num_blocks, seed=20 + num_blocks)
    jargs = _jax_args(ops, 6.5, 0.25)
    want = jfd.dopri5_step_fused(*jargs, interpret=True, tile=TILE,
                                 precision="bf16", err_stats=(1e-3, 1e-3))
    got = tfd.dopri5_step_fused(*_port_args(ops, 6.5, 0.25),
                                precision="bf16", err_stats=(1e-3, 1e-3))
    for i in (0, 1, 3):
        _close(got[i].numpy(), want[i], BF16_STEP_REL)
    assert got[2].item() == pytest.approx(float(want[2][0, 0]),
                                          rel=BF16_SQ_REL)
    f32 = tfd.dopri5_step_fused(*_port_args(ops, 6.5, 0.25),
                                err_stats=(1e-3, 1e-3))
    assert not np.allclose(f32[1].numpy(), got[1].numpy(), rtol=0,
                           atol=1e-6), "the bf16 branch rounded nothing"


def test_bf16_forward_discrete_adjoint_matches_jax(monkeypatch):
    """The discrete adjoint with a bf16 forward
    (``make_fused_dopri5_hooks(precision="bf16")``, the reference's branch
    for loose tolerances) at rtol = atol = 1e-3, against JAX's discrete
    trainer on its hooks at the same precision (Pallas K5 / K7 in interpret
    mode): loss within BF16_LOSS_REL, gradient cosine > 0.999."""
    import optax

    from _torch_port import make_pair, t32, tlong
    from ananke_abm_tpu.models.gnn_embed import train as jtrain
    from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        flax_leaf_params,
    )

    real_j, real_t = jfd.make_fused_dopri5_hooks, tfd.make_fused_dopri5_hooks
    monkeypatch.setattr(jfd, "make_fused_dopri5_hooks",
                        lambda *a, **kw: real_j(*a, precision="bf16", **kw))
    monkeypatch.setattr(tfd, "make_fused_dopri5_hooks",
                        lambda *a, **kw: real_t(*a, precision="bf16", **kw))
    pair = make_pair(num_blocks=1, n_agents=48, num_times=5, num_zones=10,
                     seed=11, substeps=1, rtol=1e-3, atol=1e-3)
    d = pair.data
    static = tuple(jnp.asarray(d[k]) for k in
                   ("zone_features", "adj", "times"))
    _, jloss = jtrain.make_adjoint_step_fns(
        pair.jmodel, optax.adamw(1e-3), pair.jcfg, static, use_fused=True,
        adjoint_mode="discrete")
    (lj, _), gj = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(d["person_feats"]),
                        jnp.asarray(d["home_zone"]),
                        jnp.asarray(d["zone_ids"])), has_aux=True)(
        pair.params)
    gj = np.concatenate([np.ravel(np.asarray(v)) for v in
                         jax.tree_util.tree_leaves(gj)])
    tstatic = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    stats = {}
    loss_fn = ttrain.build_adjoint_loss_fn_g(
        pair.tmodel, pair.tcfg, tstatic, use_fused=True,
        adjoint_mode="discrete", stats=stats)
    loss, _ = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                      tlong(d["zone_ids"]), tstatic)
    loss.backward()
    gt = np.concatenate([
        np.ravel((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
        for path, p in flax_leaf_params(pair.tmodel)])
    assert stats["forward"]["ok"]
    assert abs(loss.item() - float(lj)) <= BF16_LOSS_REL * abs(float(lj))
    assert gt @ gj / (np.linalg.norm(gt) * np.linalg.norm(gj)) > 0.999
    assert tfd.dopri5_step_fused.launches == 0
