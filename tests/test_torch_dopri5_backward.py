"""The whole discrete-adjoint backward (K6): its plain version
``dopri5_backward_reference`` against the JAX package's Pallas kernel
``dopri5_backward_fused`` run in interpret mode on the CPU, on the same
synthetic record made with numpy from a seed; the port's
``odeint_discrete_adjoint`` through the hooks' ``backward_all`` against its
per-step path; and bench rung 3's configuration of the discrete trainer
against the JAX package's same call.

Bounds:

- K6 at float32 within 1e-5 of each output's largest |ref|, as the K5 / K7
  parity tests (the same float32 arithmetic, sums in other orders); at
  bf16 cosine > 0.999 per output, the bf16 class (ROADMAP.md, North star):
  the two frameworks round the same bf16 points, but a float32 sum in
  another order now and then rounds the other way, and the flips compound
  over the steps and through the residual blocks;
- the whole backward against the per-step path, both through the port's
  hooks: cosine > 0.99999 for y0 and > 0.9999 for the parameters, the
  reference's bounds for the same comparison
  (tests/test_ops_kernels.py::test_whole_backward_kernel_matches_xla_and_per_step);
- the rung-3 trainer (K5 forward, bf16 K6 backward) against the JAX
  package's same call: the same accepted steps, the loss within 2e-4
  relative (the forward is the float32 solve of both, as in
  test_torch_discrete_adjoint.py), the gradient at cosine > 0.999, the
  bf16 class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from _torch_port import make_pair, t32, tlong
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.ops.pallas import fused_dopri5 as jfd
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import flax_leaf_params
from ananke_abm_tpu_torch.ode import odeint_discrete_adjoint
from ananke_abm_tpu_torch.ode.tree import tree_leaves
from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as tfd

N, DA, DZ, DC, H, Z = 24, 8, 16, 8, 16, 10
MAX_ACC, T = 6, 3


def _record(num_blocks, n_acc, ckpt_dtype, seed):
    """Numpy operands of the whole backward: weights, context, zones, a
    recording of ``n_acc`` of MAX_ACC steps (random checkpoints past
    n_acc too: the backward must not read them) and T output rows: row 0
    filled by no step, row 1 inside step 1, row 2 at the end of the last
    accepted step (theta = 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    w = lambda i, o: f(i, o, scale=1.0 / np.sqrt(i))
    blocks = tuple((w(H, H), f(H, scale=0.1), w(H, H), f(H, scale=0.1))
                   for _ in range(num_blocks))
    weights = (w(DA, DZ), w(DA + DZ, H), w(DC, H), blocks, w(H, DA),
               f(DA, scale=0.1))
    W1t, b1 = w(2, H), f(H, scale=0.1)
    rec_h = np.zeros(MAX_ACC, np.float32)
    rec_t0 = np.zeros(MAX_ACC, np.float32)
    rec_h[:n_acc] = rng.uniform(0.2, 0.5, n_acc).astype(np.float32)
    rec_t0[1:n_acc] = np.cumsum(rec_h[:n_acc - 1], dtype=np.float32)
    ts = np.asarray([0.0, rec_t0[1] + 0.37 * rec_h[1],
                     rec_t0[n_acc - 1] + rec_h[n_acc - 1]], np.float32)
    out_step = np.asarray([-1, 1, n_acc - 1])
    ckpts, ckpt_f = f(MAX_ACC, N, DA), f(MAX_ACC, N, DA, scale=0.3)
    if ckpt_dtype == "bf16":  # the values bf16 storage keeps
        ckpts, ckpt_f = (np.array(jnp.asarray(c).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
                         for c in (ckpts, ckpt_f))
    rec = (ckpts, ckpt_f, f(N, DC), f(Z, DZ), rec_t0, rec_h, n_acc,
           f(T, N, DA), out_step, ts)
    return rec, weights, (W1t, b1)


def _jax_backward(rec, weights, tw, ckpt_dtype, precision):
    (ckpts, ckpt_f, hc, ze, rec_t0, rec_h, n_acc, g, out_step, ts) = rec
    W1t, b1 = map(jnp.asarray, tw)
    tf_all = jnp.stack([jfd.stage_time_rows(jnp.float32(t0), jnp.float32(h),
                                            W1t, b1)
                        for t0, h in zip(rec_t0, rec_h)])
    dt = jnp.bfloat16 if ckpt_dtype == "bf16" else jnp.float32
    wj = jax.tree_util.tree_map(jnp.asarray, weights)
    return jfd.dopri5_backward_fused(
        jnp.asarray(ckpts).astype(dt), jnp.asarray(ckpt_f).astype(dt),
        jnp.asarray(hc), jnp.asarray(ze), tf_all, jnp.asarray(rec_t0),
        jnp.asarray(rec_h), n_acc, jnp.asarray(g), jnp.asarray(out_step),
        jnp.asarray(ts), *wj, interpret=True, precision=precision, tile=8)


def _port_backward(rec, weights, tw, ckpt_dtype, precision):
    (ckpts, ckpt_f, hc, ze, rec_t0, rec_h, n_acc, g, out_step, ts) = rec
    t = lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                   else tuple(t(b) for b in a))
    dt = torch.bfloat16 if ckpt_dtype == "bf16" else torch.float32
    W1t, b1 = t(tw)
    tf_all = tfd.stage_time_table(rec_t0, rec_h, W1t, b1)
    return tfd.dopri5_backward_fused(
        t(ckpts).to(dt), t(ckpt_f).to(dt), t(hc), t(ze), tf_all, rec_t0,
        rec_h, n_acc, t(g), out_step, ts, *t(weights), precision=precision)


def _items(out):
    (gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3) = out
    names = ["gy0", "gf0", "gh", "gze", "gtf_all", "gWq", "gW1xc", "gW1h",
             "gW3", "gb3"]
    items = list(zip(names, [gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gW3,
                             gb3]))
    for i, blk in enumerate(gblocks):
        items += [(f"block{i}[{j}]", w) for j, w in enumerate(blk)]
    return items


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("ckpt_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("num_blocks,n_acc", [(1, MAX_ACC), (2, 4)])
def test_backward_matches_pallas(precision, ckpt_dtype, num_blocks, n_acc):
    rec, weights, tw = _record(num_blocks, n_acc, ckpt_dtype,
                               seed=num_blocks + 3 * n_acc)
    want = _jax_backward(rec, weights, tw, ckpt_dtype, precision)
    got = _port_backward(rec, weights, tw, ckpt_dtype, precision)
    for (name, u), (_, v) in zip(_items(got), _items(want)):
        u = u.numpy().astype(np.float64).ravel()
        v = np.asarray(v, np.float64).ravel()
        assert u.shape == v.shape, name
        assert np.isfinite(u).all(), name
        if precision == "f32":
            assert np.max(np.abs(u - v)) <= 1e-5 * np.max(np.abs(v)), name
        else:
            cos = u @ v / (np.linalg.norm(u) * np.linalg.norm(v))
            assert cos > 0.999, (name, cos)
    # the rows of the steps never taken: exactly zero
    assert not got[4][n_acc:].any()


SETUP = dict(num_blocks=2, n_agents=32, num_times=5, num_zones=10, seed=11,
             substeps=1, rtol=1e-5, atol=1e-7)


def _solve_grads(pair, ckpt_every, precision, keep=False):
    """Gradients of sum(ys * cot) with respect to y0 and every parameter
    of the drift's ``args``, through the port's hooks (the plain versions
    here), at ``ckpt_every``; the solve's stats (with
    ``stats["keep_backward_all"] = keep``); and the arguments each call of
    the hooks' ``backward_all`` was given."""
    model = pair.tmodel
    zf, adj, times, pf, hz = pair.tensors()
    leaves = flax_leaf_params(model)
    by_id = {id(p): name for name, p in model.named_parameters()}
    names = ["model." + by_id[id(p)] for _, p in leaves]
    rhs_module = ttrain._Rhs(model)

    def rhs(t, x, args):
        params, h, ze = args
        return functional_call(rhs_module, dict(zip(names, params)),
                               (t, x, h, ze))

    with torch.no_grad():
        ze = model.encode_zones(zf, adj)
        x0, h = model.initial_state(pf, hz, ze)
    params = tuple(p.detach().clone().requires_grad_(True)
                   for _, p in leaves)
    x0 = x0.detach().requires_grad_(True)
    step_impl, step_vjp = tfd.make_fused_dopri5_hooks(
        model, bwd_precision=precision, err_stats=(1e-5, 1e-7))
    given, whole = [], step_vjp.backward_all

    def backward_all(*a):
        given.append(a)
        return whole(*a)

    step_vjp.backward_all = backward_all
    stats = {"keep_backward_all": keep}
    ys = odeint_discrete_adjoint(
        rhs, x0, times, (params, h, ze), rtol=1e-5, atol=1e-7,
        max_accepted=256, ckpt_every=ckpt_every, store_f=True,
        step_impl=step_impl, step_vjp=step_vjp, stats=stats)
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(ys.shape)).astype(np.float32))
    gy0, *gp = torch.autograd.grad((ys * cot).sum(), [x0, *params],
                                   allow_unused=True)
    flat = torch.cat([torch.zeros_like(p).flatten() if g is None
                      else g.flatten() for g, p in zip(gp, params)])
    return gy0.flatten().double(), flat.double(), stats, given


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_whole_backward_matches_the_per_step_path(precision):
    """``ckpt_every=1`` with the FSAL evals recorded takes the hooks'
    ``backward_all`` (no step VJP counted); ``ckpt_every=2`` the per-step
    loop over the same step VJP."""
    pair = make_pair(**SETUP)
    gy_w, gp_w, st_w, _ = _solve_grads(pair, 1, precision)
    gy_s, gp_s, st_s, _ = _solve_grads(pair, 2, precision)
    assert st_w["vjps"] == st_w["replays"] == 0
    assert st_s["vjps"] == st_s["forward"]["n_accepted"] > 2
    assert st_w["forward"]["n_accepted"] == st_s["forward"]["n_accepted"]
    assert _cos(gy_w, gy_s) > 0.99999
    assert _cos(gp_w, gp_s) > 0.9999


def test_whole_backward_keeps_its_operands_when_asked():
    """With ``stats["keep_backward_all"]`` the whole backward leaves in
    ``stats["backward_all"]`` the arguments it gave ``backward_all``, the
    ``args`` tree as copies of equal value; without it, nothing."""
    pair = make_pair(**SETUP)
    *_, st, given = _solve_grads(pair, 1, "bf16")
    assert "backward_all" not in st and len(given) == 1
    *_, st, given = _solve_grads(pair, 1, "bf16", keep=True)
    (*rec, args), ((*rec_h, args_h),) = st["backward_all"], given
    assert rec[4] == st["forward"]["n_accepted"] and len(rec) == 8
    for kept, hook in zip(rec, rec_h):
        if torch.is_tensor(hook):
            assert kept is hook
        else:
            assert np.array_equal(np.asarray(kept), np.asarray(hook))
    for kept, hook in zip(tree_leaves(args), tree_leaves(args_h)):
        assert kept is not hook and torch.equal(kept, hook)


def test_rung3_configuration_matches_jax():
    """make_adjoint_step_fns(adjoint_mode="discrete", max_accepted=256,
    ckpt_every=1, bwd_precision="bf16"): bf16 checkpoints and FSAL evals,
    K5's plain version forward and K6's backward (use_fused=True: the
    route the card takes), against the JAX package's same call with its
    kernels (the Pallas kernels in interpret mode)."""
    pair = make_pair(**SETUP)
    d = pair.data
    kw = dict(adjoint_mode="discrete", max_accepted=256, ckpt_every=1,
              bwd_precision="bf16", use_fused=True)
    static = (t32(d["zone_features"]), t32(d["adj"]), t32(d["times"]))
    _, loss_fn = ttrain.make_adjoint_step_fns(pair.tmodel, None, pair.tcfg,
                                              static, **kw)
    pair.tmodel.zero_grad()
    lt, _ = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                    tlong(d["zone_ids"]))
    lt.backward()
    st = loss_fn.stats
    assert st["forward"]["ok"] and st["vjps"] == 0
    gt = np.concatenate([
        np.ravel((p.grad.T if path[-1] == "kernel" else p.grad).numpy())
        for path, p in flax_leaf_params(pair.tmodel)])
    jstatic = tuple(jnp.asarray(d[k]) for k in
                    ("zone_features", "adj", "times"))
    _, jloss = jtrain.make_adjoint_step_fns(
        pair.jmodel, optax.adamw(1e-3), pair.jcfg, jstatic, **kw)
    (lj, _), gj = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(d["person_feats"]),
                        jnp.asarray(d["home_zone"]),
                        jnp.asarray(d["zone_ids"])), has_aux=True)(
        pair.params)
    gj = np.concatenate([np.ravel(np.asarray(v)) for v in
                         jax.tree_util.tree_leaves(gj)])
    assert abs(lt.item() - float(lj)) <= 2e-4 * abs(float(lj))
    cos = float(gt @ gj / (np.linalg.norm(gt) * np.linalg.norm(gj)))
    assert cos > 0.999, cos
