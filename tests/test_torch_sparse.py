"""Sparse edge-list zone graphs through the port, against the JAX package
on the same worlds and flax parameters: the edge branch of ``GATLayer`` and
``ZoneGAT``, ``GATODE.encode_zones`` / ``forward``, the rematerialised
fixed-step solvers, ``make_step_fns`` and the discrete-adjoint loss on a
sparse static, the sparse rollout and ``serve()`` of a sparse-world
checkpoint (``train(sparse_zones=, sparse_world=)``: tests/test_torch_train.py).

Bounds are those of the JAX package's own tests of the same functions:

- encoder values rtol / atol 2e-5 and parameter gradients rtol 5e-4 /
  atol 5e-5 (tests/test_gnn_embed.py, sparse against dense);
- whole-day logits rtol 1e-5 and atol 1e-4 (tests/test_torch_modules.py:
  2 substeps of RK4 over the day accumulate float32 rounding), the atol
  scaled to 2e-6 of the largest logit where that is larger: at the
  shipping widths the logits reach 260, where JAX's own sparse and dense
  forwards differ by 1.8e-4 and the port's dense forward differs from
  JAX's by 2.7e-4;
- one SGD step: loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5
  (tests/test_torch_train.py, the accumulated epoch);
- the discrete-adjoint loss within 2e-4 relative, gradient cosine > 0.999
  (tests/test_torch_discrete_adjoint.py);
- served ids agree >= 0.999.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import TINY, agreement, make_pair, t32, tlong
from ananke_abm_tpu.data_generator.agent_trajectories import (
    generate_agent_population,
)
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu.models.gnn_embed.gat import GATLayer as JGATLayer
from ananke_abm_tpu.models.gnn_embed.rollout import (
    make_decoded_rollout as jax_rollout,
)
from ananke_abm_tpu.ode.rk4 import rk4_solve as jax_rk4
from ananke_abm_tpu.ops.segment import edges_from_adj
from ananke_abm_tpu.utils import save_checkpoint as jax_save
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    flax_leaf_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.ode.rk4 import euler_solve, rk4_solve

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DAY_ATOL = 1e-4
LOGIT_ATOL_SCALE = 2e-6
F32_IDS_MIN = 0.999

CASES = {
    "tiny": dict(num_blocks=1),
    # the shipping encoder: 4 heads of 16, 2 layers
    "full": dict(num_blocks=2, full=True, num_zones=40, gat_layers=2),
}


def _asymmetric_graph(Z, seed, p=0.15):
    """A directed random graph with self loops (no edge's reverse is
    implied), as a dense matrix and its edge list: a swap of the sending
    and receiving logits shows here."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((Z, Z)) < p).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    return adj, edges_from_adj(adj)


def _flat_grads(model):
    """Every parameter's gradient in flax's leaf order and layout (zeros
    where none reached it, as jax.grad gives)."""
    out = []
    for path, p in flax_leaf_params(model):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        out.append(np.ravel((g.T if path[-1] == "kernel" else g).numpy()))
    return np.concatenate(out)


def _jflat(tree):
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree_util.tree_leaves(tree)])


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return make_pair(n_agents=24, num_times=5, **CASES[request.param])


def test_gat_layer_edge_branch_matches_jax(pair):
    """One GATLayer over an asymmetric edge list, adj=None, against flax's
    layer with the same parameters: values and input gradient."""
    Z = pair.data["zone_features"].shape[0]
    adj, (src, dst) = _asymmetric_graph(Z, seed=4)
    layer = pair.tmodel.zone_gat.layers[0]
    feats = layer.proj.in_features
    h = np.random.default_rng(1).normal(size=(Z, feats)).astype(np.float32)
    jl = JGATLayer(layer.features, layer.heads)
    p = {"params": pair.params["zone_gat"]["GATLayer_0"]}
    ei = (jnp.asarray(src), jnp.asarray(dst))
    want, vjp = jax.vjp(lambda x: jl.apply(p, x, None, ei), jnp.asarray(h))
    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    (want_gh,) = vjp(jnp.asarray(g))
    th = t32(h).requires_grad_()
    got = layer(th, None, (tlong(src), tlong(dst)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    # the dense branch of the same layer, with the same graph
    np.testing.assert_allclose(layer(th, t32(adj)).detach().numpy(),
                               np.asarray(want), **FWD_TOL)
    (gh,) = torch.autograd.grad(got, th, t32(g))
    np.testing.assert_allclose(gh.numpy(), np.asarray(want_gh), **GRAD_TOL)
    with pytest.raises(ValueError, match="both were None"):
        layer(th, None)


def test_encode_zones_sparse_matches_jax(pair):
    """ZoneGAT through GATODE.encode_zones: the world's graph with adj=None
    and an asymmetric graph, against JAX's sparse and dense encoders, values
    and every parameter's gradient."""
    m, p = pair.jmodel, {"params": pair.params}
    zf = pair.data["zone_features"]
    Z = zf.shape[0]
    adj_w = pair.data["adj"]
    for adj, (src, dst) in ((adj_w, edges_from_adj(adj_w)),
                            _asymmetric_graph(Z, seed=9)):
        ei = (jnp.asarray(src), jnp.asarray(dst))
        g = np.random.default_rng(Z).normal(size=(Z, m.zone_dim)).astype(
            np.float32)

        def jloss(params):
            ze = m.apply({"params": params}, zf, None, ei,
                         method=m.encode_zones)
            return jnp.sum(ze * g), ze

        (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(pair.params)
        dense = m.apply(p, zf, adj, method=m.encode_zones)
        np.testing.assert_allclose(np.asarray(want), np.asarray(dense),
                                   **FWD_TOL)
        pair.tmodel.zero_grad()
        got = pair.tmodel.encode_zones(t32(zf), None,
                                       (tlong(src), tlong(dst)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD_TOL)
        torch.sum(got * t32(g)).backward()
        np.testing.assert_allclose(_flat_grads(pair.tmodel), _jflat(jg),
                                   **GRAD_TOL)


def test_forward_sparse_matches_jax(pair):
    """GATODE.forward on the edge list (adj=None): the whole day's logits."""
    zf, adj, times, pf, hz = pair.arrays()
    src, dst = edges_from_adj(adj)
    m = pair.jmodel
    want, _ = m.apply({"params": pair.params}, zf, None, pf, hz, times,
                      substeps=2, edge_index=(jnp.asarray(src),
                                              jnp.asarray(dst)))
    with torch.no_grad():
        got, _ = pair.tmodel(t32(zf), None, t32(pf), tlong(hz), t32(times),
                             substeps=2, edge_index=(tlong(src), tlong(dst)))
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5,
        atol=max(DAY_ATOL, LOGIT_ATOL_SCALE * np.abs(want).max()))


@pytest.mark.parametrize("solve", [rk4_solve, euler_solve])
def test_remat_gives_the_same_gradient_bits(solve):
    """checkpoint=True recomputes each interval in the backward: the same
    values and the same gradient bits as checkpoint=False, with the
    gradients reaching the closure's tensors; under no_grad nothing is
    recomputed."""
    rng = np.random.default_rng(3)
    A = t32(rng.normal(size=(6, 6)) * 0.3)
    y0 = t32(rng.normal(size=(5, 6)))
    ts = t32(np.linspace(0.0, 2.0, 6))
    calls = []

    def run(checkpoint):
        a = A.clone().requires_grad_()
        y = y0.clone().requires_grad_()

        def rhs(t, x, args):
            calls.append(1)
            return torch.tanh(x @ a) * torch.cos(t)

        ys = solve(rhs, y, ts, substeps=3, checkpoint=checkpoint)
        ga, gy = torch.autograd.grad(torch.sum(ys ** 2), (a, y))
        return ys.detach(), ga, gy

    plain = run(False)
    n_plain = len(calls)
    calls.clear()
    remat = run(True)
    for u, v in zip(remat, plain):
        assert torch.equal(u, v)
    assert len(calls) == 2 * n_plain  # the forward, then once more
    calls.clear()
    with torch.no_grad():
        solve(lambda t, x, args: calls.append(1) or x, y0, ts, substeps=3)
    assert len(calls) == n_plain


def test_rk4_remat_matches_jax_gradients():
    """The rematerialised solver's gradients against jax.grad of the
    reference's (also checkpointed) solver."""
    rng = np.random.default_rng(8)
    A = (rng.normal(size=(4, 4)) * 0.5).astype(np.float32)
    y0 = rng.normal(size=(3, 4)).astype(np.float32)
    ts = np.linspace(0.0, 1.5, 4).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(jax_rk4(
        lambda t, y, a: jnp.tanh(y @ a), jnp.asarray(y0), jnp.asarray(ts),
        a, substeps=2) ** 2))(jnp.asarray(A))
    a = t32(A).requires_grad_()
    ys = rk4_solve(lambda t, y, a: torch.tanh(y @ a), t32(y0), t32(ts), a,
                   substeps=2)
    (ga,) = torch.autograd.grad(torch.sum(ys ** 2), a)
    np.testing.assert_allclose(ga.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)


def _sparse_statics(pair):
    d = pair.data
    src, dst = edges_from_adj(d["adj"])
    j = (jnp.asarray(d["zone_features"]), None, jnp.asarray(d["times"]),
         (jnp.asarray(src), jnp.asarray(dst)))
    t = (t32(d["zone_features"]), None, t32(d["times"]),
         (tlong(src), tlong(dst)))
    return j, t


def test_make_step_fns_sparse_static_matches_jax():
    """One SGD step of make_step_fns on the 4-element sparse static (adj
    None) in both packages, and against the port's dense static."""
    pair = make_pair(num_blocks=1, n_agents=32, num_times=5, num_zones=10,
                     seed=7)
    d = pair.data
    jstatic, tstatic = _sparse_statics(pair)
    opt = optax.sgd(1e-2)
    step_j, _ = jtrain.make_step_fns(pair.jmodel, opt, pair.jcfg, jstatic)
    batch_j = tuple(jnp.asarray(d[k]) for k in
                    ("person_feats", "home_zone", "zone_ids"))
    pj, _, lj, _ = step_j(pair.params, opt.init(pair.params), *batch_j)
    batch = (t32(d["person_feats"]), tlong(d["home_zone"]),
             tlong(d["zone_ids"]))
    start = {k: v.clone() for k, v in pair.tmodel.state_dict().items()}
    losses = {}
    for name, static in (("dense", (tstatic[0], t32(d["adj"]),
                                    tstatic[2])), ("sparse", tstatic)):
        pair.tmodel.load_state_dict(start)
        sgd = torch.optim.SGD(pair.tmodel.parameters(), lr=1e-2)
        step, _ = ttrain.make_step_fns(pair.tmodel, sgd, pair.tcfg, static)
        losses[name] = step(*batch)[0].item()
    assert losses["sparse"] == pytest.approx(losses["dense"], rel=1e-6)
    assert losses["sparse"] == pytest.approx(float(lj), rel=1e-5)
    np.testing.assert_allclose(_jflat(to_flax_params(pair.tmodel)),
                               _jflat(pj), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="dense-only"):
        ttrain.make_fused_train_step(pair.tmodel, None, pair.tcfg, tstatic)


def test_discrete_adjoint_sparse_static_matches_jax():
    """build_adjoint_loss_fn_g(adjoint_mode="discrete") on a sparse static
    threads the edge list into its encoder, as JAX's does."""
    pair = make_pair(num_blocks=1, n_agents=32, num_times=5, num_zones=10,
                     seed=11, substeps=1, rtol=1e-5, atol=1e-7)
    d = pair.data
    jstatic, tstatic = _sparse_statics(pair)
    _, loss = jtrain.make_adjoint_step_fns(
        pair.jmodel, optax.adamw(1e-3), pair.jcfg, jstatic, use_fused=False,
        adjoint_mode="discrete")
    (lj, _), g = jax.value_and_grad(
        lambda p: loss(p, jnp.asarray(d["person_feats"]),
                       jnp.asarray(d["home_zone"]),
                       jnp.asarray(d["zone_ids"])), has_aux=True)(
        pair.params)
    losses = []
    for use_fused in (False, True):
        loss_fn = ttrain.build_adjoint_loss_fn_g(
            pair.tmodel, pair.tcfg, tstatic, use_fused=use_fused,
            adjoint_mode="discrete")
        pair.tmodel.zero_grad()
        lt, _ = loss_fn(t32(d["person_feats"]), tlong(d["home_zone"]),
                        tlong(d["zone_ids"]), tstatic)
        lt.backward()
        gt, gj = _flat_grads(pair.tmodel), _jflat(g)
        assert abs(lt.item() - float(lj)) <= 2e-4 * abs(float(lj))
        assert gt @ gj / (np.linalg.norm(gt) * np.linalg.norm(gj)) > 0.999
        losses.append(lt.item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)


def test_sparse_rollout_matches_jax():
    """make_decoded_rollout(edge_index=) takes the float32 body whatever
    use_kernel says, in both packages."""
    pair = make_pair(num_blocks=2, n_agents=64, num_times=6, num_zones=12)
    zf, adj, times, pf, hz = pair.arrays()
    src, dst = edges_from_adj(adj)
    jr = jax_rollout(pair.jmodel, pair.jcfg, jnp.asarray(zf), None,
                     jnp.asarray(times), use_pallas=False,
                     edge_index=(jnp.asarray(src), jnp.asarray(dst)))
    want = np.asarray(jr(pair.params, jnp.asarray(pf), jnp.asarray(hz)))
    for use_kernel in (False, True):
        tr = make_decoded_rollout(pair.tmodel, pair.tcfg, t32(zf), None,
                                  t32(times), use_kernel=use_kernel,
                                  edge_index=(tlong(src), tlong(dst)))
        got = tr(t32(pf), tlong(hz)).numpy()
        assert got.shape == want.shape == (64, 6)
        assert agreement(got, want) >= F32_IDS_MIN


def test_sparse_world_checkpoint_is_served_by_both_packages(tmp_path):
    """A sparse-world checkpoint (the world regenerated as an edge list)
    written by the JAX package, served by both."""
    world = dict(num_zones=20, num_times=6)
    data = generate_agent_population(8, sparse_world=True, seed=0, **world)
    cfg = jtrain.GATODEConfig(num_blocks=2, **TINY)
    jmodel = jtrain.build_model(cfg, data["zone_features"].shape[-1],
                                data["person_feats"].shape[-1])
    params = jtrain.init_params(jmodel, cfg, data, 8, jax.random.PRNGKey(5),
                                edge_index=tuple(map(jnp.asarray,
                                                     data["edge_index"])))
    ckpt = tmp_path / "sparse.ckpt"
    jax_save({"params": params, "config": dataclasses.asdict(cfg),
              "history": [], "world_seed": 0, "sparse_world": True,
              **world}, str(ckpt))
    jtrain.serve(str(ckpt), str(tmp_path / "jax.npz"), n_agents=96, seed=2,
                 use_pallas=False)
    info = ttrain.serve(str(ckpt), str(tmp_path / "port.npz"), n_agents=96,
                        seed=2, device="cpu")
    with np.load(tmp_path / "jax.npz") as j, np.load(
            tmp_path / "port.npz") as t:
        assert t["zone_ids"].shape == j["zone_ids"].shape == (96, 6)
        assert agreement(t["zone_ids"], j["zone_ids"]) >= F32_IDS_MIN
    assert info["num_times"] == 6
