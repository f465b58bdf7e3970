"""The port's segment ops (``ananke_abm_tpu_torch/ops/segment.py``) and the
plain versions of its CSR edge kernels (``ops/cuda/edge_segment.py``)
against the JAX package on the same numpy inputs.

Bounds:

- the ops against ``ananke_abm_tpu.ops.segment`` with ``use_pallas=False``
  (both float32 compositions): forward rtol / atol 2e-5, gradients rtol
  5e-4 / atol 5e-5, the bounds of tests/test_gnn_embed.py's sparse-vs-dense
  encoder test;
- the plain CSR versions against the Pallas kernels run in interpret mode
  (bf16 features, hi/lo bf16 scores): max |got - want| / max |want| < 2e-2
  (for the gradients over at least the cotangent x feature scale), the
  bound of tests/test_ops_kernels.py and tests/test_edge_gather.py for
  those kernels against the XLA composition.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.ops import segment as jseg
from ananke_abm_tpu.ops.pallas.edge_gather import (
    build_edge_chunks,
    gat_edge_aggregate_gather_pallas,
)
from ananke_abm_tpu.ops.pallas.edge_segment import (
    gat_edge_aggregate_multihead_pallas,
    gat_edge_aggregate_pallas,
    gat_edge_backward_multihead_pallas,
)
from ananke_abm_tpu_torch.ops import segment as tseg
from ananke_abm_tpu_torch.ops.cuda import edge_segment as es

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
KERNEL_REL = 2e-2
ROUTES = [False, True]  # the composition, the kernels' route (plain here)


def _graph(Z, E, H, d, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, Z, E).astype(np.int32)
    dst = rng.integers(0, Z, E).astype(np.int32)
    wh = rng.normal(size=(Z, H, d)).astype(np.float32)
    e_recv = (rng.normal(size=(Z, H)) * scale).astype(np.float32)
    e_send = (rng.normal(size=(Z, H)) * scale).astype(np.float32)
    g = rng.normal(size=(Z, H, d)).astype(np.float32)
    return src, dst, wh, e_recv, e_send, g


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _rel(got, want, scale=0.0):
    """max |got - want| over max(max |want|, scale, 1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), scale, 1e-6)


@pytest.mark.parametrize("delta", [-5, 0, 10])
@pytest.mark.parametrize("route", ROUTES)
def test_multihead_matches_jax(delta, route):
    """Values and gradients of gat_edge_attention_multihead, with num_nodes
    below, at and above the node count (edges past num_nodes dropped)."""
    Z, E, H, d = 30, 200, 2, 8
    num_nodes = Z + delta
    src, dst, wh, er, esd, g = _graph(Z, E, H, d, seed=13)
    gn = np.random.default_rng(1).normal(size=(num_nodes, H, d)).astype(
        np.float32)

    def jloss(wh, er, esd):
        out = jseg.gat_edge_attention_multihead(
            wh, er, esd, jnp.asarray(src), jnp.asarray(dst), num_nodes,
            use_pallas=False)
        return jnp.sum(out * gn), out

    (_, want), gw = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(wh, er, esd)
    t = [_t(a, True) for a in (wh, er, esd)]
    got = tseg.gat_edge_attention_multihead(*t, _t(src), _t(dst), num_nodes,
                                            use_kernel=route)
    assert tuple(got.shape) == (num_nodes, H, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    gt = torch.autograd.grad(torch.sum(got * _t(gn)), t)
    for a, b in zip(gt, gw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("delta", [-5, 0, 10])
@pytest.mark.parametrize("route", ROUTES)
def test_single_head_layer_matches_jax(delta, route):
    """gat_edge_layer (K9a's caller): values and gradients."""
    Z, E, D, Fin = 30, 200, 8, 6
    num_nodes = Z + delta
    rng = np.random.default_rng(13)
    h = rng.normal(size=(Z, Fin)).astype(np.float32)
    src = rng.integers(0, Z, E).astype(np.int32)
    dst = rng.integers(0, Z, E).astype(np.int32)
    W = (rng.normal(size=(Fin, D)) * 0.3).astype(np.float32)
    a1 = (rng.normal(size=(D,)) * 0.3).astype(np.float32)
    a2 = (rng.normal(size=(D,)) * 0.3).astype(np.float32)

    def jloss(h, W, a1, a2):
        out = jseg.gat_edge_layer(h, jnp.asarray(src), jnp.asarray(dst), W,
                                  a1, a2, num_nodes=num_nodes,
                                  use_pallas=False)
        return jnp.sum(out ** 2), out

    (_, want), gw = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(h, W, a1, a2)
    t = [_t(a, True) for a in (h, W, a1, a2)]
    got = tseg.gat_edge_layer(t[0], _t(src), _t(dst), *t[1:],
                              num_nodes=num_nodes, use_kernel=route)
    assert tuple(got.shape) == (num_nodes, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    gt = torch.autograd.grad(torch.sum(got ** 2), t)
    for a, b in zip(gt, gw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_segment_softmax_and_sums_match_jax():
    rng = np.random.default_rng(5)
    E, n = 300, 40
    scores = rng.normal(size=(E, 3)).astype(np.float32) * 4
    ids = rng.integers(0, n + 6, E).astype(np.int32)  # some dropped
    np.testing.assert_allclose(
        tseg.segment_softmax(_t(scores), _t(ids), n).numpy(),
        np.asarray(jseg.segment_softmax(scores, ids, n)), **FWD_TOL)
    vals = rng.normal(size=(E, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tseg.edge_softmax_attention(_t(vals), _t(scores[:, 0]), _t(ids),
                                    n).numpy(),
        np.asarray(jseg.edge_softmax_attention(vals, scores[:, 0], ids, n)),
        **FWD_TOL)
    np.testing.assert_allclose(
        tseg.person_zone_segment_sum(_t(vals), _t(ids), n).numpy(),
        np.asarray(jseg.person_zone_segment_sum(vals, ids, n)), **FWD_TOL)


def test_edges_from_adj_matches_jax():
    adj = (np.random.default_rng(2).random((17, 17)) < 0.2).astype(
        np.float32)
    for got, want in zip(tseg.edges_from_adj(adj), jseg.edges_from_adj(adj)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tseg.edges_from_adj(torch.tensor(adj)),
                         jseg.edges_from_adj(adj)):
        np.testing.assert_array_equal(got, want)


def test_csr_layout():
    """Kept edges in a stable destination sort (duplicates kept), the
    source-major order of the same edges, and the refusals."""
    src = torch.tensor([3, 1, 1, 0, 2, 1, 0])
    dst = torch.tensor([2, 0, 2, 5, 0, 0, 2])
    lay = es.build_csr(src, dst, num_nodes=4, num_src=4)
    assert lay.row_ptr.tolist() == [0, 3, 3, 6, 6]
    assert lay.src.tolist() == [1, 2, 1, 3, 1, 0]  # the dst=5 edge dropped
    assert lay.dst.tolist() == [0, 0, 0, 2, 2, 2]
    assert lay.col_ptr.tolist() == [0, 1, 4, 5, 6]
    assert lay.dst_by_src.tolist() == [2, 0, 0, 2, 0, 2]
    assert all(t.dtype == torch.int32 for t in lay[:5])
    with pytest.raises(IndexError, match="source"):
        es.build_csr(src, dst, 4, num_src=3)
    with pytest.raises(IndexError, match="negative"):
        es.build_csr(src, torch.tensor([0, 0, 0, -1, 0, 0, 0]), 4, 4)
    with pytest.raises(IndexError, match="receiving"):
        es.build_csr(src, dst, num_nodes=8, num_src=4)
    with pytest.raises(IndexError, match="source"):
        tseg.gat_edge_attention_multihead(
            torch.zeros(4, 1, 2), torch.zeros(4, 1), torch.zeros(4, 1),
            torch.tensor([4]), torch.tensor([0]), 4, use_kernel=False)
    empty = es.build_csr(torch.zeros(0, dtype=torch.long),
                         torch.zeros(0, dtype=torch.long), 3, 3)
    out, lse = es.gat_edge_csr_forward_reference(
        torch.ones(3, 2, 4), torch.ones(3, 2), torch.ones(3, 2), empty)
    assert not out.any() and not lse.any()


def test_wrappers_take_their_plain_versions_on_the_cpu():
    src, dst, wh, er, esd, g = _graph(20, 90, 4, 16, seed=2)
    lay = es.build_csr(torch.tensor(src), torch.tensor(dst), 20, 20)
    ops = [_t(a) for a in (wh, er, esd)]
    before = (es.gat_edge_csr_forward.launches,
              es.gat_edge_csr_backward.launches)
    out, lse = es.gat_edge_csr_forward(*ops, lay)
    want = es.gat_edge_csr_forward_reference(*ops, lay)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    corr = torch.sum(_t(g) * out, dim=-1)
    got = es.gat_edge_csr_backward(_t(g), *ops, lse, corr, lay)
    for a, b in zip(got, es.gat_edge_csr_backward_reference(
            _t(g), *ops, lse, corr, lay)):
        assert torch.equal(a, b)
    assert (es.gat_edge_csr_forward.launches,
            es.gat_edge_csr_backward.launches) == before
    with pytest.raises(TypeError, match="float32"):
        es.gat_edge_csr_forward(ops[0].double(), *ops[1:], lay)
    with pytest.raises(ValueError, match="shape"):
        es.gat_edge_csr_forward(ops[0][:5], *ops[1:], lay)


def test_kernels_fit():
    """Rows of up to MAX_KERNEL_FEATURES features, in heads of any width
    (a width that neither divides 32 nor is a multiple of it straddles
    lanes: the backward sums its heads through shared memory)."""
    assert es.kernels_fit(4, 16) and es.kernels_fit(1, 64)
    assert es.kernels_fit(2, 8) and es.kernels_fit(1, 256)
    assert es.kernels_fit(4, 12) and es.kernels_fit(3, 48)
    assert es.kernels_fit(85, 3)
    assert not es.kernels_fit(1, 288) and not es.kernels_fit(3, 96)
    assert not es.kernels_fit(0, 16) and not es.kernels_fit(4, 0)


@pytest.mark.parametrize("heads,d,want", [
    (4, 16, True), (4, 64, True), (1, 256, True), (85, 3, True),
    (4, 128, False), (1, 257, False), (8, 64, False),
])
def test_auto_route_takes_the_kernels_only_where_they_fit(heads, d, want):
    """``use_kernel="auto"`` takes the CSR kernels for tensors on the card
    at the widths they are compiled for (``kernels_fit``), the composition
    past ``MAX_KERNEL_FEATURES`` features a row, and the composition for
    every CPU tensor; ``True`` forces the kernels' route."""
    on_card = types.SimpleNamespace(is_cuda=True)
    assert tseg._use_kernel("auto", on_card, heads, d) is want
    assert want is es.kernels_fit(heads, d)
    assert tseg._use_kernel("auto", torch.zeros(1), heads, d) is False
    assert tseg._use_kernel(True, on_card, heads, d) is True
    assert tseg._use_kernel(False, on_card, heads, d) is False


# ---- the plain CSR versions against the Pallas kernels (interpret mode) ---

@pytest.mark.parametrize("Z,E,D,delta", [(64, 500, 16, 0), (30, 200, 8, -5),
                                          (30, 200, 8, 10)])
def test_forward_plain_matches_single_head_pallas(Z, E, D, delta):
    """K9a: one head, Wh (Zs, D), qs/qd (Zs,)."""
    src, dst, wh, er, esd, _ = _graph(Z, E, 1, D, seed=Z + E)
    num_nodes = Z + delta
    want = gat_edge_aggregate_pallas(
        jnp.asarray(wh[:, 0]), jnp.asarray(esd[:, 0]), jnp.asarray(er[:, 0]),
        jnp.asarray(src), jnp.asarray(dst), num_nodes=num_nodes,
        interpret=True)
    lay = es.build_csr(_t(src), _t(dst), num_nodes, Z)
    got, _ = es.gat_edge_csr_forward_reference(_t(wh), _t(er), _t(esd), lay)
    assert _rel(got[:, 0].numpy(), want) < KERNEL_REL


@pytest.mark.parametrize("Z,E,H,d,delta,scale", [
    (64, 500, 4, 16, 0, 0.3), (130, 1500, 2, 8, 0, 0.3),
    (30, 200, 2, 8, -5, 0.3), (30, 200, 2, 8, 10, 0.3),
    (64, 500, 4, 16, 0, 60.0),
])
def test_plain_pair_matches_multihead_pallas(Z, E, H, d, delta, scale):
    """K9b forward and K9c backward: the kernels' output and gradients
    (dWh, dqs = d_send, dqd = d_recv) against the plain CSR pair. The
    gradients' scale is at least the cotangent x feature scale, as
    tests/test_ops_kernels.py holds K9c: where the attention saturates the
    true score gradients collapse to ~0 and the kernel's bf16 rounding
    does not."""
    src, dst, wh, er, esd, _ = _graph(Z, E, H, d, seed=Z + E, scale=scale)
    num_nodes = Z + delta
    g = np.random.default_rng(7).normal(size=(num_nodes, H, d)).astype(
        np.float32)
    j = [jnp.asarray(a) for a in (wh, esd, er, src, dst)]
    out, denom, shift = gat_edge_aggregate_multihead_pallas(
        *j, num_nodes=num_nodes, interpret=True, return_residuals=True)
    dwh, dqs, dqd = gat_edge_backward_multihead_pallas(
        *j, jnp.asarray(g), out, denom, shift, num_nodes=num_nodes,
        interpret=True)
    lay = es.build_csr(_t(src), _t(dst), num_nodes, Z)
    ops = [_t(a) for a in (wh, er, esd)]
    t_out, lse = es.gat_edge_csr_forward_reference(*ops, lay)
    assert _rel(t_out.numpy(), out) < KERNEL_REL
    corr = torch.sum(_t(g) * t_out, dim=-1)
    t_dwh, t_drecv, t_dsend = es.gat_edge_csr_backward_reference(
        _t(g), *ops, lse, corr, lay)
    g_scale = float(np.abs(g).max() * np.abs(wh).max())
    assert _rel(t_dwh.numpy(), dwh, g_scale) < KERNEL_REL
    assert _rel(t_dsend.numpy(), dqs, g_scale) < KERNEL_REL
    assert _rel(t_drecv.numpy(), dqd, g_scale) < KERNEL_REL


def test_plain_forward_matches_block_pair_pallas():
    """K9d: the large-Z block-pair kernel over build_edge_chunks (identity
    ordering, as tests/test_edge_gather.py runs it at this size)."""
    Z, E = 700, 1500
    src, dst, wh, er, esd, _ = _graph(Z, E, 4, 16, seed=3, scale=1.0)
    ch = build_edge_chunks(src, dst, Z, tile_e=512, reorder="none")
    want = gat_edge_aggregate_gather_pallas(
        jnp.asarray(wh), jnp.asarray(esd), jnp.asarray(er), ch,
        interpret=True)
    lay = es.build_csr(_t(src), _t(dst), Z, Z)
    got, _ = es.gat_edge_csr_forward_reference(_t(wh), _t(er), _t(esd), lay)
    assert _rel(got.numpy(), want) < KERNEL_REL
