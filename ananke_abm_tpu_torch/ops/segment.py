"""Segment ops for sparse edge-list graphs: edge-softmax attention and
segment-sum aggregation (port of ``ananke_abm_tpu/ops/segment.py``).

These are the edge-list counterparts of the dense adjacency-masked GAT
(``models/gnn_embed/gat.py``) for zone graphs too large for dense (Z, Z)
attention. Two routes compute one function:

- the composition of this module (``scatter_reduce_`` / ``index_add_``),
  float32, differentiable by autograd; the reference's XLA path;
- the CSR kernel pair (``ops/cuda/edge_segment.py``): one launch for all
  heads forward, one backward.

``use_kernel="auto"`` takes the kernel pair for CUDA tensors at any zone
count and head width the kernels are compiled for (the reference's Z cap
and width floor were TPU measurements), and the composition for rows wider
than ``edge_segment.MAX_KERNEL_FEATURES`` (``edge_segment.kernels_fit``),
as the reference's XLA path serves any width: the route is chosen before
anything launches. ``True`` forces the kernels' route (their plain
versions on the CPU; on the card the kernels raise on rows too wide),
``False`` the composition.

Segment ids outside ``[0, num_segments)``, negative ones included, are
dropped, as ``jax.ops.segment_sum`` drops them. On either route of the edge
attention a negative id, or a source id outside the node table, raises
(``edge_segment.kept_edges``) before any sum.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ananke_abm_tpu_torch.ops.cuda import edge_segment

SLOPE = 0.2


def _bucketed(ids, n):
    """``ids`` with every id outside ``[0, n)`` sent to the spare row ``n``."""
    return torch.where((ids >= 0) & (ids < n), ids, n)


def _segment_sum(values, ids, n):
    """(n,) + values.shape[1:] sums of ``values`` rows by ``ids``; ids
    outside ``[0, n)`` are dropped."""
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, _bucketed(ids, n), values)[:n]


def segment_softmax(scores, segment_ids, num_segments):
    """Softmax over edges grouped by ``segment_ids`` (e.g. destination node).
    scores: (E, ...) with leading edge axis.

    The per-segment max is subtracted (a segment with no edge takes 0), and
    the denominator is floored at 1e-12. The max carries no gradient: the
    softmax does not depend on it."""
    ids = segment_ids.long()
    n = int(num_segments)
    with torch.no_grad():
        seg_max = scores.new_full((n + 1,) + tuple(scores.shape[1:]),
                                  -torch.inf)
        at = _bucketed(ids, n).reshape((-1,) + (1,) * (scores.dim() - 1))
        seg_max = seg_max.scatter_reduce_(0, at.expand_as(scores),
                                          scores.detach(), "amax")[:n]
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    # rows whose id is dropped read the last segment, as XLA's clamped
    # gather does; the sums below drop them again
    at = torch.clamp(ids, max=max(n - 1, 0))
    ex = torch.exp(scores - seg_max[at])
    denom = _segment_sum(ex, ids, n)
    return ex / torch.clamp_min(denom[at], 1e-12)


def edge_softmax_attention(values, scores, dst_ids, num_nodes):
    """Aggregate edge ``values`` (E, D) into nodes via the per-destination
    softmax of ``scores`` (E,). Returns (num_nodes, D)."""
    alpha = segment_softmax(scores, dst_ids, num_nodes)
    return _segment_sum(values * alpha[:, None], dst_ids.long(),
                        int(num_nodes))


def _use_kernel(use_kernel, t, heads, d):
    """Whether the edge attention of ``heads`` heads of ``d`` features on
    ``t``'s device takes the CSR kernels' route."""
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got "
                         f"{use_kernel!r}")
    if use_kernel == "auto":
        return t.is_cuda and edge_segment.kernels_fit(heads, d)
    return use_kernel


def gat_edge_layer(h, edge_src, edge_dst, W, a_src, a_dst, num_nodes=None,
                   use_kernel: str | bool = "auto"):
    """Sparse single-head GAT layer over an edge list.

    h: (Z, F); W: (F, D); a_src/a_dst: (D,). Equivalent (up to heads) to the
    dense GATLayer with adjacency = edge list: the score of edge j -> i is
    ``leaky_relu(qs[j] + qd[i])`` with ``qs = Wh a_src``, ``qd = Wh a_dst``.
    Returns (num_nodes, D); differentiable on either route.

    ``use_kernel`` as in the module docstring.
    """
    Z = h.shape[0]
    num_nodes = Z if num_nodes is None else int(num_nodes)
    Wh = h @ W  # (Z, D)
    qs = Wh @ a_src  # (Z,)
    qd = Wh @ a_dst
    if _use_kernel(use_kernel, Wh, 1, Wh.shape[1]):
        layout = edge_segment.build_csr(edge_src, edge_dst, num_nodes, Z)
        out = edge_segment.gat_edge_csr(Wh[:, None, :], qd[:, None],
                                        qs[:, None], layout)
        return out[:, 0, :]
    src, dst = edge_segment.kept_edges(edge_src, edge_dst, num_nodes, Z)
    e = F.leaky_relu(qs[src] + qd[dst], negative_slope=SLOPE)  # (E,)
    return edge_softmax_attention(Wh[src], e, dst, num_nodes)


def edges_from_adj(adj):
    """Edge list from a dense {0, 1} adjacency, host-side (numpy).

    ``adj[i, j] != 0`` means a message j -> i (the dense GATLayer's row-wise
    softmax: row i aggregates over columns j). Returns ``(edge_src,
    edge_dst)`` int32 arrays with src=j, dst=i, in row-major order. Build it
    once per graph. For graphs too large to hold as (Z, Z), skip it: any
    ``(edge_src, edge_dst)`` COO pair in this orientation is a valid
    ``edge_index``, and the consumers (``GATLayer``, ``ZoneGAT``,
    ``GATODE.encode_zones``) accept ``adj=None`` beside it.
    """
    if isinstance(adj, torch.Tensor):
        adj = adj.detach().cpu().numpy()
    pairs = np.argwhere(np.asarray(adj) != 0)  # (E, 2) rows (dst, src)
    return pairs[:, 1].astype(np.int32), pairs[:, 0].astype(np.int32)


def gat_edge_attention_multihead(Wh, e_recv, e_send, edge_src, edge_dst,
                                 num_nodes, use_kernel: str | bool = "auto",
                                 layout=None):
    """Multi-head edge-list GAT aggregation: the sparse counterpart of the
    dense ``GATLayer`` attention.

    Wh: (Z, H, d) per-head projected features; ``e_recv`` / ``e_send``:
    (Z, H) attention logits coupling to the receiving (destination) /
    sending (source) node; edges carry messages edge_src -> edge_dst.
    Returns (num_nodes, H, d) with ``out[i] = sum_j alpha_ij Wh[j]``,
    ``alpha_i: = softmax_j`` over i's in-neighbours of ``leaky_relu(
    e_recv[i] + e_send[j], 0.2)``: the dense layer with ``adj[i, j] = 1 <=>
    edge (src=j, dst=i)`` (see :func:`edges_from_adj`).

    ``use_kernel`` as in the module docstring. ``layout``: the edges'
    ``edge_segment.build_csr`` layout for the kernels' route, built here
    when not given (``ZoneGAT`` builds it once for all its layers).
    """
    Z, H, d = Wh.shape
    num_nodes = int(num_nodes)
    if _use_kernel(use_kernel, Wh, H, d):
        if layout is None:
            layout = edge_segment.build_csr(edge_src, edge_dst, num_nodes, Z,
                                            e_recv.shape[0])
        return edge_segment.gat_edge_csr(Wh, e_recv, e_send, layout)
    src, dst = edge_segment.kept_edges(edge_src, edge_dst, num_nodes, Z,
                                       e_recv.shape[0])
    scores = F.leaky_relu(e_recv[dst] + e_send[src],
                          negative_slope=SLOPE)  # (E, H)
    alpha = segment_softmax(scores, dst, num_nodes)
    vals = (Wh[src] * alpha[:, :, None]).reshape(src.shape[0], H * d)
    return _segment_sum(vals, dst, num_nodes).reshape(num_nodes, H, d)


def person_zone_segment_sum(values, zone_ids, num_zones):
    """Aggregate per-person values (N, D) into their zones: (num_zones, D),
    float32 sums of the values as given. Zone ids outside ``[0,
    num_zones)``, negative ones included, are dropped. (The bf16-rounding
    segment sum of the TPU kernel ``segment_sum_pallas`` is
    ``edge_segment.segment_sum``.)"""
    return _segment_sum(values, zone_ids.long(), int(num_zones))


__all__ = [
    "segment_softmax", "edge_softmax_attention", "gat_edge_layer",
    "edges_from_adj", "gat_edge_attention_multihead",
    "person_zone_segment_sum",
]
