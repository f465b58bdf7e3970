"""Graph-attention zone encoder (port of ``ananke_abm_tpu/models/gnn_embed/gat.py``).

Multi-head GAT over the zone graph. Two attention paths share one parameter
set:

- dense (default): adjacency-masked (Z, Z) attention;
- sparse: pass ``edge_index``, COO ``(edge_src, edge_dst)`` integer arrays
  or tensors (``adj[i, j] != 0 <=> (src=j, dst=i)``; from a dense matrix by
  ``ops.segment.edges_from_adj``, or built directly, in which case ``adj``
  may be ``None``), to run the same math over the edge list
  (``ops.segment.gat_edge_attention_multihead``: on CUDA the CSR kernel
  pair, on the CPU the composition). Same parameters; float32 on either
  route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ananke_abm_tpu_torch.ops.cuda import edge_segment
from ananke_abm_tpu_torch.ops.segment import gat_edge_attention_multihead

NEG = -1e30
# flax's LayerNorm default; torch's is 1e-5
LAYERNORM_EPS = 1e-6


class GATLayer(nn.Module):
    def __init__(self, in_features: int, features: int, heads: int = 4, *,
                 device):
        super().__init__()
        if features % heads:
            raise ValueError(f"features={features} not divisible by "
                             f"heads={heads}")
        self.features = features
        self.heads = heads
        d = features // heads
        self.proj = nn.Linear(in_features, features, bias=False,
                              device=device)
        self.a_src = nn.Parameter(torch.empty(heads, d, device=device))
        self.a_dst = nn.Parameter(torch.empty(heads, d, device=device))

    def forward(self, h, adj, edge_index=None, edge_chunks=None,
                layout=None):
        """h: (Z, F_in), adj: (Z, Z) {0,1} with self loops -> (Z, features).

        ``edge_index``: ``(edge_src, edge_dst)`` integer tensors equivalent
        to ``adj``; when given, attention runs over the edge list with the
        same parameters and ``adj`` is not read (it may be ``None``).
        ``layout``: the edges' ``edge_segment.build_csr`` layout, shared by
        the layers of one encode. ``edge_chunks`` is accepted for the
        reference's signature and ignored: its block-pair chunks exist
        because Mosaic cannot gather rows, and the CSR kernels gather them.
        """
        del edge_chunks
        if edge_index is None and adj is None:
            raise ValueError("GATLayer needs `adj` (dense path) or "
                             "`edge_index` (sparse path); both were None")
        Z = h.shape[0]
        Wh = self.proj(h).reshape(Z, self.heads, -1)  # (Z, H, d)
        # a_src couples to the RECEIVING row i, a_dst to the neighbour j
        e_src = torch.einsum("zhd,hd->zh", Wh, self.a_src)
        e_dst = torch.einsum("zhd,hd->zh", Wh, self.a_dst)
        if edge_index is not None:
            out = gat_edge_attention_multihead(
                Wh, e_src, e_dst, edge_index[0], edge_index[1], Z,
                layout=layout)
            return out.reshape(Z, self.features)
        scores = F.leaky_relu(
            e_src[:, None, :] + e_dst[None, :, :], negative_slope=0.2
        )  # (Zi, Zj, H)
        scores = torch.where(
            adj[:, :, None] > 0, scores, scores.new_tensor(NEG)
        )
        alpha = torch.softmax(scores, dim=1)
        out = torch.einsum("ijh,jhd->ihd", alpha, Wh)  # (Z, H, d)
        return out.reshape(Z, self.features)


class ZoneGAT(nn.Module):
    """Stack of GAT layers with residual connections -> zone embeddings."""

    def __init__(self, in_features: int, features: int = 64, heads: int = 4,
                 num_layers: int = 2, *, device):
        super().__init__()
        self.heads = heads
        self.num_layers = num_layers
        self.inp = nn.Linear(in_features, features, device=device)
        self.layers = nn.ModuleList(
            GATLayer(features, features, heads, device=device)
            for _ in range(num_layers)
        )
        self.norms = nn.ModuleList(
            nn.LayerNorm(features, eps=LAYERNORM_EPS, device=device)
            for _ in range(num_layers)
        )

    def forward(self, zone_feats, adj, edge_index=None, edge_chunks=None):
        """(Z, features) zone embeddings; ``edge_index`` / ``edge_chunks`` as
        in :meth:`GATLayer.forward`. On the kernels' route (the card, at
        the widths ``edge_segment.kernels_fit`` takes) the edges' CSR
        layout is built once here and shared by every layer; wider rows
        take the composition and build none."""
        layout = None
        if edge_index is not None:
            Z, dev = zone_feats.shape[0], zone_feats.device
            edge_index = tuple(torch.as_tensor(e, device=dev).long()
                               for e in edge_index)
            d = self.inp.out_features // self.heads
            if zone_feats.is_cuda and edge_segment.kernels_fit(self.heads,
                                                               d):
                layout = edge_segment.build_csr(*edge_index, Z, Z)
        h = self.inp(zone_feats)
        for layer, norm in zip(self.layers, self.norms):
            h = h + F.elu(layer(h, adj, edge_index, layout=layout))
            h = norm(h)
        return h
