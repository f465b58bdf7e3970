"""Graph-attention zone encoder (port of ``ananke_abm_tpu/models/gnn_embed/gat.py``).

Dense branch only: adjacency-masked (Z, Z) multi-head attention. The
sparse edge-list branch of the reference is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30
# flax's LayerNorm default; torch's is 1e-5
LAYERNORM_EPS = 1e-6

_SPARSE_TODO = (
    "sparse edge-list zone graphs (edge_index / edge_chunks) are not "
    "ported yet: ROADMAP.md queue 1 item 9"
)


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

    def forward(self, h, adj, edge_index=None, edge_chunks=None):
        """h: (Z, F_in), adj: (Z, Z) {0,1} with self loops -> (Z, features)."""
        if edge_index is not None or edge_chunks is not None:
            raise NotImplementedError(_SPARSE_TODO)
        if adj is None:
            raise ValueError("GATLayer needs `adj` (dense path)")
        Z = h.shape[0]
        Wh = self.proj(h).reshape(Z, self.heads, -1)  # (Z, H, d)
        # a_src couples to the RECEIVING row i, a_dst to the neighbour j
        e_src = torch.einsum("zhd,hd->zh", Wh, self.a_src)
        e_dst = torch.einsum("zhd,hd->zh", Wh, self.a_dst)
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
        if edge_index is not None or edge_chunks is not None:
            raise NotImplementedError(_SPARSE_TODO)
        h = self.inp(zone_feats)
        for layer, norm in zip(self.layers, self.norms):
            h = h + F.elu(layer(h, adj))
            h = norm(h)
        return h
