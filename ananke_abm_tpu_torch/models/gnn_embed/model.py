"""GAT-ODE (port of ``ananke_abm_tpu/models/gnn_embed/model.py``).

A graph-attention encoder embeds the zone graph; each agent carries a
latent position x(t) whose drift attends over the zone embeddings; RK4
integrates all agents at once; decoding contracts agent positions against
the zone embeddings to give per-time zone logits.

``compute_dtype=torch.bfloat16`` mirrors flax's ``dtype=bfloat16``: the
drift's inputs and weights are rounded to bf16 and its Dense layers emit
bf16, the attention contracts bf16 operands with float32 accumulation,
and the returned derivative is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ananke_abm_tpu_torch.models.gnn_embed.gat import ZoneGAT
from ananke_abm_tpu_torch.ode import odeint


def _mm_f32(a, b):
    """``a @ b`` of operands already rounded to a narrow type, accumulated
    and returned in float32 (``preferred_element_type=float32``)."""
    return a.float() @ b.float()


class AgentDrift(nn.Module):
    """dx/dt = f([x, ctx, h, sin t, cos t]) with a residual MLP.

    ``dense[i]`` is flax's ``Dense_i``: ``dense[0]`` the input layer,
    ``dense[1 + 2i]`` / ``dense[2 + 2i]`` residual block i, ``dense[-1]``
    the output layer.
    """

    def __init__(self, in_features: int, agent_dim: int, hidden_dim: int,
                 num_blocks: int = 2, dtype=torch.float32, *, device):
        super().__init__()
        self.num_blocks = num_blocks
        self.dtype = dtype
        dims = ([(in_features, hidden_dim)]
                + [(hidden_dim, hidden_dim)] * (2 * num_blocks)
                + [(hidden_dim, agent_dim)])
        self.dense = nn.ModuleList(
            nn.Linear(i, o, device=device) for i, o in dims
        )

    def _linear(self, layer, z):
        dt = self.dtype
        return F.linear(z, layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, x, ctx, h, t):
        n = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        ang = t * 2 * math.pi / 24.0
        sin_t = torch.sin(ang).expand(n, 1)
        cos_t = torch.cos(ang).expand(n, 1)
        z = torch.cat([x, ctx, h, sin_t, cos_t], dim=-1).to(self.dtype)
        z = torch.tanh(self._linear(self.dense[0], z))
        for i in range(self.num_blocks):
            r = torch.tanh(self._linear(self.dense[1 + 2 * i], z))
            r = self._linear(self.dense[2 + 2 * i], r)
            z = torch.tanh(z + r)
        return self._linear(self.dense[-1], z).float()


class GATODE(nn.Module):
    """Flagship graph-ODE model over (agents x zones)."""

    def __init__(self, num_zone_features: int, person_feat_dim: int,
                 zone_dim: int = 64, agent_dim: int = 32,
                 context_dim: int = 32, hidden_dim: int = 128,
                 gat_heads: int = 4, gat_layers: int = 2,
                 num_blocks: int = 2, attn_temp: float = 1.0,
                 compute_dtype=torch.float32, *, device):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.zone_dim = zone_dim
        self.agent_dim = agent_dim
        self.num_blocks = num_blocks
        self.attn_temp = attn_temp
        self.compute_dtype = compute_dtype
        self.zone_gat = ZoneGAT(num_zone_features, zone_dim, gat_heads,
                                gat_layers, device=device)
        self.context_encoder = nn.Sequential(
            nn.Linear(person_feat_dim, hidden_dim, device=device),
            nn.ReLU(),
            nn.Linear(hidden_dim, context_dim, device=device),
        )
        self.query_proj = nn.Linear(agent_dim, zone_dim, bias=False,
                                    device=device)
        self.drift = AgentDrift(
            agent_dim + zone_dim + context_dim + 2, agent_dim, hidden_dim,
            num_blocks, compute_dtype, device=device,
        )
        self.init_proj = nn.Linear(zone_dim + context_dim, agent_dim,
                                   device=device)
        self.decode_proj = nn.Linear(agent_dim, zone_dim, bias=False,
                                     device=device)

    def encode_zones(self, zone_feats, adj, edge_index=None,
                     edge_chunks=None):
        """(Z, Dz) zone embeddings."""
        return self.zone_gat(zone_feats, adj, edge_index, edge_chunks)

    def zone_attention(self, x, zone_emb):
        """Bipartite person->zone attention. x: (N, Da) -> ctx (N, Dz)."""
        dt = self.compute_dtype
        q = self.query_proj(x).to(dt)
        ze = zone_emb.to(dt)
        scores = _mm_f32(q, ze.T) / (
            self.attn_temp * math.sqrt(float(zone_emb.shape[-1]))
        )
        attn = torch.softmax(scores, dim=-1).to(dt)  # max-subtracted
        return _mm_f32(attn, ze)

    def initial_state(self, person_feats, home_zone_ids, zone_emb):
        h = self.context_encoder(person_feats)  # (N, context_dim)
        x0 = self.init_proj(torch.cat([zone_emb[home_zone_ids], h], dim=-1))
        return x0, h

    def rhs(self, t, x, h, zone_emb):
        return self.drift(x, self.zone_attention(x, zone_emb), h, t)

    def decode(self, x, zone_emb):
        """x: (..., Da) -> zone logits (..., Z)."""
        return self.decode_proj(x) @ zone_emb.T

    def forward(self, zone_feats, adj, person_feats, home_zone_ids, times,
                *, ode_method: str = "rk4", substeps: int = 4,
                rtol: float = 1e-5, atol: float = 1e-5,
                checkpoint: bool = True, edge_index=None, edge_chunks=None):
        """Full integrate-then-decode. Returns (logits (N, T, Z), xs (N, T, Da)).

        ``ode_method``: "rk4", "euler" or "dopri5" (adaptive at
        ``rtol``/``atol``, forward only, as the reference runs it here)."""
        zone_emb = self.encode_zones(zone_feats, adj, edge_index,
                                     edge_chunks)
        x0, h = self.initial_state(person_feats, home_zone_ids, zone_emb)
        xs = odeint(
            lambda t, x, args: self.rhs(t, x, h, zone_emb), x0, times,
            method=ode_method, substeps=substeps, rtol=rtol, atol=atol,
            adjoint=False, checkpoint=checkpoint,
        )  # (T, N, Da)
        xs = xs.transpose(0, 1)
        return self.decode(xs, zone_emb), xs
