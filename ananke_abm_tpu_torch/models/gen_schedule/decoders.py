"""Schedule decoders: latent -> (B, T, P) logits (port of
``ananke_abm_tpu/models/gen_schedule/decoders.py``).

A low-rank factorisation: a learned time basis (T, H) contracted with
latent-derived per-purpose factors (B, P, H), one batched matmul; in the
PDS variant plus an additive bias computed from fixed Purpose Distribution
Space features.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _contract(time_basis, factors):
    """einsum("th,bph->btp"): (B, P, H) x (H, T) -> (B, T, P)."""
    return torch.matmul(factors, time_basis.T).transpose(1, 2)


class ScheduleDecoderLowRank(nn.Module):
    """logits[b, t, p] = <time_basis[t], factor[b, p]> + bias[p]."""

    def __init__(self, T: int, P: int, emb_dim: int, z_dim: int):
        super().__init__()
        self.P, self.emb_dim = P, emb_dim
        self.time_basis = nn.Parameter(torch.zeros(T, emb_dim))
        self.latent_to_factor = nn.Linear(z_dim, P * emb_dim)
        self.bias = nn.Parameter(torch.zeros(P))

    def forward(self, z):
        factors = self.latent_to_factor(z).reshape(-1, self.P, self.emb_dim)
        return _contract(self.time_basis, factors) + self.bias


class ScheduleDecoderPDS(nn.Module):
    """Low-rank latent pathway + an additive bias from ``pds_features``
    (P, T, D): a shared no-bias linear to a (P, T) score plus a learned
    per-purpose bias, transposed to (T, P) and broadcast over the batch."""

    def __init__(self, T: int, P: int, emb_dim: int, z_dim: int,
                 pds_dim: int = 2):
        super().__init__()
        self.P, self.emb_dim = P, emb_dim
        self.latent_proj_in = nn.Linear(z_dim, emb_dim)
        self.latent_proj_out = nn.Linear(emb_dim, P * emb_dim)
        self.time_basis = nn.Parameter(torch.zeros(T, emb_dim))
        self.latent_bias = nn.Parameter(torch.zeros(P))
        self.pds_linear = nn.Linear(pds_dim, 1, bias=False)
        self.pds_bias = nn.Parameter(torch.zeros(P))

    def forward(self, z, pds_features):
        h = F.relu(self.latent_proj_in(z))
        factors = self.latent_proj_out(h).reshape(-1, self.P, self.emb_dim)
        latent = _contract(self.time_basis, factors) + self.latent_bias
        pds_score = self.pds_linear(pds_features)[..., 0]  # (P, T)
        pds_score = (pds_score + self.pds_bias[:, None]).T  # (T, P)
        return latent + pds_score[None]
