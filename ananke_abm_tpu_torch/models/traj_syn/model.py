"""TrajEmbed: a schedule VAE with FiLM purpose-catalog conditioning (port
of ``ananke_abm_tpu/models/traj_syn/model.py``).

The latent pathway produces per-purpose factors that a FiLM layer
modulates with the purposes catalog's statistics, so purposes with similar
real-world statistics share decoder structure. The encoder is the schedule
VAE's CNN encoder. ``forward(y, purpose_feats) -> (logits, mu, logvar)``;
training mode (``model.train()``) turns on dropout.

Weights across packages: :func:`load_flax_params` / :func:`to_flax_params`
read and write the JAX package's flax tree, ``encoder/...`` (the CNN
encoder's names, ``gen_schedule/params.py``) and ``decoder/{time_basis,
latent_to_factor, film, bias}``. :func:`init_params` initialises as flax
does, in distribution.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ananke_abm_tpu_torch.models.gen_schedule.decoders import _contract
from ananke_abm_tpu_torch.models.gen_schedule.encoders import (
    ScheduleEncoderCNN,
    reparameterize,
)
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    _linear,
    encoder_entries,
    entries_to_flax,
    load_entries,
)
from ananke_abm_tpu_torch.models.gen_schedule.vae import (
    _variance_scaling,
    init_params as _init_schedule_params,
)


class FiLMDecoder(nn.Module):
    """Low-rank time-basis decoder with FiLM modulation per purpose:
    logits[b, t, p] = <time_basis[t], factor[b, p] (1 + scale[p]) +
    shift[p]> + bias[p], (scale, shift) a linear map of purpose p's
    catalog features."""

    def __init__(self, T: int, P: int, emb_dim: int, z_dim: int,
                 feat_dim: int = 8):
        super().__init__()
        self.P, self.emb_dim = P, emb_dim
        self.time_basis = nn.Parameter(torch.zeros(T, emb_dim))
        self.latent_to_factor = nn.Linear(z_dim, P * emb_dim)
        self.film = nn.Linear(feat_dim, 2 * emb_dim)
        self.bias = nn.Parameter(torch.zeros(P))

    def forward(self, z, purpose_feats):
        """z (B, z_dim); purpose_feats (P, F) catalog features."""
        factors = self.latent_to_factor(z).reshape(-1, self.P, self.emb_dim)
        scale, shift = torch.chunk(self.film(purpose_feats), 2, dim=-1)
        factors = factors * (1.0 + scale)[None] + shift[None]
        return _contract(self.time_basis, factors) + self.bias


class TrajEmbedVAE(nn.Module):
    def __init__(self, L: int, P: int, z_dim: int, emb_dim: int,
                 cnn_channels: Sequence[int] = (64, 64), cnn_kernel: int = 5,
                 cnn_dropout: float = 0.1, feat_dim: int = 8):
        super().__init__()
        self.L, self.P, self.z_dim = L, P, z_dim
        self.encoder = ScheduleEncoderCNN(P, z_dim, emb_dim,
                                          tuple(cnn_channels), cnn_kernel,
                                          cnn_dropout)
        self.decoder = FiLMDecoder(L, P, emb_dim, z_dim, feat_dim)

    def encode(self, y_seq, generator=None):
        return self.encoder(y_seq, generator)

    def decode(self, z, purpose_feats):
        return self.decoder(z, purpose_feats)

    def forward(self, y_seq, purpose_feats, generator=None, eps=None):
        """``generator`` draws the dropout masks and then eps; ``eps``
        (B, z_dim), when given, replaces the draw."""
        mu, logvar = self.encode(y_seq, generator)
        z = reparameterize(mu, logvar, generator, eps)
        return self.decode(z, purpose_feats), mu, logvar

    def sample_from_prior(self, generator, batch_size: int, purpose_feats):
        z = torch.randn((batch_size, self.z_dim), generator=generator,
                        device=generator.device)
        return self.decode(z, purpose_feats)


@torch.no_grad()
def init_params(model: TrajEmbedVAE, generator: torch.Generator) -> None:
    """Initialise as flax initialises the reference, in distribution: the
    encoder and the Dense layers as the schedule VAE's (lecun-normal
    truncated kernels, zero biases), the time basis xavier-normal
    (truncated), the purpose bias 0. ``generator`` is a CPU generator."""
    _init_schedule_params(model, generator)
    T, H = model.decoder.time_basis.shape
    t = torch.empty(T, H)
    _variance_scaling(t, (T + H) / 2.0, generator)
    model.decoder.time_basis.copy_(t)
    model.decoder.bias.zero_()


def param_entries(model: TrajEmbedVAE) -> dict:
    """flax path -> (layout, [PyTorch views]) for every parameter."""
    out = encoder_entries(model.encoder)
    dec, D = model.decoder, ("decoder",)
    out[D + ("time_basis",)] = ("=", [dec.time_basis])
    _linear(D + ("latent_to_factor",), dec.latent_to_factor, out)
    _linear(D + ("film",), dec.film, out)
    out[D + ("bias",)] = ("=", [dec.bias])
    return out


def load_flax_params(model: TrajEmbedVAE, params: dict) -> None:
    """Copy the JAX package's flax ``params`` tree into ``model``."""
    load_entries(param_entries(model), params)


def to_flax_params(model: TrajEmbedVAE) -> dict:
    """The model's parameters as a flax ``params`` tree of numpy arrays."""
    return entries_to_flax(param_entries(model))
