"""The schedule VAE: encoder + reparameterisation + decoder (port of
``ananke_abm_tpu/models/gen_schedule/vae.py``), and its initialisation
with flax's initialisers (:func:`init_params`).

``forward(y) -> (logits, mu, logvar)``; prior sampling through
``decode(z)`` / ``sample_from_prior``. Training mode (``model.train()``)
turns on dropout and batch statistics, as the reference's
``deterministic=False`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ananke_abm_tpu_torch.models.gen_schedule.decoders import (
    ScheduleDecoderLowRank,
    ScheduleDecoderPDS,
)
from ananke_abm_tpu_torch.models.gen_schedule.encoders import (
    ScheduleEncoderCNN,
    ScheduleEncoderRNN,
    reparameterize,
)


class ScheduleVAE(nn.Module):
    """``encoder_kind`` in {"cnn", "rnn"}; ``use_pds`` switches the decoder
    to the PDS-conditioned variant (``pds_features`` then required)."""

    def __init__(self, L: int, P: int, z_dim: int, emb_dim: int,
                 encoder_kind: str = "cnn",
                 cnn_channels: Sequence[int] = (64, 64), cnn_kernel: int = 5,
                 cnn_dropout: float = 0.1, cnn_norm: str = "group",
                 rnn_hidden_dim: int = 64, use_emb_layernorm: bool = False,
                 rnn_cell: str = "gru", use_pds: bool = False):
        super().__init__()
        self.L, self.P, self.z_dim, self.use_pds = L, P, z_dim, use_pds
        if encoder_kind == "cnn":
            self.encoder = ScheduleEncoderCNN(
                P, z_dim, emb_dim, tuple(cnn_channels), cnn_kernel,
                cnn_dropout, cnn_norm)
        elif encoder_kind == "rnn":
            self.encoder = ScheduleEncoderRNN(
                P, z_dim, emb_dim, rnn_hidden_dim, use_emb_layernorm,
                rnn_cell)
        else:
            raise ValueError(f"Unknown encoder_kind {encoder_kind!r}")
        decoder = ScheduleDecoderPDS if use_pds else ScheduleDecoderLowRank
        self.decoder = decoder(L, P, emb_dim, z_dim)

    def encode(self, y_seq, generator=None):
        return self.encoder(y_seq, generator)

    def decode(self, z, pds_features: Optional[torch.Tensor] = None):
        if self.use_pds:
            return self.decoder(z, pds_features)
        return self.decoder(z)

    def forward(self, y_seq, generator=None, pds_features=None, eps=None):
        """``generator`` draws the dropout masks and then eps; ``eps``
        (B, z_dim), when given, replaces the draw."""
        mu, logvar = self.encode(y_seq, generator)
        z = reparameterize(mu, logvar, generator, eps)
        return self.decode(z, pds_features), mu, logvar

    def sample_from_prior(self, generator, batch_size: int,
                          pds_features=None):
        z = torch.randn((batch_size, self.z_dim), generator=generator,
                        device=generator.device)
        return self.decode(z, pds_features)


# flax's truncated normal draws in [-2, 2] standard deviations, rescaled so
# the kept part has the variance asked for
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(t, fan, generator, truncated=True):
    std = math.sqrt(1.0 / fan)
    if truncated:
        std /= _TRUNC_STD
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    else:
        nn.init.normal_(t, 0.0, std, generator=generator)


@torch.no_grad()
def init_params(model: ScheduleVAE, generator: torch.Generator) -> None:
    """Initialise ``model`` as flax initialises the reference, in
    distribution: lecun-normal (truncated) Dense and Conv kernels with zero
    biases, ``Embed`` a normal of stddev 1/sqrt(emb_dim), orthogonal
    recurrent kernels, norms at scale 1 and bias 0, the low-rank decoder's
    time basis 0.01 N(0, 1) and the PDS decoder's xavier-normal
    (truncated). ``generator`` is a CPU generator; the draws are copied to
    the model's device, so the same seed gives the same weights anywhere.
    """
    def fill(param, draw):
        t = torch.empty(param.shape)
        draw(t)
        param.copy_(t)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            fill(m.weight, lambda t: _variance_scaling(t, fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            fill(m.weight, lambda t: _variance_scaling(
                t, t.shape[1], generator, truncated=False))
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm1d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, (nn.GRU, nn.LSTM)):
            H = m.hidden_size
            for sfx in ("_l0", "_l0_reverse"):
                w_ih = getattr(m, "weight_ih" + sfx)
                w_hh = getattr(m, "weight_hh" + sfx)
                for g in range(w_ih.shape[0] // H):
                    fill(w_ih[g * H:(g + 1) * H], lambda t: _variance_scaling(
                        t, w_ih.shape[1], generator))
                    fill(w_hh[g * H:(g + 1) * H], lambda t: nn.init.
                         orthogonal_(t, generator=generator))
                getattr(m, "bias_ih" + sfx).zero_()
                getattr(m, "bias_hh" + sfx).zero_()
        elif isinstance(m, ScheduleDecoderLowRank):
            fill(m.time_basis, lambda t: t.normal_(generator=generator)
                 .mul_(0.01))
            m.bias.zero_()
        elif isinstance(m, ScheduleDecoderPDS):
            T, H = m.time_basis.shape
            fill(m.time_basis, lambda t: _variance_scaling(
                t, (T + H) / 2.0, generator))
            m.latent_bias.zero_()
            m.pds_bias.zero_()
