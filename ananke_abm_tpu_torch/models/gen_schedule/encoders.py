"""Schedule encoders: a residual Conv1D stack and a bidirectional RNN
(port of ``ananke_abm_tpu/models/gen_schedule/encoders.py``).

(B, T) int labels -> embed -> feature extractor -> (mu, logvar), each
(B, z_dim). The convolutions run channels-first, (B, C, T), with "same"
padding, which pads as flax's ``padding="SAME"`` does.

- ``norm="group"``: ``nn.GroupNorm(min(8, C), C)`` with flax's eps 1e-6.
- ``norm="batch"``: ``nn.BatchNorm1d`` (momentum 0.1, eps 1e-5), which the
  reference's ``SyncBatchNorm`` reproduces: its running ``mean`` / ``var``
  ride ``batch_stats`` in the checkpoints (``params.py``). Under a mesh
  (:func:`set_batch_norm_group`) its statistics run over the whole batch
  (:class:`SyncBatchNorm1d`).
- Dropout is a mask drawn from an explicit ``torch.Generator`` (the
  reference draws it from its ``dropout`` key), applied only in training
  mode and only at a rate above 0.
- The RNN encoder is one bidirectional ``nn.GRU`` or ``nn.LSTM``: the
  reference's forward and reversed ``nn.RNN`` over flax's ``GRUCell`` /
  ``OptimizedLSTMCell``. flax's GRU has no bias on its hidden r and z
  gates and its LSTM none on its input gates; the matching parts of
  PyTorch's biases stay zero (their gradients are zeroed by hooks).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ananke_abm_tpu_torch.utils.seed import draw


def dropout(h, rate: float, training: bool,
            generator: Optional[torch.Generator]):
    """Inverted dropout with a mask drawn from ``generator`` (a
    ``utils.seed.RowDraws`` draws the whole batch's mask and keeps its
    rows)."""
    if not training or rate == 0.0:
        return h
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    keep = 1.0 - rate
    mask = draw(torch.rand, h.shape, generator, h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


class SyncBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over (B, C, T) whose training-mode statistics,
    with ``group`` set, run over the rows of every rank of that process
    group (the reference's ``SyncBatchNorm`` under a mesh): the sums of x
    and x^2 and the count are summed over the group with their gradient
    (``parallel.collectives.all_reduce_sum``); the normalisation takes the
    biased variance, the running update the unbiased one, as
    ``nn.BatchNorm1d``. ``torch.nn.SyncBatchNorm`` refuses CPU tensors.
    With ``group`` None it is ``nn.BatchNorm1d``."""

    group = None

    def forward(self, x):
        if not (self.training and self.group is not None):
            return super().forward(x)
        from ananke_abm_tpu_torch.parallel.collectives import all_reduce_sum

        C = x.shape[1]
        stats = all_reduce_sum(torch.cat([
            x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)),
            x.new_tensor([x.shape[0] * x.shape[2]])]), self.group)
        s, ss, n = stats[:C], stats[C:2 * C], stats[2 * C].detach()
        mean = s / n
        var = ss / n - mean * mean  # biased, for the normalisation
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * unbiased)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None]) * (inv * self.weight)[None, :, None]
                + self.bias[None, :, None])


# the reference's name for the same layer
SyncBatchNorm = SyncBatchNorm1d


def set_batch_norm_group(model: nn.Module, group) -> None:
    """Point every :class:`SyncBatchNorm1d` of ``model`` at ``group`` (the
    mesh's ``agents`` group; None: per-rank statistics)."""
    for m in model.modules():
        if isinstance(m, SyncBatchNorm1d):
            m.group = group


def make_norm(norm: str, features: int) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(min(8, features), features, eps=1e-6)
    if norm == "batch":
        return SyncBatchNorm1d(features, eps=1e-5, momentum=0.1)
    raise ValueError(f"Unknown norm {norm!r}; use group|batch")


class ResidualConvBlock(nn.Module):
    """Conv -> norm -> relu -> dropout -> Conv -> norm, relu(residual +
    out); a 1x1 convolution on the residual when the channels change."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dropout: float, norm: str = "group"):
        super().__init__()
        self.rate = float(dropout)
        self.conv0 = nn.Conv1d(in_features, features, kernel_size,
                               padding="same")
        self.norm0 = make_norm(norm, features)
        self.conv1 = nn.Conv1d(features, features, kernel_size,
                               padding="same")
        self.norm1 = make_norm(norm, features)
        self.proj = (nn.Conv1d(in_features, features, 1)
                     if in_features != features else None)

    def forward(self, x, generator=None):
        # x: (B, C_in, T)
        h = F.relu(self.norm0(self.conv0(x)))
        h = dropout(h, self.rate, self.training, generator)
        h = self.norm1(self.conv1(h))
        residual = x if self.proj is None else self.proj(x)
        return F.relu(h + residual)


class ScheduleEncoderCNN(nn.Module):
    """(B, T) int labels -> (mu, logvar) each (B, z_dim)."""

    def __init__(self, P: int, z_dim: int, emb_dim: int,
                 cnn_channels: Sequence[int] = (64, 64), cnn_kernel: int = 5,
                 cnn_dropout: float = 0.1, norm: str = "group"):
        super().__init__()
        self.embed = nn.Embedding(P, emb_dim)
        blocks, c = [], emb_dim
        for ch in cnn_channels:
            blocks.append(ResidualConvBlock(c, ch, cnn_kernel, cnn_dropout,
                                            norm))
            c = ch
        self.blocks = nn.ModuleList(blocks)
        self.mu = nn.Linear(c, z_dim)
        self.logvar = nn.Linear(c, z_dim)

    def forward(self, y_seq, generator=None):
        x = self.embed(y_seq).transpose(1, 2)  # (B, E, T)
        for block in self.blocks:
            x = block(x, generator)
        pooled = x.mean(dim=2)  # global average over time
        return self.mu(pooled), self.logvar(pooled)


class ScheduleEncoderRNN(nn.Module):
    """Bidirectional recurrent encoder; summary = concat(final forward,
    final backward hidden states h). ``cell`` "gru" or "lstm"."""

    def __init__(self, P: int, z_dim: int, emb_dim: int,
                 rnn_hidden_dim: int = 64, use_emb_layernorm: bool = False,
                 cell: str = "gru"):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"Unknown rnn cell {cell!r}; use gru|lstm")
        self.cell = cell
        self.embed = nn.Embedding(P, emb_dim)
        self.norm = nn.LayerNorm(emb_dim, eps=1e-6) if use_emb_layernorm \
            else None
        rnn = nn.GRU if cell == "gru" else nn.LSTM
        self.rnn = rnn(emb_dim, rnn_hidden_dim, batch_first=True,
                       bidirectional=True)
        self.mu = nn.Linear(2 * rnn_hidden_dim, z_dim)
        self.logvar = nn.Linear(2 * rnn_hidden_dim, z_dim)
        for name, mask in self.zero_bias_masks().items():
            getattr(self.rnn, name).register_hook(
                lambda g, m=mask: g * m.to(g.device, g.dtype))

    def zero_bias_masks(self) -> dict:
        """PyTorch bias name -> 0/1 mask of the entries flax has no
        parameter for: the GRU's hidden r and z biases, the LSTM's input
        biases. They stay zero."""
        H = self.rnn.hidden_size
        out = {}
        for sfx in ("_l0", "_l0_reverse"):
            if self.cell == "gru":
                m = torch.ones(3 * H)
                m[: 2 * H] = 0.0
                out["bias_hh" + sfx] = m
            else:
                out["bias_ih" + sfx] = torch.zeros(4 * H)
        return out

    def forward(self, y_seq, generator=None):
        emb = self.embed(y_seq)  # (B, T, E)
        if self.norm is not None:
            emb = self.norm(emb)
        _, carry = self.rnn(emb)
        h = carry[0] if self.cell == "lstm" else carry  # (2, B, H)
        summary = torch.cat([h[0], h[1]], dim=-1)
        return self.mu(summary), self.logvar(summary)


def reparameterize(mu, logvar, generator=None, eps=None):
    """mu + exp(logvar / 2) * eps, eps ~ N(0, I) from ``generator`` unless
    given (tests pass the reference's draw)."""
    if eps is None:
        eps = draw(torch.randn, mu.shape, generator, mu.device, mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps
