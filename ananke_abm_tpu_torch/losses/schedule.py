"""Schedule-VAE losses (port of ``ananke_abm_tpu/losses/schedule.py``).

Logits are (B, T, P). Where a batch carries padding (the trainer pads its
tail batch with wrapped rows), the means run over a (B,) row-validity
mask, so padded rows contribute nothing.

``group``: the batch's rows lie on the ranks of that process group (a
mesh's ``agents`` group). Every mean then sums its numerator and its
count over the group (``parallel.collectives.sum_to_replicated``), so
each rank holds the whole batch's loss, and its gradient is the share of
its own rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ananke_abm_tpu_torch.parallel.collectives import sum_to_replicated


def _masked_mean(x, mask, group=None):
    """Mean of x over rows where mask is 1. x: (B, ...), mask: (B,)."""
    if mask is None:
        mask = x.new_ones(x.shape[0])
    w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    den = torch.clamp(sum_to_replicated(w.sum(), group), min=1.0) * float(
        math.prod(x.shape[1:]))
    return sum_to_replicated(torch.sum(x * w), group) / den


def _batch_mean(x, mask, group=None):
    """Mean over the batch axis 0, over the valid rows where masked."""
    if mask is None:
        if group is None:
            return x.mean(dim=0)
        mask = x.new_ones(x.shape[0])
    w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    return sum_to_replicated(torch.sum(x * w, dim=0), group) / torch.clamp(
        sum_to_replicated(w.sum(), group), min=1.0)


def _mean(x, mask, group):
    if mask is None and group is None:
        return x.mean()
    return _masked_mean(x, mask, group)


def kl_gaussian(mu, logvar, mask=None, group=None):
    """0.5 * mean(mu^2 + e^logvar - 1 - logvar)."""
    kl = 0.5 * (mu**2 + torch.exp(logvar) - 1.0 - logvar)
    return _mean(kl, mask, group)


def cross_entropy_masked(logits_btp, labels_bt, mask=None, group=None):
    """Mean token cross-entropy, optionally over valid rows only."""
    logp = F.log_softmax(logits_btp, dim=-1)
    nll = -torch.gather(logp, -1, labels_bt[..., None].long())[..., 0]
    return _mean(nll, mask, group)


def time_total_variation(logits_btp, mask=None, group=None):
    """mean |U_{t+1} - U_t| over the logit trajectory."""
    diff = torch.abs(logits_btp[:, 1:, :] - logits_btp[:, :-1, :])
    return _mean(diff, mask, group)


def start_end_home_loss(logits_btp, home_idx, mask=None, group=None):
    """-0.5 * (logP(home | t=0) + logP(home | t=T-1))."""
    logp0 = F.log_softmax(logits_btp[:, 0, :], dim=-1)[:, home_idx]
    logpT = F.log_softmax(logits_btp[:, -1, :], dim=-1)[:, home_idx]
    per_row = -0.5 * (logp0 + logpT)
    return _mean(per_row, mask, group)


def time_of_day_marginal_loss(logits_btp, m_tod_emp_pt, mask=None,
                              group=None):
    """MSE between the batch-mean softmax marginal (P, T) and the empirical
    one; with a row mask the batch mean excludes padding."""
    probs = F.softmax(logits_btp, dim=-1)  # (B, T, P)
    diff = _batch_mean(probs, mask, group).T - m_tod_emp_pt  # (P, T)
    return torch.mean(diff * diff)


def presence_rate_loss(logits_btp, presence_emp_p, mask=None, group=None):
    """Soft presence 1 - prod_t(1 - p_t) against the empirical rate, MSE;
    the product as exp-sum-log, the probabilities clipped below 1."""
    probs = F.softmax(logits_btp, dim=-1)
    log_not = torch.log1p(-torch.clamp(probs, 0.0, 1.0 - 1e-6))
    present = 1.0 - torch.exp(torch.sum(log_not, dim=1))  # (B, P)
    diff = _batch_mean(present, mask, group) - presence_emp_p
    return torch.mean(diff * diff)


def minutes_share_loss(logits_btp, share_emp_p, mask=None, group=None):
    """MSE between the batch's expected minutes share per purpose (softmax
    probabilities averaged over batch and time) and the empirical share."""
    probs = F.softmax(logits_btp, dim=-1)  # (B, T, P)
    if mask is None and group is None:
        share = probs.mean(dim=(0, 1))
    else:
        if mask is None:
            mask = probs.new_ones(probs.shape[0])
        w = mask.to(probs.dtype)[:, None, None]
        share = sum_to_replicated(torch.sum(probs * w, dim=(0, 1)), group) / (
            torch.clamp(sum_to_replicated(w.sum(), group), min=1.0) * probs.shape[1])
    diff = share - share_emp_p
    return torch.mean(diff * diff)
