"""Schedule-VAE losses (port of ``ananke_abm_tpu/losses/schedule.py``).

Logits are (B, T, P). Where a batch carries padding (the trainer pads its
tail batch with wrapped rows), the means run over a (B,) row-validity
mask, so padded rows contribute nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(x, mask):
    """Mean of x over rows where mask is 1. x: (B, ...), mask: (B,)."""
    w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    den = torch.clamp(w.sum(), min=1.0) * (x.numel() / x.shape[0])
    return torch.sum(x * w) / den


def _batch_mean(x, mask):
    """Mean over the batch axis 0, over the valid rows where masked."""
    if mask is None:
        return x.mean(dim=0)
    w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.sum(x * w, dim=0) / torch.clamp(w.sum(), min=1.0)


def kl_gaussian(mu, logvar, mask=None):
    """0.5 * mean(mu^2 + e^logvar - 1 - logvar)."""
    kl = 0.5 * (mu**2 + torch.exp(logvar) - 1.0 - logvar)
    return kl.mean() if mask is None else _masked_mean(kl, mask)


def cross_entropy_masked(logits_btp, labels_bt, mask=None):
    """Mean token cross-entropy, optionally over valid rows only."""
    logp = F.log_softmax(logits_btp, dim=-1)
    nll = -torch.gather(logp, -1, labels_bt[..., None].long())[..., 0]
    return nll.mean() if mask is None else _masked_mean(nll, mask)


def time_total_variation(logits_btp, mask=None):
    """mean |U_{t+1} - U_t| over the logit trajectory."""
    diff = torch.abs(logits_btp[:, 1:, :] - logits_btp[:, :-1, :])
    return diff.mean() if mask is None else _masked_mean(diff, mask)


def start_end_home_loss(logits_btp, home_idx, mask=None):
    """-0.5 * (logP(home | t=0) + logP(home | t=T-1))."""
    logp0 = F.log_softmax(logits_btp[:, 0, :], dim=-1)[:, home_idx]
    logpT = F.log_softmax(logits_btp[:, -1, :], dim=-1)[:, home_idx]
    per_row = -0.5 * (logp0 + logpT)
    return per_row.mean() if mask is None else _masked_mean(per_row, mask)


def time_of_day_marginal_loss(logits_btp, m_tod_emp_pt, mask=None):
    """MSE between the batch-mean softmax marginal (P, T) and the empirical
    one; with a row mask the batch mean excludes padding."""
    probs = F.softmax(logits_btp, dim=-1)  # (B, T, P)
    diff = _batch_mean(probs, mask).T - m_tod_emp_pt  # (P, T)
    return torch.mean(diff * diff)


def presence_rate_loss(logits_btp, presence_emp_p, mask=None):
    """Soft presence 1 - prod_t(1 - p_t) against the empirical rate, MSE;
    the product as exp-sum-log, the probabilities clipped below 1."""
    probs = F.softmax(logits_btp, dim=-1)
    log_not = torch.log1p(-torch.clamp(probs, 0.0, 1.0 - 1e-6))
    present = 1.0 - torch.exp(torch.sum(log_not, dim=1))  # (B, P)
    diff = _batch_mean(present, mask) - presence_emp_p
    return torch.mean(diff * diff)


def minutes_share_loss(logits_btp, share_emp_p, mask=None):
    """MSE between the batch's expected minutes share per purpose (softmax
    probabilities averaged over batch and time) and the empirical share."""
    probs = F.softmax(logits_btp, dim=-1)  # (B, T, P)
    if mask is None:
        share = probs.mean(dim=(0, 1))
    else:
        w = mask.to(probs.dtype)[:, None, None]
        share = torch.sum(probs * w, dim=(0, 1)) / (
            torch.clamp(w.sum(), min=1.0) * probs.shape[1])
    diff = share - share_emp_p
    return torch.mean(diff * diff)
