"""Linear-chain CRF recursions over the time axis (port of
``ananke_abm_tpu/ops/crf.py``).

Each ``lax.scan`` of the reference is a Python loop over T of batched
(B, P, P) tensor operations: O(T) launches, no host synchronisation
inside. Ties in every max go to the first index, as ``jnp.argmax`` does.

The constrained "no-all-home" decode runs the same batched Viterbi over
the augmented states P x {0, 1} (v = "visited a non-home state yet").
"""
from __future__ import annotations

import torch

from ananke_abm_tpu_torch.parallel.collectives import sum_to_replicated

NEG_INF = -1e30


def _forward_step(alpha, u_t, A_pp):
    # alpha: (B, P); scores[b, p_prev, p_next] = alpha + A
    return torch.logsumexp(alpha[:, :, None] + A_pp[None], dim=1) + u_t


def crf_log_partition(unaries_btp, A_pp):
    """log Z via the forward algorithm. unaries (B, T, P), A[prev, next]
    (P, P) -> (B,)."""
    alpha = unaries_btp[:, 0]
    for t in range(1, unaries_btp.shape[1]):
        alpha = _forward_step(alpha, unaries_btp[:, t], A_pp)
    return torch.logsumexp(alpha, dim=-1)


def crf_path_score(unaries_btp, labels_bt, A_pp):
    """Score of a label path: sum_t U[t, y_t] + sum_{t>0} A[y_{t-1}, y_t]."""
    labels = labels_bt.long()
    unary = torch.gather(unaries_btp, -1, labels[..., None])[..., 0].sum(-1)
    pair = A_pp[labels[:, :-1], labels[:, 1:]].sum(dim=-1)
    return unary + pair


def _row_mean(per_row, mask_b, group):
    """The mean of (B,) ``per_row`` over the rows ``mask_b`` weights (all
    where None); with ``group`` over the rows of every rank of that process
    group, a value each rank then holds
    (``parallel.collectives.sum_to_replicated``)."""
    if group is None and mask_b is None:
        return per_row.mean()
    if mask_b is None:
        mask_b = torch.ones_like(per_row)
    return sum_to_replicated(torch.sum(per_row * mask_b), group) / \
        torch.clamp(sum_to_replicated(mask_b.sum(), group), min=1.0)


def crf_nll(unaries_btp, labels_bt, A_pp, mask_b=None, group=None):
    """Mean negative log-likelihood over the batch; ``mask_b`` optional (B,)
    row weights (padded rows 0); ``group``: the batch's rows lie on that
    process group's ranks (:func:`_row_mean`)."""
    per_row = (crf_log_partition(unaries_btp, A_pp)
               - crf_path_score(unaries_btp, labels_bt, A_pp))
    return _row_mean(per_row, mask_b, group)


def crf_marginals(unaries_btp, A_pp):
    """Posterior state marginals p(y_t = p | U) by forward-backward:
    (B, T, P) probabilities."""
    T = unaries_btp.shape[1]
    alphas = [unaries_btp[:, 0]]
    for t in range(1, T):
        alphas.append(_forward_step(alphas[-1], unaries_btp[:, t], A_pp))
    betas = [torch.zeros_like(alphas[0])]
    for t in range(T - 1, 0, -1):
        # beta_{t-1}[p] = logsumexp_q(A[p, q] + U[t, q] + beta_t[q])
        scores = A_pp[None] + (unaries_btp[:, t] + betas[-1])[:, None, :]
        betas.append(torch.logsumexp(scores, dim=2))
    log_marg = torch.stack(alphas, 1) + torch.stack(betas[::-1], 1)
    log_marg = log_marg - torch.logsumexp(log_marg, dim=-1, keepdim=True)
    return torch.exp(log_marg)


def _backtrack(last, backptrs):
    """Follow (T-1) pointer tables (B, P) back from ``last`` (B,)."""
    path = [last]
    for bp_t in reversed(backptrs):
        path.append(torch.gather(bp_t, 1, path[-1][:, None])[:, 0])
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def viterbi_decode(unaries_btp, A_pp):
    """Batched max-product decode: (B, T) int32 best paths under
    ``sum_t U[t, y_t] + sum_t A[y_{t-1}, y_t]``."""
    dp = unaries_btp[:, 0]
    backptrs = []
    for t in range(1, unaries_btp.shape[1]):
        best, best_prev = torch.max(dp[:, :, None] + A_pp[None], dim=1)
        backptrs.append(best_prev)
        dp = best + unaries_btp[:, t]
    return _backtrack(torch.argmax(dp, dim=-1), backptrs)


def viterbi_decode_no_all_home(unaries_btp, A_pp, home_idx):
    """Constrained Viterbi: the best path that visits >= 1 non-home state.

    Augmented state (p, v), v = "visited non-home yet". Transitions:
    (q, 0) -> (home, 0); (q, 1) -> (home, 1); (q, 0) or (q, 1) -> (p, 1)
    for p != home, from v = 0 only where it scores strictly higher. The
    path terminates in v = 1. Returns (B, T) int32 paths.
    """
    B, T, P = unaries_btp.shape
    is_home = torch.arange(P, device=unaries_btp.device) == home_idx
    neg = torch.full((), NEG_INF, dtype=unaries_btp.dtype,
                     device=unaries_btp.device)
    u0 = unaries_btp[:, 0]
    dp0 = torch.where(is_home, u0, neg)  # v = 0: home only
    dp1 = torch.where(is_home, neg, u0)  # v = 1: non-home only
    ptrs_p, ptrs_v = [], []
    for t in range(1, T):
        u_t = unaries_btp[:, t]
        best0_val, best0_arg = torch.max(dp0[:, :, None] + A_pp[None], dim=1)
        best1_val, best1_arg = torch.max(dp1[:, :, None] + A_pp[None], dim=1)
        # v' = 0: only home, only from v = 0
        new0 = torch.where(is_home, best0_val + u_t, neg)
        # v' = 1: home only from v = 1; non-home from the better of v = 0, 1
        use0 = (best0_val > best1_val) & ~is_home
        new1 = torch.where(use0, best0_val, best1_val) + u_t
        ptr1_p = torch.where(use0, best0_arg, best1_arg)
        ptrs_p.append(torch.stack([best0_arg, ptr1_p], dim=-1))  # (B, P, 2)
        ptrs_v.append(torch.stack([torch.zeros_like(use0), ~use0], dim=-1))
        dp0, dp1 = new0, new1
    p = torch.argmax(dp1, dim=-1)  # terminate in v = 1
    v = torch.ones_like(p)
    rows = torch.arange(B, device=unaries_btp.device)
    path = [p]
    for ptr_p, ptr_v in zip(reversed(ptrs_p), reversed(ptrs_v)):
        p, v = ptr_p[rows, p, v], ptr_v[rows, p, v].long()
        path.append(p)
    return torch.stack(path[::-1], dim=1).to(torch.int32)
