"""Semi-Markov CRF: a segment-level linear-chain CRF with bounded
durations (port of ``ananke_abm_tpu/ops/semi_crf.py``).

A day is a sequence of segments (purpose p, duration d <= D bins); a
segment scores the sum of its frame unaries plus a learned duration score
``dur[p, d-1]``; transitions carry ``A[p_prev, p_next]``, and adjacent
segments may not repeat a purpose unless ``allow_self``.

Each ``lax.scan`` of the reference is a Python loop over T of batched
(D, B, P, P) tensor operations with a ring of the last D alpha rows: O(T)
launches, no host synchronisation inside. ``NEG_INF`` is the reference's
finite -1e30, so masked scores stay finite through every logsumexp. Ties
in every max go to the first index, as ``jnp.argmax`` does. The decode's
backtrace runs exactly T iterations (every segment is at least one bin
long, so each active row moves back at least one bin an iteration; rows
already done are left as they are): no ``.item()`` inside.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _segment_scores_from_cumsum(U_cumsum, t, d_arange):
    """Scores of the segments ending at time t (inclusive) with durations
    1..D, sum_{s=t-d+1..t} U[s, p]: (D, B, P). ``U_cumsum`` (B, T+1, P)
    holds the prefix sums; rows with d > t+1 are masked by the caller."""
    end = U_cumsum[:, t + 1]  # (B, P)
    starts = torch.clamp(t - d_arange, min=0)  # (D,)
    return (end[:, None, :] - U_cumsum[:, starts]).transpose(0, 1)


def _prep(unaries_btp, dur_scores_pd, A_pp, allow_self=False):
    B, T, P = unaries_btp.shape
    D = dur_scores_pd.shape[1]
    U_cumsum = torch.cat([unaries_btp.new_zeros((B, 1, P)),
                          torch.cumsum(unaries_btp, dim=1)], dim=1)
    if allow_self:
        A_eff = A_pp
    else:
        eye = torch.eye(P, dtype=torch.bool, device=A_pp.device)
        A_eff = torch.where(eye, torch.full_like(A_pp, NEG_INF), A_pp)
    return B, T, P, D, U_cumsum, A_eff


def _ring_masks(t, d_ar):
    """(is_first, valid), each (D, 1, 1): the segment of duration d_ar+1
    ending at t starts the day, or starts at a time >= 0."""
    s = t - d_ar
    return (s == 0)[:, None, None], (s >= 0)[:, None, None]


def semicrf_log_partition(unaries_btp, dur_scores_pd, A_pp, allow_self=False):
    """log Z over all valid segmentations: (B,). ``allow_self`` admits
    adjacent same-purpose segments (scored by A's diagonal), as the
    exact-likelihood mode needs."""
    B, T, P, D, U_cumsum, A_eff = _prep(unaries_btp, dur_scores_pd, A_pp,
                                        allow_self)
    d_ar = torch.arange(D, device=unaries_btp.device)
    dur_dp = dur_scores_pd[:, :D].transpose(0, 1)[:, None, :]  # (D, 1, P)
    ring = unaries_btp.new_full((D, B, P), NEG_INF)  # alpha at t-1 .. t-D
    for t in range(T):
        seg = _segment_scores_from_cumsum(U_cumsum, t, d_ar) + dur_dp
        # predecessor mass: duration d = i+1 starts at s = t-i; its
        # predecessor alpha at s-1 = t-1-i is ring[i]
        prev = torch.logsumexp(ring[:, :, :, None] + A_eff[None, None],
                               dim=2)  # (D, B, P)
        is_first, valid = _ring_masks(t, d_ar)
        combined = torch.where(is_first, torch.zeros_like(prev), prev)
        scores = torch.where(valid, seg + combined,
                             torch.full_like(seg, NEG_INF))
        alpha_t = torch.logsumexp(scores, dim=0)  # (B, P)
        ring = torch.cat([alpha_t[None], ring[:-1]], dim=0)
    return torch.logsumexp(ring[0], dim=-1)


def _run_starts(labels):
    """(is_start, run_start), each (B, T): where a run of equal labels
    starts, and for each frame the start of its run."""
    B, T = labels.shape
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                     device=labels.device),
                          labels[:, 1:] != labels[:, :-1]], dim=1)
    pos = torch.arange(T, device=labels.device).expand(B, T)
    run_start = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    return is_start, run_start


def semicrf_path_score(unaries_btp, labels_bt, dur_scores_pd, A_pp):
    """Score of the segmentation induced by a dense label grid (run-length
    segments; durations clipped into the duration table's range): (B,)."""
    B, T, P = unaries_btp.shape
    D = dur_scores_pd.shape[1]
    labels = labels_bt.long()

    unary = torch.gather(unaries_btp, -1, labels[..., None])[..., 0].sum(1)

    is_start, seg_id = _run_starts(labels)
    # the transition into every segment but the first
    prev_label = torch.cat([labels[:, :1], labels[:, :-1]], dim=1)
    trans = A_pp[prev_label, labels] * is_start
    trans = torch.cat([torch.zeros_like(trans[:, :1]), trans[:, 1:]], dim=1)

    # each segment's length: its frames scatter-added onto its start
    lengths = unaries_btp.new_zeros((B, T)).scatter_add_(
        1, seg_id, torch.ones((B, T), dtype=unaries_btp.dtype,
                              device=unaries_btp.device))
    d_idx = torch.clamp(lengths.to(torch.int64) - 1, 0, D - 1)
    dur = torch.gather(dur_scores_pd[labels], -1, d_idx[..., None])[..., 0]
    dur = torch.where(is_start, dur, torch.zeros_like(dur))
    return unary + trans.sum(1) + dur.sum(1)


def semicrf_gold_log_marginal(unaries_btp, labels_bt, dur_scores_pd, A_pp):
    """log-sum of the scores of ALL segmentations whose dense projection
    is the gold label grid (self-transitions allowed): (B,), the exact
    numerator of the capped-duration likelihood; normalise against
    ``semicrf_log_partition(..., allow_self=True)``.

    Constrained forward: a segment [s..t] is admissible iff the gold
    labels are constant on it (s >= run_start[t]) and d <= D. A (D, B)
    ring of alpha history, O(T * D) per row."""
    B, T, P = unaries_btp.shape
    D = dur_scores_pd.shape[1]
    labels = labels_bt.long()
    dev = unaries_btp.device

    gy = torch.gather(unaries_btp, -1, labels[..., None])[..., 0]
    G = torch.cat([unaries_btp.new_zeros((B, 1)), torch.cumsum(gy, 1)], 1)
    _, run_start = _run_starts(labels)
    dur_y = dur_scores_pd[labels]  # (B, T, D)
    d_ar = torch.arange(D, device=dev)

    ring = unaries_btp.new_full((D, B), NEG_INF)  # alpha at t-1-i
    for t in range(T):
        s = t - d_ar  # (D,) segment start per duration
        s_safe = torch.clamp(s, min=0)
        valid = (s >= 0)[:, None] & (s[:, None] >= run_start[:, t][None, :])
        seg_u = (G[:, t + 1][:, None] - G[:, s_safe]).T  # (D, B)
        dscore = dur_y[:, t, :].T  # (D, B)
        y_prev = labels[:, torch.clamp(s - 1, min=0)]  # (B, D)
        trans = A_pp[y_prev, labels[:, t][:, None]].T  # (D, B)
        is_first = (s == 0)[:, None]
        pred = ring + trans
        cand = seg_u + dscore + torch.where(is_first, torch.zeros_like(pred),
                                            pred)
        cand = torch.where(valid, cand, torch.full_like(cand, NEG_INF))
        alpha_t = torch.logsumexp(cand, dim=0)  # (B,)
        ring = torch.cat([alpha_t[None], ring[:-1]], dim=0)
    return ring[0]


def semicrf_nll(unaries_btp, labels_bt, dur_scores_pd, A_pp, mask_b=None,
                exact_long=False):
    """Mean NLL of the gold label grids.

    ``exact_long=True``: the exact likelihood of the dense grid under the
    Dmax-capped model with self-transitions (log Z with ``allow_self``
    minus :func:`semicrf_gold_log_marginal`). ``exact_long=False``: the
    no-self-transition model with the gold runs clip-scored into the
    duration table (a bound where a gold run exceeds Dmax). ``mask_b``:
    optional (B,) row weights (padded rows 0)."""
    if exact_long:
        logZ = semicrf_log_partition(unaries_btp, dur_scores_pd, A_pp,
                                     allow_self=True)
        gold = semicrf_gold_log_marginal(unaries_btp, labels_bt,
                                         dur_scores_pd, A_pp)
    else:
        logZ = semicrf_log_partition(unaries_btp, dur_scores_pd, A_pp)
        gold = semicrf_path_score(unaries_btp, labels_bt, dur_scores_pd,
                                  A_pp)
    per_row = logZ - gold
    if mask_b is None:
        return per_row.mean()
    return torch.sum(per_row * mask_b) / torch.clamp(mask_b.sum(), min=1.0)


def semicrf_decode(unaries_btp, dur_scores_pd, A_pp, allow_self=False):
    """The max-scoring segmentation as dense (B, T) int32 labels: Viterbi
    over (t, d, p) with backpointers, then a backtrace painting segments
    right to left. With ``allow_self`` adjacent same-purpose segments
    merge in the dense output, so runs can exceed Dmax."""
    B, T, P, D, U_cumsum, A_eff = _prep(unaries_btp, dur_scores_pd, A_pp,
                                        allow_self)
    dev = unaries_btp.device
    d_ar = torch.arange(D, device=dev)
    dur_dp = dur_scores_pd[:, :D].transpose(0, 1)[:, None, :]
    ring = unaries_btp.new_full((D, B, P), NEG_INF)
    best_d_t, bp_prev_t = [], []
    for t in range(T):
        seg = _segment_scores_from_cumsum(U_cumsum, t, d_ar) + dur_dp
        prev_best, prev_arg = torch.max(ring[:, :, :, None]
                                        + A_eff[None, None], dim=2)
        is_first, valid = _ring_masks(t, d_ar)
        combined = torch.where(is_first, torch.zeros_like(prev_best),
                               prev_best)
        scores = torch.where(valid, seg + combined,
                             torch.full_like(seg, NEG_INF))
        v_t, best_d = torch.max(scores, dim=0)  # (B, P)
        # the previous purpose for the chosen duration (meaningful only
        # where the segment is not the first)
        best_d_t.append(best_d)
        bp_prev_t.append(torch.gather(prev_arg, 0, best_d[None])[0])
        ring = torch.cat([v_t[None], ring[:-1]], dim=0)
    best_d_t = torch.stack(best_d_t)  # (T, B, P)
    bp_prev_t = torch.stack(bp_prev_t)

    labels = torch.zeros((B, T), dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    t = torch.full((B,), T - 1, dtype=torch.int64, device=dev)
    p = torch.argmax(ring[0], dim=-1)
    for _ in range(T):
        active = t >= 0
        t_safe = torch.clamp(t, min=0)
        start = t_safe - best_d_t[t_safe, bidx, p]  # the segment [start, t]
        in_seg = (active[:, None] & (pos >= start[:, None])
                  & (pos <= t_safe[:, None]))
        labels = torch.where(in_seg, p[:, None], labels)
        prev_p = bp_prev_t[t_safe, bidx, p]
        t_new = torch.where(active, start - 1, t)
        p = torch.where(active & (t_new >= 0), prev_p, p)
        t = t_new
    return labels.to(torch.int32)
