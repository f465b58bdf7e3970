"""Population metrics over (N, T) purpose grids, numpy (a copy of the
numpy branches of ``ananke_abm_tpu/models/gen_schedule/evals/metrics.py``;
the port does not bind the native library):
- minutes_share (P,), tod_marginals (T, P)
- joint bigram matrix (P, P) and row-conditional bigram
- L1 distance between matrices
"""
from __future__ import annotations

import numpy as np

ROW_BLOCK = 65536


def check_labels(Y: np.ndarray, P: int) -> None:
    """Reject labels outside [0, P): bincount would alias base-P codes."""
    if Y.size and (Y.min() < 0 or Y.max() >= P):
        raise ValueError(
            f"labels out of range: expected 0 <= Y < {P}, "
            f"got [{Y.min()}, {Y.max()}]"
        )


def minutes_share(Y: np.ndarray, P: int) -> np.ndarray:
    """Fraction of all person-minutes spent in each purpose. (P,)"""
    counts = np.bincount(Y.ravel(), minlength=P).astype(np.float64)
    return counts / Y.size


def tod_marginals(Y: np.ndarray, P: int) -> np.ndarray:
    """m[t, p] = Pr(y_t == p) across persons. (T, P)"""
    check_labels(Y, P)
    N, T = Y.shape
    offsets = np.arange(T)[None, :] * P
    counts = sum(np.bincount((offsets + Y[s:s + ROW_BLOCK]).ravel(),
                             minlength=T * P)
                 for s in range(0, N, ROW_BLOCK))
    return np.reshape(counts, (T, P)).astype(np.float64) / N


def _bigram_counts(Y: np.ndarray, P: int) -> np.ndarray:
    """(P, P) counts of adjacent within-row pairs."""
    check_labels(Y, P)
    counts = sum(np.bincount((Y[s:s + ROW_BLOCK, :-1] * P
                              + Y[s:s + ROW_BLOCK, 1:]).ravel(),
                             minlength=P * P)
                 for s in range(0, Y.shape[0], ROW_BLOCK))
    return np.reshape(counts, (P, P))


def bigram_matrix(Y: np.ndarray, P: int) -> np.ndarray:
    """Joint distribution of adjacent pairs, normalized over all pairs. (P,P)"""
    M = _bigram_counts(Y, P).astype(np.float64)
    z = M.sum()
    return M / z if z > 0 else M


def bigram_matrix_rowcond(Y: np.ndarray, P: int) -> np.ndarray:
    """Row-conditional transition matrix P(y_{t+1}=j | y_t=i). (P,P)"""
    B = _bigram_counts(Y, P).astype(np.float64)
    rows = B.sum(axis=1, keepdims=True)
    return np.divide(B, rows, out=np.zeros_like(B), where=rows > 0)


def l1_distance(A: np.ndarray, B: np.ndarray) -> float:
    return float(np.abs(A - B).sum())
