"""Population metrics over (N, T) purpose grids (the port's copy of
``ananke_abm_tpu/models/gen_schedule/evals/metrics.py``):
- minutes_share (P,), tod_marginals (T, P)
- joint bigram matrix (P, P) and row-conditional bigram
- L1 distance between matrices

The occupancy and bigram counts take the native host kernels
(``ops/native.py``) when the library is built, as the reference does, and
numpy bincounts over blocks of ROW_BLOCK rows otherwise.
"""
from __future__ import annotations

import numpy as np

from ananke_abm_tpu_torch.ops import native

ROW_BLOCK = 65536


def minutes_share(Y: np.ndarray, P: int) -> np.ndarray:
    """Fraction of all person-minutes spent in each purpose. (P,)"""
    counts = np.bincount(Y.ravel(), minlength=P).astype(np.float64)
    return counts / Y.size


def tod_marginals(Y: np.ndarray, P: int) -> np.ndarray:
    """m[t, p] = Pr(y_t == p) across persons. (T, P)"""
    native.check_labels(Y, P)
    N, T = Y.shape
    if native.available():
        return native.tod_counts(Y, P).astype(np.float64) / N
    offsets = np.arange(T)[None, :] * P
    counts = sum(np.bincount((offsets + Y[s:s + ROW_BLOCK]).ravel(),
                             minlength=T * P)
                 for s in range(0, N, ROW_BLOCK))
    return np.reshape(counts, (T, P)).astype(np.float64) / N


def _bigram_counts(Y: np.ndarray, P: int) -> np.ndarray:
    """(P, P) counts of adjacent within-row pairs."""
    native.check_labels(Y, P)
    if native.available():
        return native.count_ngrams_dense(Y, 2, P).reshape(P, P)
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
