"""Comparison-harness core: loading, grid checks, vectorized counting (the
port's copy of ``ananke_abm_tpu/models/gen_schedule/compare/utils.py``).

Contract parity with the reference compare utils
(src/ananke_abm/models/gen_schedule/compare/utils.py:13-301): npz+meta
sidecar discovery (``<stem>_meta.json`` or ``<stem>.json``), strict
(N, T)/grid/horizon consistency, counts->probs, union alignment, SRMSE
(Kim & Bansal 2023 Eq. 13 and the scaled population-synthesis variant),
n-gram and full-schedule counting.

The reference counts with per-row Python dict loops (utils.py:255-301);
here n-grams are encoded as base-P integer codes over sliding windows and
counted with ``np.unique`` — O(N*T) in C at VISTA scale (42817 x 288).
Dict-shaped outputs remain available for the detail CSVs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------- loading
def _load_one_npz_with_meta(npz_path: str, meta_path: str, name: str) -> Dict:
    arr = np.load(npz_path)
    if "Y_generated" in arr:
        Y = arr["Y_generated"].astype(np.int64)
    elif "Y" in arr:
        Y = arr["Y"].astype(np.int64)
    else:
        raise KeyError(f"{npz_path} must contain 'Y_generated' or 'Y'")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    T_meta = meta.get("L", meta.get("num_time_bins"))
    return {
        "name": name,
        "Y": Y,
        "purpose_map": meta["purpose_map"],
        "grid_min": meta.get("grid_min"),
        "horizon_min": meta.get("horizon_min"),
        "T": int(T_meta) if T_meta is not None else int(Y.shape[1]),
    }


def load_reference(ref_npz: str, ref_meta: str) -> Dict:
    return _load_one_npz_with_meta(ref_npz, ref_meta, name="ref")


def load_comparison_models(compare_dir: str) -> List[Dict]:
    """Discover ``<model>.npz`` + ``<model>_meta.json``/``<model>.json``
    pairs; enforce shared (N, T) across models."""
    models = []
    for fname in sorted(os.listdir(compare_dir)):
        if not fname.endswith(".npz"):
            continue
        stem = os.path.splitext(fname)[0]
        meta_path = None
        for cand in (f"{stem}_meta.json", f"{stem}.json"):
            p = os.path.join(compare_dir, cand)
            if os.path.exists(p):
                meta_path = p
                break
        if meta_path is None:
            raise FileNotFoundError(
                f"No meta json found for {fname} in {compare_dir}"
            )
        models.append(
            _load_one_npz_with_meta(
                os.path.join(compare_dir, fname), meta_path, name=stem
            )
        )
    if not models:
        raise ValueError(f"No .npz models found in {compare_dir}")
    N0, T0 = models[0]["Y"].shape
    for m in models[1:]:
        N, T = m["Y"].shape
        if T != T0:
            raise AssertionError(
                f"Time-bin mismatch: {models[0]['name']} T={T0}, {m['name']} T={T}"
            )
        if N != N0:
            raise AssertionError(
                f"Population mismatch: {models[0]['name']} N={N0}, {m['name']} N={N}"
            )
    return models


def ensure_dir(path: str):
    os.makedirs(path, exist_ok=True)
    return path


def assert_labels_fit_purpose_map(ref: Dict, models: List[Dict]) -> None:
    """Fail FAST (before any CSV is written) when a dataset's labels do
    not fit the reference purpose_map's index range [0, P).

    Without this, an out-of-map label surfaces mid-suite with an
    inconsistent policy: the duration metrics tolerate extra labels (the
    reference's dict counting did), while the base-P n-gram encoders
    must reject them (label >= P aliases window codes; the reference's
    own tod/bigram cores crashed on them with opaque broadcast/index
    errors — general.py:27-51). One clear error up front instead."""
    P = len(ref["purpose_map"])
    for d in [ref] + list(models):
        Y = d["Y"]
        if Y.size and (Y.min() < 0 or Y.max() >= P):
            raise ValueError(
                f"dataset '{d['name']}' has labels in "
                f"[{Y.min()}, {Y.max()}] but the reference purpose_map "
                f"has {P} purposes (valid indices 0..{P - 1}); regenerate "
                f"the model samples with the reference's purpose_map or "
                f"supply a matching ref_meta"
            )


def assert_same_temporal_grid(ref: Dict, models: List[Dict]) -> None:
    for m in models:
        if m["T"] != ref["T"]:
            raise AssertionError(
                f"Temporal mismatch: ref T={ref['T']}, model '{m['name']}' T={m['T']}."
            )
        for key in ("grid_min", "horizon_min"):
            a, b = ref.get(key), m.get(key)
            if a is not None and b is not None and a != b:
                raise AssertionError(
                    f"{key} mismatch: ref={a}, model '{m['name']}'={b}."
                )


# ---------------------------------------------- vectorized counting core
def ngram_code_matrix(Y: np.ndarray, n: int, P: int) -> np.ndarray:
    """(N, T-n+1) int64 base-P codes of all length-n windows."""
    N, T = Y.shape
    if n > T:
        return np.zeros((N, 0), dtype=np.int64)
    code = np.zeros((N, T - n + 1), dtype=np.int64)
    for i in range(n):
        code = code * P + Y[:, i : T - n + 1 + i]
    return code


def decode_ngram(code: int, n: int, P: int) -> Tuple[int, ...]:
    out = []
    for _ in range(n):
        out.append(int(code % P))
        code //= P
    return tuple(reversed(out))


# dense count-table budget for the native n-gram path: P**n int64 slots
# (32 MB). Above it (huge P or n) the sort-based numpy path wins on memory.
_DENSE_TABLE_MAX = 2**22


def ngram_count_arrays(Y: np.ndarray, n: int, P: int):
    """(codes (K,), counts (K,)) sorted by code.

    Dispatches to the native C++ dense-table counter when built and the
    P**n table fits the budget (2.6-41x over np.unique at 100k x 288,
    identical outputs); sort-based numpy otherwise.
    """
    from ananke_abm_tpu_torch.ops import native  # lazy: avoids import cycle

    native.check_labels(np.asarray(Y), P)  # uniform across both branches
    if native.available() and 0 < P**n <= _DENSE_TABLE_MAX:
        dense = native.count_ngrams_dense(Y, n, P)
        codes = np.nonzero(dense)[0]
        return codes, dense[codes]
    codes = ngram_code_matrix(Y, n, P).ravel()
    return np.unique(codes, return_counts=True)


def cached_schedule_counts(dataset: dict):
    """schedule_count_arrays of dataset['Y'], memoized inside the dataset
    dict — three metric families (raw_schedules, srmse_schedule,
    diversity_schedules) need the same whole-grid row unique, which is
    the priciest host op at 1M persons. The cache lives and dies with
    the loaded-dataset dict."""
    if "_schedule_counts" not in dataset:
        dataset["_schedule_counts"] = schedule_count_arrays(dataset["Y"])
    return dataset["_schedule_counts"]


def _hash_rows_u64(packed: np.ndarray, alt: bool = False) -> np.ndarray:
    """(N,) 64-bit hashes of the rows of a uint8 matrix, vectorized over
    rows one 8-byte word at a time (wrapping uint64 arithmetic).
    ``alt=True`` selects an independent mixing constant pair so two
    hashes can cross-check each other (FNV-1a vs a Weyl-multiplier
    polynomial hash)."""
    N, T = packed.shape
    pad = (-T) % 8
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((N, pad), np.uint8)], axis=1
        )
    words = np.ascontiguousarray(packed).view(np.uint64)
    if alt:
        basis, mult = 0x9E3779B97F4A7C15, np.uint64(0xC2B2AE3D27D4EB4F)
    else:
        basis, mult = 0xCBF29CE484222325, np.uint64(0x100000001B3)
    h = np.full(N, basis, dtype=np.uint64)
    for j in range(words.shape[1]):
        h = (h ^ words[:, j]) * mult
    return h


def schedule_count_arrays(Y: np.ndarray):
    """(unique_rows (U, T), counts (U,)) over whole rows.

    Collision-checked by an independent second 64-bit hash (any
    disagreement escalates to the exact sort path; what remains is a
    simultaneous 128-bit double collision, orders of magnitude below
    hardware soft-error rates). Rows come back in first-occurrence
    order, not np.unique's lexicographic order — every consumer keys on
    the row bytes or aggregates counts, so order is immaterial.
    Grouping by a 64-bit row hash replaces the row-lexicographic sort
    (memcmp of T-byte keys) with one uint64 argsort, and the result
    gather runs on ascending row indices (a random-order 2.3 GB row
    gather measures 25x slower than a sorted one on this host). When
    every row is unique the returned rows ALIAS Y (no copy) — treat
    them as read-only, as all harness consumers do.
    """
    if (
        Y.ndim != 2
        or Y.size == 0
        or not np.issubdtype(Y.dtype, np.integer)  # uint8 cast would
        or Y.min() < 0                             # truncate floats
        or Y.max() > 255
    ):
        return np.unique(Y, axis=0, return_counts=True)
    N, T = Y.shape
    packed = np.ascontiguousarray(Y.astype(np.uint8))
    h = _hash_rows_u64(packed)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    starts = np.flatnonzero(np.r_[True, hs[1:] != hs[:-1]])
    counts = np.diff(np.r_[starts, h.size])
    # collision check: within a primary-hash group, an INDEPENDENT
    # second hash must also be constant (8-byte ops — row-level
    # gathers at D = N-U rows measure 45-75 s at 1M under THP
    # compaction pressure). Any disagreement escalates to the exact
    # void-key sort; a simultaneous 128-bit double collision (~1e-38
    # per pair) is far below hardware soft-error rates.
    dup = np.flatnonzero(hs[1:] == hs[:-1]) + 1
    if dup.size:
        h2s = _hash_rows_u64(packed, alt=True)[order]
        if not np.array_equal(h2s[dup], h2s[dup - 1]):
            keys = packed.view(np.dtype((np.void, T))).ravel()
            _, idx, counts = np.unique(
                keys, return_index=True, return_counts=True
            )
            return Y[idx], counts
    if starts.size == N:  # every row unique: skip the multi-GB gather
        return Y, np.ones(N, dtype=counts.dtype)
    sel = order[starts]
    perm = np.argsort(sel, kind="stable")
    return Y[sel[perm]], counts[perm]


def align_count_arrays(codes_a, counts_a, codes_b, counts_b):
    """Union-align two (codes, counts) pairs -> (keys, ca, cb)."""
    keys = np.union1d(codes_a, codes_b)
    ca = np.zeros(keys.shape[0], dtype=np.float64)
    cb = np.zeros(keys.shape[0], dtype=np.float64)
    ca[np.searchsorted(keys, codes_a)] = counts_a
    cb[np.searchsorted(keys, codes_b)] = counts_b
    return keys, ca, cb


# ----------------------------------------- dict-compatible wrappers
def ngram_counts(
    Y: np.ndarray, n: Optional[int], as_schedule: bool = False
) -> Dict[Tuple[int, ...], int]:
    if Y.ndim != 2:
        raise ValueError(f"Y must be 2D (N,T), got {Y.shape}")
    if as_schedule:
        rows, counts = schedule_count_arrays(Y)
        return {
            tuple(int(x) for x in r): int(c) for r, c in zip(rows, counts)
        }
    if n is None or n <= 0:
        raise ValueError("n must be positive when as_schedule=False")
    P = int(Y.max()) + 1 if Y.size else 1
    codes, counts = ngram_count_arrays(Y, n, P)
    return {decode_ngram(int(c), n, P): int(v) for c, v in zip(codes, counts)}


def schedule_counts(Y: np.ndarray) -> Dict[Tuple[int, ...], int]:
    return ngram_counts(Y, n=None, as_schedule=True)


# ------------------------------------------------- probability helpers
def counts_to_probs(
    counts: Dict[Hashable, float], eps: float = 1e-12
) -> Dict[Hashable, float]:
    total = float(sum(counts.values()))
    if total < eps:
        return {k: 0.0 for k in counts}
    return {k: float(v) / total for k, v in counts.items()}


def align_distributions(probs_ref, probs_syn):
    keys = sorted(set(probs_ref) | set(probs_syn))
    if not keys:
        return [], np.zeros(0), np.zeros(0)
    p = np.array([probs_ref.get(k, 0.0) for k in keys])
    q = np.array([probs_syn.get(k, 0.0) for k in keys])
    return keys, p, q


# --------------------------------------------------------------- SRMSE
def compute_srmse_from_probs(p_ref, p_syn, eps: float = 1e-12) -> float:
    """Kim & Bansal (2023) Eq. 13: RMSE over cells / mean reference prob."""
    if p_ref.size == 0:
        return 0.0
    nb = len(p_ref)
    rmse = np.sqrt(np.sum((p_syn - p_ref) ** 2) / max(nb, 1))
    mean_ref = np.sum(p_ref) / max(nb, 1)
    return 0.0 if mean_ref < eps else float(rmse / mean_ref)


def compute_basic_srmse_from_probs(p_ref, p_syn, eps: float = 1e-12) -> float:
    """Scaled variant: sqrt(sum (q-p)^2 / sum p^2)."""
    if p_ref.size == 0:
        return 0.0
    num = float(np.sum((p_syn - p_ref) ** 2))
    den = float(np.sum(p_ref**2))
    return 0.0 if den < eps else float(np.sqrt(num / den))


def srmse_from_count_arrays(ca: np.ndarray, cb: np.ndarray) -> float:
    """SRMSE from union-aligned count vectors (normalize then Eq. 13)."""
    pa = ca / ca.sum() if ca.sum() > 0 else ca
    pb = cb / cb.sum() if cb.sum() > 0 else cb
    return compute_srmse_from_probs(pa, pb)


def compute_srmse_from_counts(counts_ref, counts_syn, eps=1e-12) -> float:
    pr = counts_to_probs(counts_ref, eps)
    ps = counts_to_probs(counts_syn, eps)
    _, p, q = align_distributions(pr, ps)
    return compute_srmse_from_probs(p, q, eps)


# ----------------------------------------------------- entropy / gini
def entropy_from_count_array(counts: np.ndarray, eps: float = 1e-12) -> float:
    total = float(counts.sum())
    if total < eps or counts.size == 0:
        return 0.0
    p = counts[counts > 0].astype(np.float64) / total
    return float(-np.sum(p * np.log(p)))


def gini_from_count_array(counts: np.ndarray, eps: float = 1e-12) -> float:
    """Gini coefficient of the count distribution over cells."""
    if counts.size == 0:
        return 0.0
    x = np.sort(counts.astype(np.float64))
    total = x.sum()
    if total < eps:
        return 0.0
    n = x.size
    cum = np.cumsum(x)
    return float((n + 1 - 2 * np.sum(cum) / total) / n)


# ------------------------------------------ run-length segmentation
def segments_run_length_fast(Y: np.ndarray):
    """Run-length segmentation via the native C++ kernel when built,
    falling back to the numpy prefix trick (identical outputs)."""
    from ananke_abm_tpu_torch.ops import native  # lazy: avoids import cycle

    if native.available():
        return native.run_length_segments(Y)
    return segments_run_length(Y)


def segments_run_length(Y: np.ndarray):
    """Vectorized run-length segmentation of every row.

    Returns (person (S,), purpose (S,), length (S,)) over all segments of
    constant purpose, in row-major order.
    """
    N, T = Y.shape
    change = np.ones((N, T), dtype=bool)
    change[:, 1:] = Y[:, 1:] != Y[:, :-1]
    person_idx, start_t = np.nonzero(change)
    purpose = Y[person_idx, start_t]
    # segment end: next start within the same person, else T
    flat_starts = person_idx * T + start_t
    next_flat = np.empty_like(flat_starts)
    next_flat[:-1] = flat_starts[1:]
    next_flat[-1] = N * T
    same_person = (next_flat // T) == person_idx
    end_t = np.where(same_person, next_flat % T, T)
    return person_idx, purpose, (end_t - start_t)
