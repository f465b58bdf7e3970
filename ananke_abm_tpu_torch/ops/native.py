"""ctypes binding of the host counting kernels (``csrc/ananke_host.cpp``)
with a numpy fallback: the port's counterpart of
``ananke_abm_tpu/ops/native.py``, same entry points and outputs.

The shared library is built with ``g++`` at first use into
``build/ananke_abm_tpu_torch/`` under a name that hashes the source and the
flags (as ``ops/cuda/_build.py`` names the CUDA libraries), so an edited
source is rebuilt and an unchanged one reused. Nothing is compiled when the
module is imported. Every entry point has a numpy equivalent in
``models/gen_schedule/compare/utils.py``; ``available()`` says which one
runs. Output buffers are ``np.zeros``: the kernels first-touch them, and
write faults on calloc'd pages ride transparent huge pages where those on
``np.empty``'s malloc'd pages do not.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ananke_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "ananke_abm_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"ananke_host-{digest[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile the library into ``lib`` (through a temporary name, so
    processes building at once never load a half-written file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


@functools.cache
def _load():
    """The loaded library, or None where it cannot be built or loaded."""
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.count_ngrams.argtypes = [p64, i64, i64, i64, i64, p64]
    lib.count_ngrams.restype = None
    lib.run_length_segments.argtypes = [p64, i64, i64, p64, p64, p64]
    lib.run_length_segments.restype = i64
    lib.tod_counts.argtypes = [p64, i64, i64, i64, p64]
    lib.tod_counts.restype = None
    lib.ngram_start_hist.argtypes = [p64, i64, i64, i64, i64, p64]
    lib.ngram_start_hist.restype = None
    lib.rasterize_fill.argtypes = [p64, p64, p64, p64, i64, i64, p64]
    lib.rasterize_fill.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def check_labels(Y: np.ndarray, P: int) -> None:
    """Reject labels outside [0, P) before dispatch: the C kernels index
    dense accumulators by raw label value, and the numpy branches would
    alias base-P codes or fail on a reshape. One ``ValueError`` on both
    branches."""
    if Y.size and (Y.min() < 0 or Y.max() >= P):
        raise ValueError(
            f"labels out of range: expected 0 <= Y < {P}, "
            f"got [{Y.min()}, {Y.max()}]"
        )


def count_ngrams_dense(Y: np.ndarray, n: int, P: int) -> np.ndarray:
    """Dense (P^n,) count table of base-P n-gram codes."""
    Y = np.ascontiguousarray(Y, dtype=np.int64)
    check_labels(Y, P)
    N, T = Y.shape
    counts = np.zeros(P**n, dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.count_ngrams(Y, N, T, n, P, counts)
        return counts
    from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
        ngram_count_arrays,
    )

    codes, vals = ngram_count_arrays(Y, n, P)
    counts[codes] = vals
    return counts


def run_length_segments(Y: np.ndarray):
    """(person, purpose, length) arrays of every run of one purpose."""
    Y = np.ascontiguousarray(Y, dtype=np.int64)
    N, T = Y.shape
    lib = _load()
    if lib is not None:
        cap = N * T
        person = np.zeros(cap, dtype=np.int64)
        purpose = np.zeros(cap, dtype=np.int64)
        length = np.zeros(cap, dtype=np.int64)
        s = lib.run_length_segments(Y, N, T, person, purpose, length)
        return person[:s], purpose[:s], length[:s]
    from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
        segments_run_length,
    )

    return segments_run_length(Y)


def tod_counts(Y: np.ndarray, P: int) -> np.ndarray:
    """(T, P) occupancy counts."""
    Y = np.ascontiguousarray(Y, dtype=np.int64)
    check_labels(Y, P)
    N, T = Y.shape
    lib = _load()
    if lib is not None:
        counts = np.zeros(T * P, dtype=np.int64)
        lib.tod_counts(Y, N, T, P, counts)
        return counts.reshape(T, P)
    flat = (np.arange(T)[None, :] * P + Y).ravel()
    return np.bincount(flat, minlength=T * P).reshape(T, P)


def ngram_start_hist_dense(Y: np.ndarray, n: int, P: int) -> np.ndarray:
    """(P^n, T-n+1) start-time histograms of every n-gram code."""
    Y = np.ascontiguousarray(Y, dtype=np.int64)
    check_labels(Y, P)
    N, T = Y.shape
    Tn = T - n + 1
    lib = _load()
    if lib is not None:
        hist = np.zeros(P**n * Tn, dtype=np.int64)
        lib.ngram_start_hist(Y, N, T, n, P, hist)
        return hist.reshape(P**n, Tn)
    from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
        ngram_code_matrix,
    )

    codes = ngram_code_matrix(Y, n, P)
    hist = np.zeros((P**n, Tn), dtype=np.int64)
    t_idx = np.tile(np.arange(Tn), N)
    np.add.at(hist, (codes.ravel(), t_idx), 1)
    return hist


def rasterize_fill(person_row, nominal, bins, pid, n_persons, L):
    """Monotone push-forward rasterization: (n_persons, L) int64, or None
    where the library is unavailable (the caller then takes its numpy
    prefix recurrence)."""
    lib = _load()
    if lib is None:
        return None
    person_row = np.ascontiguousarray(person_row, dtype=np.int64)
    nominal = np.ascontiguousarray(nominal, dtype=np.int64)
    bins = np.ascontiguousarray(bins, dtype=np.int64)
    pid = np.ascontiguousarray(pid, dtype=np.int64)
    Y = np.zeros((n_persons, L), dtype=np.int64)
    lib.rasterize_fill(person_row, nominal, bins, pid, person_row.shape[0],
                       L, Y.reshape(-1))
    return Y
