"""Grid dataset loading + seeded splits (a copy of
``ananke_abm_tpu/dataio/splits.py``).

The whole (N, T) int grid is one host array and train / val are index
arrays; the trainer puts the grid on the device once and gathers shuffled
batches there.
"""
from __future__ import annotations

import numpy as np


def load_grid(npz_path: str) -> np.ndarray:
    obj = np.load(npz_path)
    if "Y" not in obj:
        raise RuntimeError(f"Expected 'Y' in grid npz {npz_path}")
    return obj["Y"].astype(np.int64)


def load_splits(splits_path: str):
    obj = np.load(splits_path)
    return obj["train_idx"], obj["val_idx"]


def seeded_split(n: int, val_frac: float = 0.1, seed: int = 42):
    """(train_idx, val_idx), each sorted, of a seeded permutation of n."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(val_frac * n))
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def read_n_split_data(data_npz_path: str, val_frac: float = 0.1, seed: int = 42):
    """Load grid and produce a fresh seeded split (no splits file needed)."""
    Y = load_grid(data_npz_path)
    train_idx, val_idx = seeded_split(Y.shape[0], val_frac, seed)
    return Y[train_idx], Y[val_idx]
