"""Checkpoint save/restore, in the format of ``ananke_abm_tpu.utils.ckpt``.

A checkpoint is one pickle file holding a dict whose array leaves are host
numpy arrays (nested dicts / lists / tuples of them). Tensors are moved to
the host and converted on save, so a checkpoint written by this package
loads in the JAX package and vice versa. The write goes to a temporary
file first and is renamed into place, so a crash never leaves a torn file.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if hasattr(obj, "shape") and not isinstance(obj, np.ndarray):
        return np.asarray(obj)
    return obj


def save_checkpoint(obj: dict, path: str):
    """Save a checkpoint dict (params / config / world keys / ...)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint written by either package. Unpickling runs code
    named in the file: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
