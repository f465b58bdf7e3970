"""Checkpoint save/restore, in the format of ``ananke_abm_tpu.utils.ckpt``.

A checkpoint is one pickle file holding a dict whose array leaves are host
numpy arrays (nested dicts / lists / tuples of them). Tensors are moved to
the host and converted on save, so a checkpoint written by this package
loads in the JAX package and vice versa. The write goes to a temporary
file first and is renamed into place, so a crash never leaves a torn file.

The one exception is a training run's optimizer state: the JAX package
pickles optax's state objects, which this package cannot rebuild without
optax; this package writes its AdamW moments as numpy under
:data:`OPT_STATE_FORMAT` (:func:`adamw_state`, :func:`load_adamw_state`).
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


# the ``opt_state`` of this package's training checkpoints
OPT_STATE_FORMAT = "ananke_abm_tpu_torch.adamw/1"


def _params(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def adamw_state(optimizer: torch.optim.Optimizer, names) -> dict:
    """A ``torch.optim.AdamW``'s state, after at least one step, as host
    numpy: ``{"format", "step", "names", "exp_avg", "exp_avg_sq"}``, the
    moments listed in the optimizer's parameter order, which ``names``
    names."""
    states = [optimizer.state[p] for p in _params(optimizer)]
    if len(names) != len(states):
        raise ValueError(f"{len(names)} names for {len(states)} parameters")
    steps = {int(st["step"]) for st in states}
    if len(steps) != 1:
        raise ValueError(f"parameters at different AdamW steps: {steps}")
    return {"format": OPT_STATE_FORMAT, "step": steps.pop(),
            "names": list(names),
            "exp_avg": [_to_host(st["exp_avg"]) for st in states],
            "exp_avg_sq": [_to_host(st["exp_avg_sq"]) for st in states]}


def load_adamw_state(optimizer: torch.optim.Optimizer, state: dict,
                     names) -> None:
    """Restore what :func:`adamw_state` saved into an AdamW over the same
    parameters (``names`` in the optimizer's order)."""
    if state.get("format") != OPT_STATE_FORMAT:
        raise ValueError(f"not an optimizer state of this package: format "
                         f"{state.get('format')!r}")
    if list(state["names"]) != list(names):
        raise ValueError("the saved optimizer state names other parameters")
    sd = optimizer.state_dict()
    step = torch.tensor(float(state["step"]), dtype=torch.float32)
    sd["state"] = {
        i: {"step": step.clone(), "exp_avg": torch.as_tensor(m),
            "exp_avg_sq": torch.as_tensor(v)}
        for i, (m, v) in enumerate(zip(state["exp_avg"],
                                       state["exp_avg_sq"]))}
    optimizer.load_state_dict(sd)
