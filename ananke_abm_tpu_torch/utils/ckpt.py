"""Checkpoint save/restore, in the format of ``ananke_abm_tpu.utils.ckpt``.

A checkpoint is one pickle file holding a dict whose array leaves are host
numpy arrays (nested dicts / lists / tuples of them). Tensors are moved to
the host and converted on save, so a checkpoint written by this package
loads in the JAX package and vice versa. The write goes to a temporary
file first and is renamed into place, so a crash never leaves a torn file.

The one exception is a training run's optimizer state: the JAX package
pickles optax's state objects, which this package cannot rebuild without
optax (where optax is absent they load as :class:`Unavailable`, so the
rest of such a checkpoint still serves); this package writes its AdamW
moments as numpy under :data:`OPT_STATE_FORMAT` (:func:`adamw_state`,
:func:`load_adamw_state`).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _to_host(obj, copy: bool = False):
    """``obj`` with its tensors (nested in dicts / lists / tuples) as host
    numpy arrays. With ``copy``, nothing of the result shares memory with
    ``obj`` (a CPU tensor or numpy array is copied, a CUDA tensor's copy
    to the host is synchronous), so in-place updates of ``obj`` after this
    returns (an optimizer's next step) do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=copy).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, copy) for v in obj)
    if isinstance(obj, np.ndarray):
        return np.array(obj, copy=True) if copy else obj
    if hasattr(obj, "shape"):
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


class AsyncCheckpointer:
    """Asynchronous checkpointing (the JAX package's ``AsyncCheckpointer``):
    the device-to-host copy happens on the caller's thread before
    :meth:`save` returns (a synchronous copy into memory of its own, so
    the parameters the next ``optimizer.step()`` updates in place are
    saved as they were at ``save``); the file is written on a daemon
    thread through :func:`save_checkpoint` (atomic ``os.replace``), so
    training does not block on IO. :meth:`wait` joins the write in flight;
    a new save waits for the previous one first."""

    def __init__(self):
        self._thread = None

    def save(self, obj: dict, path: str):
        import threading

        self.wait()
        host_obj = _to_host(obj, copy=True)
        self._thread = threading.Thread(
            target=save_checkpoint, args=(host_obj, path), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# the JAX stack's packages, whose classes a checkpoint of the JAX package
# may name (optax's optimizer states); the card's machine has none of them
_JAX_STACK = ("optax", "chex", "flax", "jax", "jaxlib")


class Unavailable(tuple):
    """Stands in for an object whose class lives in a package of the JAX
    stack that this machine lacks: the arguments it was rebuilt from, as a
    tuple (``.name``: the class's dotted name)."""

    name = "?"

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError:
            if module.split(".")[0] not in _JAX_STACK:
                raise
        return type(name, (Unavailable,), {"name": f"{module}.{name}"})


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint written by either package. Where the JAX stack is
    absent (the card's machine), the objects of its classes in a JAX
    checkpoint (the optax ``opt_state``) load as :class:`Unavailable`; the
    arrays, params, config and meta load as always. Unpickling runs code
    named in the file: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


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


def load_training_checkpoint(path: str) -> dict:
    """Load a training run's last checkpoint to resume it. Refuses a
    checkpoint of the JAX package, whose ``opt_state`` is optax's: the port
    resumes only the checkpoints it wrote (:data:`OPT_STATE_FORMAT`)."""
    ck = load_checkpoint(path)
    opt = ck.get("opt_state")
    if not (isinstance(opt, dict) and opt.get("format") == OPT_STATE_FORMAT):
        raise ValueError(
            f"{path} holds an optax optimizer state (a checkpoint of the JAX "
            "package); the port resumes only the checkpoints it wrote")
    return ck
