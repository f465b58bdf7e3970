"""Profiling + observability (the port's ``ananke_abm_tpu.utils.profiling``,
on ``torch`` and ``torch.profiler``).

- :class:`PhaseTimes`: named wall-clock spans, collected per run, written
  as JSONL;
- :func:`trace`: a ``torch.profiler`` trace of a region (CPU activity,
  and CUDA activity where a card is present), written as a Chrome trace;
- :func:`throughput`: items/s of a callable, its first call apart from
  its steady state; one ``torch.cuda.synchronize`` on the outputs' device
  ends the timed iterations;
- :func:`debug_nan_mode`: the NaN-check mode (JAX's ``jax_debug_nans``):
  every floating output of a PyTorch operation, in the forward and in the
  backward, and of the port's hand-written kernels, which launch through
  ``ctypes`` outside PyTorch's dispatcher (:func:`check_nan`, called by
  every ``ops/cuda`` wrapper beside its launch), raises
  ``FloatingPointError`` where it holds a NaN;
- :class:`JsonlLogger`: structured JSONL training records.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves


class PhaseTimes:
    """Collects named wall-clock spans; writes JSONL."""

    def __init__(self):
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.append({"phase": name,
                                 "seconds": time.time() - t0,
                                 "t_end": time.time()})

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out

    def dump(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json`` (view with Perfetto or
    chrome://tracing). Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() \
            and ProfilerActivity.CUDA in supported_activities():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _sync(out) -> None:
    """Wait for the work behind ``out``: one ``torch.cuda.synchronize`` on
    the device of its first CUDA tensor (CPU operations are done when they
    return)."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def throughput(
    fn: Callable, *args, items: int, iters: int = 10, warmup: int = 2
) -> Dict[str, float]:
    """items/s of a callable, separating its first call (builds, caches)
    from the steady state: ``iters`` calls enqueued back to back, ended by
    one sync on their outputs' device."""
    t0 = time.perf_counter()
    _sync(fn(*args))
    first_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        _sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    dt = (time.perf_counter() - t0) / iters
    return {
        "items_per_s": items / dt,
        "ms_per_call": dt * 1e3,
        "first_call_s": first_s,
    }


# ---- the NaN-check mode -----------------------------------------------------

# debug_nan_mode's state: global, so that autograd's backward threads and
# the kernel wrappers see it (the dispatch mode itself is thread-local, and
# the autograd engine carries it to the threads of a backward)
_NAN_MODE = False
# operations whose outputs hold memory no operation wrote yet
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided",
                        "empty_permuted", "new_empty", "new_empty_strided",
                        "resize_", "resize_as_", "set_"})


def _raise_on_nan(name: str, outputs) -> None:
    for t in tree_leaves(outputs):
        if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                and t.device.type != "meta"
                and (t.is_floating_point() or t.is_complex())
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {name}")


def check_nan(name: str, *outputs) -> None:
    """Under :func:`debug_nan_mode`, raise ``FloatingPointError`` naming
    ``name`` where a floating tensor of ``outputs`` holds a NaN (one sync
    per tensor). With the mode off it returns at once: no sync, no
    launch. Every hand-written kernel's wrapper calls it on the kernel's
    outputs beside the launch."""
    if _NAN_MODE:
        _raise_on_nan(name, outputs)


class _NanCheck(TorchDispatchMode):
    """Checks the floating outputs of every operation that computes them:
    not views (they compute nothing) and not the allocations of unwritten
    memory, whose bits may read as NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _NAN_MODE and not func.is_view \
                and func.overloadpacket.__name__ not in _UNWRITTEN:
            _raise_on_nan(str(func), out)
        return out


@contextlib.contextmanager
def debug_nan_mode(enable: bool = True):
    """Within the context, a NaN in the floating output of any PyTorch
    operation (forward or backward) or of a hand-written kernel raises
    ``FloatingPointError`` naming the operation (``enable=False`` turns an
    enclosing mode off). On exit the previous state is restored. Each
    checked output costs a device-to-host sync; nothing is checked, and
    nothing on any path changes, with the mode off."""
    global _NAN_MODE
    prev = _NAN_MODE
    push = enable and not any(isinstance(m, _NanCheck)
                              for m in _get_current_dispatch_mode_stack())
    _NAN_MODE = bool(enable)
    try:
        if push:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _NAN_MODE = prev


class JsonlLogger:
    """Structured JSONL training logger (per-loss-component rows)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, record: Dict):
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({k: _jsonable(v)
                                for k, v in record.items()}) + "\n")


def _jsonable(v):
    """A float where ``float(v)`` gives one (Python numbers, numpy and
    one-element tensors, on either device); the value itself otherwise
    (torch raises ``RuntimeError`` for a tensor of more elements, where
    JAX raises ``TypeError``)."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return v
