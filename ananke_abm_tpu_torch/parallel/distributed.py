"""Process-group start-up and per-process data feeding (port of
``ananke_abm_tpu/parallel/distributed.py``).

One process drives one device. :func:`maybe_initialize` starts the
process group from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
arguments; without either it does nothing and the process runs alone.
Nothing on a host announces a cluster: a multi-host run names its
rendezvous itself.

Each process may materialise only its own rows: :func:`host_row_slice`
says which global rows a process owns, and
:func:`host_local_batch_to_global` wraps the local rows as one DTensor
sharded over the ``agents`` axis (no process holds the whole batch).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ananke_abm_tpu_torch.parallel.mesh import AGENT_AXIS, named_sharding

# the device this process runs on, set by maybe_initialize
_device: torch.device | None = None


def global_batch_shape(local_shape: tuple, process_count: int) -> tuple:
    """Global shape of a batch whose leading (row) axis is split evenly
    across ``process_count`` processes."""
    return (local_shape[0] * process_count,) + tuple(local_shape[1:])


def _rank_and_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_row_slice(n_global_rows: int, process_index: int | None = None,
                   process_count: int | None = None) -> slice:
    """[start, stop) of the global rows this process owns (even split;
    ``n_global_rows`` must divide by the process count)."""
    rank, world = _rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if n_global_rows % pc:
        raise ValueError(
            f"n_global_rows={n_global_rows} not divisible by "
            f"process_count={pc}"
        )
    per = n_global_rows // pc
    return slice(pi * per, (pi + 1) * per)


def host_local_batch_to_global(mesh, tree, axis_name: str = AGENT_AXIS):
    """Each process's rows (its :func:`host_row_slice` of the global
    batch) as DTensors sharded over ``axis_name``: ``DTensor.from_local``
    of the local rows, the global shape that of the reference's
    ``make_array_from_process_local_data``. On one process it is the batch
    itself, wrapped."""
    from torch.distributed.tensor import DTensor

    placements = named_sharding(mesh, axis_name)
    _, world = _rank_and_world()

    def one(x):
        x = torch.as_tensor(x).contiguous()
        shape = global_batch_shape(x.shape, world)
        return DTensor.from_local(
            x, mesh, placements, shape=shape,
            stride=torch.empty(shape, device="meta").stride(),
            run_check=False)

    if isinstance(tree, dict):
        return {k: host_local_batch_to_global(mesh, v, axis_name)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_local_batch_to_global(mesh, v, axis_name)
                          for v in tree)
    return one(tree)


def rank_device() -> torch.device:
    """The device this process runs on: the one :func:`maybe_initialize`
    chose, else the current card where one is present, else the CPU."""
    if _device is not None:
        return _device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def maybe_initialize(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, *, device=None,
                     timeout_s: float | None = None) -> dict:
    """Start the process group when this process is one of several; a
    no-op when it runs alone. Returns the reference's summary keys
    (``process_index``, ``process_count``, ``local_devices``,
    ``global_devices``) and ``device``.

    The group starts from the explicit arguments (``coordinator_address``
    a ``tcp://host:port`` or ``file://`` rendezvous, with
    ``num_processes`` and ``process_id``) or from ``torchrun``'s
    environment; with neither, nothing starts. ``device``: this rank's
    device, by default ``cuda:LOCAL_RANK`` where cards are present, else
    the CPU. ``backend``: NCCL when the rank runs on a card, gloo on the
    CPU. ``timeout_s`` bounds every collective (PyTorch's default
    otherwise)."""
    global _device
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device is None and _device is None:
        if torch.cuda.is_available():
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        else:
            device = torch.device("cpu")
    if device is not None:
        _device = torch.device(device)
        if _device.type == "cuda":
            torch.cuda.set_device(_device)
    if not dist.is_initialized() and (
            coordinator_address is not None or num_processes is not None
            or launched):
        if backend is None:
            backend = "nccl" if _device.type == "cuda" else "gloo"
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        if coordinator_address is not None or num_processes is not None:
            kw.update(init_method=coordinator_address or "env://",
                      world_size=int(num_processes or 1),
                      rank=int(process_id or 0))
        if backend == "nccl":
            kw["device_id"] = _device
        dist.init_process_group(backend, **kw)
    rank, world = _rank_and_world()
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "device": str(rank_device()),
    }


__all__ = ["global_batch_shape", "host_row_slice",
           "host_local_batch_to_global", "maybe_initialize", "rank_device"]
