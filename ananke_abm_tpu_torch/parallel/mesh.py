"""The (agents x zones) device mesh and the row layout of a sharded batch
(port of ``ananke_abm_tpu/parallel/mesh.py``).

The reference runs one process over many devices and lets GSPMD insert
the collectives. The port runs one process per card (``torchrun``), so a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks with dims ``("agents", "zones")``: agents are the data axis, zones
the model axis. The entry points keep the reference's global semantics: a
mesh run computes what the single-device run computes. Their bodies work
on each rank's local rows with explicit collectives
(``parallel/collectives.py``); :func:`named_sharding`, :func:`shard_batch`
and :func:`replicate` are the API boundary, where a ``NamedSharding``
becomes DTensor placements (``Shard(0)`` on ``agents``, ``Replicate()``
elsewhere).

A batch of ``n`` rows splits over the ``agents`` axis as DTensor's
``Shard(0)`` splits it: ``ceil(n / size)`` rows a rank, the last ranks
short (any ``n`` works, as GSPMD takes uneven shards). The ranks of one
zone group hold the same rows.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

AGENT_AXIS = "agents"
ZONE_AXIS = "zones"


def make_mesh(n_devices: int | None = None, zone_parallel: int | None = None):
    """An (agents, zones) ``DeviceMesh`` over the world's ranks (one rank a
    device, rank ``a * zone_parallel + z`` at coordinate ``(a, z)``).

    ``zone_parallel`` ranks go to the zone (model) axis, the rest to the
    agent (data) axis; the default is 2 when the count is at least 4 and
    even, else 1. ``n_devices`` defaults to the world size and must equal
    it (every rank runs the same program). The device type is "cuda" when
    the ranks run on cards (``distributed.rank_device``), else "cpu".
    Needs an initialised process group (``distributed.maybe_initialize``
    or ``torchrun``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ananke_abm_tpu_torch.parallel.distributed import rank_device

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: run under "
            "torchrun --nproc-per-node=N or call "
            "parallel.maybe_initialize(...) first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: a mesh spans the world's "
                         f"{world} ranks")
    if zone_parallel is None:
        zone_parallel = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    if n_devices % zone_parallel:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"zone_parallel={zone_parallel}")
    device = rank_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    grid = torch.arange(n_devices).reshape(n_devices // zone_parallel,
                                           zone_parallel)
    return DeviceMesh(device.type, grid,
                      mesh_dim_names=(AGENT_AXIS, ZONE_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the mesh dim named ``axis``."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def row_slice(n: int, mesh, axis: str = AGENT_AXIS) -> slice:
    """The rows of an ``n``-row batch that this rank holds under
    ``Shard(0)`` on ``axis``."""
    per = -(-n // axis_size(mesh, axis))
    start = min(n, mesh.get_local_rank(axis) * per)
    return slice(start, min(n, start + per))


def _placements(mesh, axes):
    from torch.distributed.tensor import Replicate, Shard

    if len(axes) > 1 and any(a is not None for a in axes[1:]):
        raise ValueError(f"only the leading dim shards, got {axes}")
    lead = axes[0] if axes else None
    return [Shard(0) if name == lead else Replicate()
            for name in mesh.mesh_dim_names]


def named_sharding(mesh, *axes) -> list:
    """The DTensor placements of the reference's ``NamedSharding(mesh,
    P(*axes))``: ``Shard(0)`` on the mesh dim that ``axes[0]`` names,
    ``Replicate()`` on the others."""
    return _placements(mesh, axes)


def _tree_map(f, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(f, v) for v in tree)
    return f(tree)


def shard_batch(mesh, tree, axis_name: str = AGENT_AXIS):
    """Every leaf (a tensor holding the whole batch on every rank) as a
    DTensor whose leading dim shards over ``axis_name``: each rank keeps
    its :func:`row_slice`."""
    from torch.distributed.tensor import DTensor

    placements = named_sharding(mesh, axis_name)

    def one(x):
        x = torch.as_tensor(x)
        local = x[row_slice(x.shape[0], mesh, axis_name)]
        return DTensor.from_local(local, mesh, placements, shape=x.shape,
                                  stride=x.stride(), run_check=False)

    return _tree_map(one, tree)


def replicate(mesh, tree):
    """Every leaf as a replicated DTensor."""
    from torch.distributed.tensor import DTensor

    placements = named_sharding(mesh)
    return _tree_map(lambda x: DTensor.from_local(
        torch.as_tensor(x), mesh, placements, run_check=False), tree)


def local_rows(x, mesh, axis: str = AGENT_AXIS):
    """``(local rows, global row count)`` of a batch: a DTensor sharded
    over ``axis`` gives its local tensor, a plain tensor (the whole batch,
    the same on every rank) its :func:`row_slice`."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local(), int(x.shape[0])
    return x[row_slice(x.shape[0], mesh, axis)], int(x.shape[0])


__all__ = ["AGENT_AXIS", "ZONE_AXIS", "make_mesh", "named_sharding",
           "shard_batch", "replicate", "row_slice", "local_rows",
           "axis_size"]
