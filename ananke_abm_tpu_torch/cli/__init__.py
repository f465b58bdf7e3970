"""Command-line entry points of the port, run as modules
(``python -m ananke_abm_tpu_torch.cli.main``, ``python -m
ananke_abm_tpu_torch.cli.rgen_schedule``), and what they share: the
device that ``ANANKE_PLATFORM`` names, the ``--data-parallel`` mesh and
the existing-path argument type.

``--data-parallel`` runs one process a device under ``torchrun``::

    torchrun --nproc-per-node=N -m ananke_abm_tpu_torch.cli.main ...

(gloo on the CPU with ``ANANKE_PLATFORM=cpu``, NCCL on the cards)."""
from __future__ import annotations

import argparse
import os

DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def platform_device() -> str:
    """The device that ``ANANKE_PLATFORM`` names (the card when unset)."""
    name = os.environ.get("ANANKE_PLATFORM")
    if not name:
        return "cuda"
    if name not in DEVICES:
        raise ValueError(f"ANANKE_PLATFORM={name!r}: expected one of "
                         f"{sorted(DEVICES)}")
    return DEVICES[name]


def _mesh(data_parallel: bool):
    """What ``--data-parallel`` hands the entry points as their ``mesh``.
    Under ``torchrun`` the process group starts on ``ANANKE_PLATFORM``'s
    device (``parallel.maybe_initialize``) and the mesh spans its ranks
    with ``zone_parallel=1``, as the reference's CLI builds it over every
    device. A process that runs alone takes no mesh (the single-device
    run), unless the host has more than one card: that raises, naming
    ``torchrun``, since the reference would use them all."""
    if not data_parallel:
        return None
    import torch

    from ananke_abm_tpu_torch.parallel import make_mesh, maybe_initialize

    device = platform_device()
    maybe_initialize(device="cpu" if device == "cpu" else None)
    if torch.distributed.is_initialized():
        return make_mesh(zone_parallel=1)
    if device == "cuda" and torch.cuda.device_count() > 1:
        raise RuntimeError(
            f"--data-parallel on a host with {torch.cuda.device_count()} "
            "cards runs one process a card: torchrun --nproc-per-node=N -m "
            "ananke_abm_tpu_torch.cli.<main|rgen_schedule> ...")
    return None


def finish():
    """End the process group a ``--data-parallel`` command started."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path '{path}' does not exist.")
    return path
