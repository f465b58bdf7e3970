"""Command-line entry points of the port, run as modules
(``python -m ananke_abm_tpu_torch.cli.main``, ``python -m
ananke_abm_tpu_torch.cli.rgen_schedule``), and what they share: the
device that ``ANANKE_PLATFORM`` names, the ``--data-parallel`` mesh and
the existing-path argument type."""
from __future__ import annotations

import argparse
import os

DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}
# what --data-parallel hands the entry points as their ``mesh``: the
# reference builds a mesh over every attached device there
DATA_PARALLEL = "every attached device"


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
    return DATA_PARALLEL if data_parallel else None


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path '{path}' does not exist.")
    return path
