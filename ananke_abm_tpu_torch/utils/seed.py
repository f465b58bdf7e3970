"""Seeding helpers (the port's ``ananke_abm_tpu.utils.seed``).

The JAX package seeds the host RNGs and returns a base PRNG key; the port
seeds the host RNGs and PyTorch's global generator, and returns an
explicit ``torch.Generator``. The pipelines draw every random number from
explicit generators (:func:`generator`), never from the global one.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def generator(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers ``key``
    (e.g. ``(seed, epoch)``): the same key gives the same stream, and keys
    that differ give independent streams (numpy's ``SeedSequence``)."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    seed = int(state[0]) << 32 | int(state[1])
    return torch.Generator(device=device).manual_seed(seed & (2**63 - 1))


def set_seed(seed: int) -> torch.Generator:
    """Seed python's, numpy's and PyTorch's global RNGs; returns a CPU
    generator seeded by ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return generator("cpu", seed)
