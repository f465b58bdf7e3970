"""Seeding helpers (the port's ``ananke_abm_tpu.utils.seed``).

The JAX package seeds the host RNGs and returns a base PRNG key; the port
seeds the host RNGs and PyTorch's global generator, and returns an
explicit ``torch.Generator``. The pipelines draw every random number from
explicit generators (:func:`generator`), never from the global one.

Under a mesh a batch's rows lie on several ranks; :class:`RowDraws` then
stands for the generator, and :func:`draw` makes every draw at the whole
batch's shape and keeps this rank's rows, so the sharded run draws the
single-device run's numbers.
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


class RowDraws:
    """The generator of a batch whose rows lie on several ranks: ``rows``
    (a slice) of the ``total`` rows are this rank's, ``group`` the process
    group of the ranks holding the others. Every rank holds a generator
    in the same state."""

    def __init__(self, generator: torch.Generator, rows: slice, total: int,
                 group=None):
        self.generator = generator
        self.rows = rows
        self.total = int(total)
        self.group = group

    @property
    def device(self):
        return self.generator.device


def draw(fn, shape, generator, device=None, dtype=None):
    """``fn(shape, generator=generator)`` for ``torch.rand`` or
    ``torch.randn``, the leading dim the batch's rows. A :class:`RowDraws`
    draws all ``total`` rows and keeps its own."""
    if not isinstance(generator, RowDraws):
        return fn(tuple(shape), generator=generator, device=device,
                  dtype=dtype)
    rows = generator.rows
    if shape[0] != rows.stop - rows.start:
        raise ValueError(f"a draw of {shape[0]} rows for the rows {rows} of "
                         f"{generator.total}")
    full = (generator.total,) + tuple(shape[1:])
    return fn(full, generator=generator.generator, device=device,
              dtype=dtype)[rows]

