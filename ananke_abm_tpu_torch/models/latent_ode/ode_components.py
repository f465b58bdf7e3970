"""Alternative ODE building blocks (port of
``ananke_abm_tpu/models/latent_ode/ode_components.py``): a time-embedded
drift with a learnable ``restart_alpha * (x0 - x)`` pullback toward the
initial state, solved with continuous-adjoint gradients. Unused by the
main training path; part of the family's API.

flax names of :class:`TimeEmbedODEFunc`: ``Dense_0``, ``Dense_1``,
``restart_alpha``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.func import functional_call

from ananke_abm_tpu_torch.models.gen_schedule.params import (
    _linear,
    entries_to_flax,
    load_entries,
)
from ananke_abm_tpu_torch.ode import odeint_adjoint


class TimeEmbedODEFunc(nn.Module):
    """dx/dt = net([x, time_embed(t)]) + restart_alpha * (x0 - x)."""

    def __init__(self, dim: int, hidden_dim: int = 64,
                 time_embed_dim: int = 8):
        super().__init__()
        self.time_embed_dim = time_embed_dim
        self.dense0 = nn.Linear(dim + time_embed_dim, hidden_dim)
        self.dense1 = nn.Linear(hidden_dim, dim)
        self.restart_alpha = nn.Parameter(torch.tensor(0.1))
        self.register_buffer("freqs", 2.0 ** torch.arange(
            time_embed_dim // 2, dtype=torch.float32), persistent=False)

    def forward(self, t, x, x0):
        ang = t * self.freqs * 2 * math.pi / 24.0
        temb = torch.cat([torch.sin(ang), torch.cos(ang)]).expand(
            x.shape[0], self.time_embed_dim)
        h = torch.tanh(self.dense0(torch.cat([x, temb], -1)))
        return self.dense1(h) + self.restart_alpha * (x0 - x)


def ode_block_solve(func: TimeEmbedODEFunc, params, x0, times,
                    rtol: float = 1e-5, atol: float = 1e-5):
    """Integrate ``func`` over ``times`` with continuous-adjoint gradients.
    ``params`` ({name: tensor}, ``dict(func.named_parameters())`` where
    None) and ``x0`` (which the pullback reads too) travel as the
    solver's ``args``, so their gradients flow through the adjoint."""
    if params is None:
        params = dict(func.named_parameters())
    names = list(params)

    def rhs(t, x, args):
        p, x0_ref = args
        return functional_call(func, dict(zip(names, p)), (t, x, x0_ref))

    return odeint_adjoint(rhs, x0, times, (tuple(params.values()), x0),
                          rtol=rtol, atol=atol)


def param_entries(func: TimeEmbedODEFunc) -> dict:
    out = {}
    _linear(("Dense_0",), func.dense0, out)
    _linear(("Dense_1",), func.dense1, out)
    out[("restart_alpha",)] = ("=", [func.restart_alpha])
    return out


def load_flax_params(func: TimeEmbedODEFunc, params: dict) -> None:
    load_entries(param_entries(func), params)


def to_flax_params(func: TimeEmbedODEFunc) -> dict:
    return entries_to_flax(param_entries(func))
