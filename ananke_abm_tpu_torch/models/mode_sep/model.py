"""ModeSepModel: a 2nd-order ODE over a location-embedding state (port of
``ananke_abm_tpu/models/mode_sep/model.py``):

- a learnable class table (Z, E) of zone-embedding anchors;
- a static person context h from [age, income, emb(home), emb(work)];
- the state y = [p, v, h]; drift a = net([p, v, h, sin t, cos t]), dp = v,
  dh = 0; p starts at the (gradient-stopped) home row of the class table;
- decode: an MLP of p, cosine logits against the normalised class table
  over tau (both norms + 1e-8).

The solve is the port's fixed-step RK4 (or DOPRI5, forward only) over the
batch of persons, or, with ``enable_sde``, Euler–Maruyama with diagonal
noise on [p, v] drawing from the caller's ``generator`` (``noise``
replaces the draws).

Weights across packages: :func:`load_flax_params` / :func:`to_flax_params`
read and write the JAX package's flax tree: ``class_table``,
``zone_embed/embedding``, ``context_encoder/{layers_0, layers_2}``,
``drift/{Dense_0, ResidualBlock_i/{Dense_0, Dense_1}, Dense_1}``,
``decoder/{layers_0, layers_2}``. :func:`init_params` initialises as flax
does, in distribution: the drift's output layer zero (the dynamics start
at rest), the class table xavier-uniform.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ananke_abm_tpu_torch.models.day_clock import day_clock
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    _linear,
    entries_to_flax,
    load_entries,
)
from ananke_abm_tpu_torch.models.gen_schedule.vae import _variance_scaling
from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig
from ananke_abm_tpu_torch.ode import euler_maruyama_solve, odeint

TRAIT_DIM = 2  # [age / 100, income / 1e5]


class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense0 = nn.Linear(dim, dim)
        self.dense1 = nn.Linear(dim, dim)

    def forward(self, x):
        h = torch.relu(self.dense0(x))
        return torch.relu(x + self.dense1(h))


class DriftNet(nn.Module):
    """Acceleration a = f([p, v, h, sin t, cos t]); its output layer is
    zero-initialised (:func:`init_params`), so the dynamics start at rest
    and the squared velocity penalties have finite first gradients."""

    def __init__(self, emb_dim: int, context_dim: int, hidden_dim: int,
                 num_blocks: int):
        super().__init__()
        self.inp = nn.Linear(2 * emb_dim + context_dim + 2, hidden_dim)
        self.blocks = nn.ModuleList(ResidualBlock(hidden_dim)
                                    for _ in range(num_blocks))
        self.out = nn.Linear(hidden_dim, emb_dim)

    def forward(self, p, v, h, t):
        x = torch.cat([p, v, h, day_clock(t, p.shape[0], p)], -1)
        x = torch.relu(self.inp(x))
        for block in self.blocks:
            x = block(x)
        return self.out(x)


class ModeSepModel(nn.Module):
    def __init__(self, Z: int, config: ModeSepConfig):
        super().__init__()
        c = self.config = config
        self.Z = Z
        self.class_table = nn.Parameter(torch.zeros(Z, c.emb_dim))
        self.zone_embed = nn.Embedding(Z, c.zone_emb_dim)
        self.context_encoder = nn.Sequential(
            nn.Linear(TRAIT_DIM + 2 * c.zone_emb_dim, c.hidden_dim),
            nn.ReLU(), nn.Linear(c.hidden_dim, c.context_dim))
        self.drift = DriftNet(c.emb_dim, c.context_dim, c.hidden_dim,
                              c.num_res_blocks)
        self.decoder = nn.Sequential(
            nn.Linear(c.emb_dim, c.hidden_dim), nn.ReLU(),
            nn.Linear(c.hidden_dim, c.emb_dim))

    def encode_context(self, traits, home_idx, work_idx):
        return self.context_encoder(torch.cat(
            [traits, self.zone_embed(home_idx), self.zone_embed(work_idx)],
            -1))

    def initial_state(self, home_idx, traits, work_idx):
        p0 = self.class_table.detach()[home_idx]
        h = self.encode_context(traits, home_idx, work_idx)
        return torch.cat([p0, torch.zeros_like(p0), h], -1)

    def rhs(self, t, y):
        E = self.config.emb_dim
        p, v, h = y[:, :E], y[:, E:2 * E], y[:, 2 * E:]
        a = self.drift(p, v, h, t)
        return torch.cat([v, a, torch.zeros_like(h)], -1)

    def decode_logits(self, p_t):
        pred_emb = self.decoder(p_t)  # (B, T, E)
        table = self.class_table
        table_n = table / (torch.linalg.vector_norm(
            table, dim=-1, keepdim=True) + 1e-8)
        emb_n = pred_emb / (torch.linalg.vector_norm(
            pred_emb, dim=-1, keepdim=True) + 1e-8)
        logits = torch.matmul(emb_n, table_n.T) / self.config.softmax_tau
        return pred_emb, logits

    def forward(self, times_union, home_idx, work_idx, traits,
                generator=None, noise=None):
        """(pred_emb (B, T, E), logits (B, T, Z), v (B, T, E)).
        ``times_union``: (T,) hours, a tensor (RK4 steps on the device) or
        a host array. ``generator`` / ``noise``: the SDE's draws."""
        c = self.config
        E = c.emb_dim
        y0 = self.initial_state(home_idx, traits, work_idx)

        def rhs(t, y, args):
            return self.rhs(t, y)

        if c.enable_sde and c.sde_noise_strength > 0.0:
            g = y0.new_zeros(y0.shape[-1])
            g[:2 * E] = c.sde_noise_strength

            def diffusion(t, y, args):
                return g

            if c.sde_dt:
                ys = euler_maruyama_solve(
                    rhs, diffusion, y0, times_union, generator,
                    dt=c.sde_dt,
                    num_steps=int(round(c.sde_span_hours / c.sde_dt)),
                    noise=noise)
            else:
                ys = euler_maruyama_solve(rhs, diffusion, y0, times_union,
                                          generator,
                                          substeps=c.sde_substeps,
                                          noise=noise)
        else:
            ts = torch.as_tensor(times_union, dtype=torch.float32).to(
                y0.device)
            ys = odeint(rhs, y0, ts, method=c.ode_method, rtol=c.rtol,
                        atol=c.atol, substeps=c.rk4_substeps, adjoint=False)
        ys = ys.transpose(0, 1)  # (B, T, 2E + H)
        p_t, v_t = ys[..., :E], ys[..., E:2 * E]
        pred_emb, logits = self.decode_logits(p_t)
        return pred_emb, logits, v_t


@torch.no_grad()
def init_params(model: ModeSepModel, generator: torch.Generator) -> None:
    """Initialise as flax does, in distribution: lecun-normal (truncated)
    Dense kernels with zero biases, the drift's output kernel zero, the
    zone embedding a normal of stddev 1/sqrt(zone_emb_dim), the class
    table xavier-uniform. ``generator`` is a CPU generator."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            t = torch.empty(m.weight.shape)
            _variance_scaling(t, m.in_features, generator)
            m.weight.copy_(t)
            m.bias.zero_()
    model.drift.out.weight.zero_()
    t = torch.empty(model.zone_embed.weight.shape)
    _variance_scaling(t, t.shape[1], generator, truncated=False)
    model.zone_embed.weight.copy_(t)
    Z, E = model.class_table.shape
    a = math.sqrt(6.0 / (Z + E))
    model.class_table.copy_(torch.empty(Z, E).uniform_(-a, a,
                                                       generator=generator))


def param_entries(model: ModeSepModel) -> dict:
    """flax path -> (layout, [PyTorch views]) for every parameter."""
    out = {("class_table",): ("=", [model.class_table]),
           ("zone_embed", "embedding"): ("=", [model.zone_embed.weight])}
    _linear(("context_encoder", "layers_0"), model.context_encoder[0], out)
    _linear(("context_encoder", "layers_2"), model.context_encoder[2], out)
    d = model.drift
    _linear(("drift", "Dense_0"), d.inp, out)
    for i, block in enumerate(d.blocks):
        q = ("drift", f"ResidualBlock_{i}")
        _linear(q + ("Dense_0",), block.dense0, out)
        _linear(q + ("Dense_1",), block.dense1, out)
    _linear(("drift", "Dense_1"), d.out, out)
    _linear(("decoder", "layers_0"), model.decoder[0], out)
    _linear(("decoder", "layers_2"), model.decoder[2], out)
    return out


def load_flax_params(model: ModeSepModel, params: dict) -> None:
    """Copy the JAX package's flax ``params`` tree into ``model``."""
    load_entries(param_entries(model), params)


def to_flax_params(model: ModeSepModel) -> dict:
    """The model's parameters as a flax ``params`` tree of numpy arrays."""
    return entries_to_flax(param_entries(model))
