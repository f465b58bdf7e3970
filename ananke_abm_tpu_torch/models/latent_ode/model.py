"""GenerativeODE: a conditional latent SDE over rich-feature positions
(port of ``ananke_abm_tpu/models/latent_ode/model.py``).

- a linear zone-feature encoder; a VAE encoder over [person attributes,
  home / work zone embeddings, initial purpose / mode features] ->
  (mu, logvar) of h0;
- position p = [zone embedding, purpose features, mode features]; the
  second-order state [p, v]; the solver's state y = [p, v, h], dh/dt = 0;
- drift dv = net([p, v, h, sin t, cos t]) - correction_strength * dU/dp,
  U(p) = sum (sigmoid(is_moving) - (1 - sigmoid(is_stationary)))^2. The
  reference takes ``jax.grad`` of U inside each step; here its gradient is
  written in closed form (:func:`potential_grad`): with d = sigmoid(m) - 1
  + sigmoid(s), dU/dm = 2d sigmoid'(m) and dU/ds = 2d sigmoid'(s) on the
  two coordinates U reads, zero elsewhere;
- decode: location logits against the candidate zone embeddings,
  purpose and mode linear heads.

Randomness: ``forward(..., generator)`` draws the reparameterisation noise
(``mu.shape``) and then the SDE's step noise from ``generator``; ``eps``
and ``noise`` replace those draws (the reference draws them from
``fold_in(rng, 0)`` and ``fold_in(rng, 1)``). A ``utils.seed.RowDraws``
generator (a batch sharded over ranks) draws the whole batch's noise and
keeps its rows; a dopri5 solve's controller then reads the error norms over
the ranks of its group.

Weights across packages: :func:`load_flax_params` / :func:`to_flax_params`
read and write the JAX package's flax tree: ``zone_feature_encoder``,
``encoder/{layers_0, layers_2}`` (flax's ``nn.Sequential`` names),
``dynamics/{Dense_0, ResidualBlock_i/{Dense_0, Dense_1}, Dense_1}``,
``decoder_loc``, ``decoder_purpose``, ``decoder_mode``; flax kernels are
(in, out). :func:`init_params` initialises as flax does, in distribution.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ananke_abm_tpu_torch.models.day_clock import day_clock
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    _linear,
    entries_to_flax,
    load_entries,
)
from ananke_abm_tpu_torch.models.gen_schedule.vae import _variance_scaling
from ananke_abm_tpu_torch.models.latent_ode.config import GenerativeODEConfig
from ananke_abm_tpu_torch.ode import euler_maruyama_solve, odeint
from ananke_abm_tpu_torch.utils.seed import draw


class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense0 = nn.Linear(dim, dim)
        self.dense1 = nn.Linear(dim, dim)

    def forward(self, x):
        h = torch.tanh(self.dense0(x))
        return torch.tanh(x + self.dense1(h))


class DynamicsNet(nn.Module):
    """The drift network (acceleration for 2nd order, velocity else)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 num_blocks: int):
        super().__init__()
        self.inp = nn.Linear(in_dim, hidden_dim)
        self.blocks = nn.ModuleList(ResidualBlock(hidden_dim)
                                    for _ in range(num_blocks))
        self.out = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        x = torch.relu(self.inp(x))
        for block in self.blocks:
            x = block(x)
        return self.out(x)


class GenerativeODE(nn.Module):
    def __init__(self, person_feat_dim: int, num_zone_features: int,
                 config: GenerativeODEConfig):
        super().__init__()
        c = self.config = config
        zs = c.zone_embed_dim
        self.zone_feature_encoder = nn.Linear(num_zone_features, zs)
        enc_in = (person_feat_dim + 2 * zs + c.purpose_feature_dim
                  + c.mode_feature_dim)
        self.encoder = nn.Sequential(
            nn.Linear(enc_in, c.encoder_hidden_dim), nn.ReLU(),
            nn.Linear(c.encoder_hidden_dim, 2 * c.hidden_dim))
        pos = c.position_dim
        dyn_in = (2 * pos if c.use_second_order_sde else pos) \
            + c.hidden_dim + 2
        self.dynamics = DynamicsNet(dyn_in, pos, c.ode_hidden_dim,
                                    c.num_residual_blocks)
        self.decoder_loc = nn.Linear(zs, zs)
        self.decoder_purpose = nn.Linear(c.purpose_feature_dim,
                                         len(c.purpose_groups))
        self.decoder_mode = nn.Linear(c.mode_feature_dim, c.num_modes)
        # p's columns that the constraint potential reads: is_moving (the
        # mode features' first), is_stationary (the purpose features');
        # a buffer, so no step copies the index to the device
        self.register_buffer("flag_cols", torch.tensor(
            [zs + c.purpose_feature_dim, zs]), persistent=False)

    # ---- physics constraint ----
    def _potential(self, p):
        """U(p), as the reference's ``_potential`` (for tests)."""
        s = torch.sigmoid(p.index_select(-1, self.flag_cols))
        return torch.sum((s[..., 0] - (1.0 - s[..., 1])) ** 2)

    def potential_grad(self, p):
        """dU/dp at the two flag columns, (..., 2) as [d/dm, d/ds]: the
        closed form of the reference's ``jax.grad(_potential)``."""
        s = torch.sigmoid(p.index_select(-1, self.flag_cols))
        d = s[..., :1] - (1.0 - s[..., 1:])
        return (2.0 * d) * (s * (1.0 - s))

    def dynamics_rhs(self, t, y):
        """dy/dt for y = [state, h]; ``t`` a 0-d tensor or a float."""
        c = self.config
        S, P = c.state_dim, c.position_dim
        state, h = y[:, :S], y[:, S:]
        b = y.shape[0]
        clock = day_clock(t, b, y)
        p = state[:, :P]
        if c.use_second_order_sde:
            v = state[:, P:]
            a = self.dynamics(torch.cat([p, v, h, clock], -1))
        else:
            a = self.dynamics(torch.cat([p, h, clock], -1))
        corr = -c.correction_strength * self.potential_grad(p)
        a = a.index_add(1, self.flag_cols, corr)
        parts = [v, a] if c.use_second_order_sde else [a]
        return torch.cat(parts + [torch.zeros_like(h)], -1)

    def encode_h0(self, person_features, home_embed, work_embed,
                  initial_purpose_features, initial_mode_features,
                  generator=None, eps=None):
        out = self.encoder(torch.cat(
            [person_features, home_embed, work_embed,
             initial_purpose_features, initial_mode_features], -1))
        mu, logvar = torch.chunk(out, 2, dim=-1)
        if eps is None:
            eps = draw(torch.randn, mu.shape, generator, mu.device,
                       mu.dtype)
        return mu + torch.exp(0.5 * logvar) * eps, mu, logvar

    def forward(self, person_features, home_zone_features,
                work_zone_features, initial_purpose_features,
                initial_mode_features, times, all_zone_features,
                generator=None, eps=None, noise=None):
        """The reference's 8 outputs: (loc_logits, loc_embed, purp_logits,
        mode_logits, purpose_feat, mode_feat, mu, logvar). ``times``: (T,)
        hours, a host array (the SDE reads it there) or a tensor."""
        c = self.config
        candidate = self.zone_feature_encoder(all_zone_features)
        home_embed = self.zone_feature_encoder(home_zone_features)
        work_embed = self.zone_feature_encoder(work_zone_features)
        h0, mu, logvar = self.encode_h0(
            person_features, home_embed, work_embed,
            initial_purpose_features, initial_mode_features, generator, eps)
        p0 = torch.cat([home_embed, initial_purpose_features,
                        initial_mode_features], -1)
        s0 = (torch.cat([p0, torch.zeros_like(p0)], -1)
              if c.use_second_order_sde else p0)
        y0 = torch.cat([s0, h0], -1)

        def rhs(t, y, args):
            return self.dynamics_rhs(t, y)

        if c.enable_sde:
            g = y0.new_zeros(y0.shape[-1])
            g[:c.state_dim] = c.sde_noise_strength

            def diffusion(t, y, args):
                return g

            if c.sde_dt:
                ys = euler_maruyama_solve(
                    rhs, diffusion, y0, times, generator, dt=c.sde_dt,
                    num_steps=int(round(c.sde_span_hours / c.sde_dt)),
                    noise=noise)
            else:
                ys = euler_maruyama_solve(rhs, diffusion, y0, times,
                                          generator,
                                          substeps=c.sde_substeps,
                                          noise=noise)
        else:
            ts = torch.as_tensor(times, dtype=torch.float32).to(y0.device)
            ys = odeint(rhs, y0, ts, method=c.ode_method, rtol=c.rtol,
                        atol=c.atol, substeps=c.rk4_substeps, adjoint=False,
                        group=getattr(generator, "group", None))
        ys = ys.transpose(0, 1)  # (B, T, D)
        pred_p = ys[..., :c.position_dim]
        zs, pf = c.zone_embed_dim, c.purpose_feature_dim
        loc_embed = pred_p[..., :zs]
        purpose_feat = pred_p[..., zs:zs + pf]
        mode_feat = pred_p[..., zs + pf:]
        loc_logits = torch.matmul(self.decoder_loc(loc_embed), candidate.T)
        return (loc_logits, loc_embed, self.decoder_purpose(purpose_feat),
                self.decoder_mode(mode_feat), purpose_feat, mode_feat, mu,
                logvar)

    def encode_zones(self, all_zone_features):
        return self.zone_feature_encoder(all_zone_features)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as flax's ``nn.Dense`` does, in distribution: lecun-normal
    (truncated) kernels, zero biases. ``generator`` is a CPU generator; the
    draws are copied to the model's device."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            t = torch.empty(m.weight.shape)
            _variance_scaling(t, m.in_features, generator)
            m.weight.copy_(t)
            m.bias.zero_()


def _mlp_entries(path, net: DynamicsNet, out):
    _linear(path + ("Dense_0",), net.inp, out)
    for i, block in enumerate(net.blocks):
        q = path + (f"ResidualBlock_{i}",)
        _linear(q + ("Dense_0",), block.dense0, out)
        _linear(q + ("Dense_1",), block.dense1, out)
    _linear(path + ("Dense_1",), net.out, out)


def param_entries(model: GenerativeODE) -> dict:
    """flax path -> (layout, [PyTorch views]) for every parameter."""
    out = {}
    _linear(("zone_feature_encoder",), model.zone_feature_encoder, out)
    _linear(("encoder", "layers_0"), model.encoder[0], out)
    _linear(("encoder", "layers_2"), model.encoder[2], out)
    _mlp_entries(("dynamics",), model.dynamics, out)
    for name in ("decoder_loc", "decoder_purpose", "decoder_mode"):
        _linear((name,), getattr(model, name), out)
    return out


def load_flax_params(model: GenerativeODE, params: dict) -> None:
    """Copy the JAX package's flax ``params`` tree into ``model``."""
    load_entries(param_entries(model), params)


def to_flax_params(model: GenerativeODE) -> dict:
    """The model's parameters as a flax ``params`` tree of numpy arrays."""
    return entries_to_flax(param_entries(model))
