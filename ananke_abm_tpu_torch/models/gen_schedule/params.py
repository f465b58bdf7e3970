"""Weights across packages: the JAX package's flax ``params`` tree and
``batch_stats`` <-> the port's :class:`ScheduleVAE`.

Trees are nested dicts of numpy arrays, as a checkpoint of either package
holds them. flax ``Dense.kernel`` is (in, out) and ``nn.Linear.weight``
(out, in); flax ``Conv.kernel`` is (k, in, out) and ``nn.Conv1d.weight``
(out, in, k). The recurrent cells' gates are restacked: flax's GRU keeps
``ir, iz, in`` (biased) and ``hr, hz`` (no bias), ``hn`` (biased);
``nn.GRU`` stacks (r, z, n) into ``weight_ih`` / ``weight_hh`` with
``bias_ih = (ir, iz, in)`` and ``bias_hh = (0, 0, hn)``. flax's
``OptimizedLSTMCell`` keeps ``ii, if, ig, io`` (no bias) and ``hi, hf, hg,
ho`` (biased); ``nn.LSTM`` stacks (i, f, g, o) with ``bias_ih = 0``.
Names (``encoder/...``, ``decoder/...``):

- ``Embed_0/embedding``; CNN: ``ResidualConvBlock_i/{Conv_0, Conv_1,
  Conv_2 (the 1x1 residual), GroupNorm_0/1 or SyncBatchNorm_0/1}``,
  ``Dense_0`` (mu), ``Dense_1`` (logvar); RNN: ``LayerNorm_0``,
  ``GRUCell_0/1`` or ``OptimizedLSTMCell_0/1`` (forward, reversed);
- low rank: ``time_basis``, ``latent_to_factor``, ``bias``; PDS:
  ``latent_proj_in``, ``latent_proj_out``, ``time_basis``,
  ``latent_bias``, ``pds_linear``, ``pds_bias``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ananke_abm_tpu_torch.models.gen_schedule.encoders import (
    ScheduleEncoderCNN,
)

# a flax leaf's layout against its PyTorch view: "T" transposed, "conv"
# (k, in, out) against (out, in, k), "=" as is
_GRU_GATES = (("ir", "hr"), ("iz", "hz"), ("in", "hn"))
_LSTM_GATES = (("ii", "hi"), ("if", "hf"), ("ig", "hg"), ("io", "ho"))


def _rnn_entries(rnn, cell):
    """flax path (under ``encoder``) -> (layout, [views]) for each gate of
    both directions. A leaf with several views is their sum; loading it
    writes the first and zeroes the others."""
    H = rnn.hidden_size
    out = {}
    name = "GRUCell" if cell == "gru" else "OptimizedLSTMCell"
    gates = _GRU_GATES if cell == "gru" else _LSTM_GATES
    for d, sfx in enumerate(("_l0", "_l0_reverse")):
        w_ih, w_hh = (getattr(rnn, f"weight_{k}{sfx}") for k in ("ih", "hh"))
        b_ih, b_hh = (getattr(rnn, f"bias_{k}{sfx}") for k in ("ih", "hh"))
        for g, (i_gate, h_gate) in enumerate(gates):
            rows = slice(g * H, (g + 1) * H)
            pre = (f"{name}_{d}",)
            out[pre + (i_gate, "kernel")] = ("T", [w_ih[rows]])
            out[pre + (h_gate, "kernel")] = ("T", [w_hh[rows]])
            if cell == "gru" and i_gate != "in":  # hr, hz have no bias
                out[pre + (i_gate, "bias")] = ("=", [b_ih[rows], b_hh[rows]])
            elif cell == "gru":
                out[pre + ("in", "bias")] = ("=", [b_ih[rows]])
                out[pre + ("hn", "bias")] = ("=", [b_hh[rows]])
            else:  # ii..io have no bias
                out[pre + (h_gate, "bias")] = ("=", [b_hh[rows], b_ih[rows]])
    return out


def _linear(path, layer, out):
    out[path + ("kernel",)] = ("T", [layer.weight])
    if layer.bias is not None:
        out[path + ("bias",)] = ("=", [layer.bias])


def _norm_name(norm):
    return "SyncBatchNorm" if isinstance(norm, nn.BatchNorm1d) else "GroupNorm"


def encoder_entries(enc) -> dict:
    """flax path -> (layout, [PyTorch views]) for every parameter of a CNN
    or RNN schedule encoder, under ``encoder``."""
    out = {}
    E = ("encoder",)
    out[E + ("Embed_0", "embedding")] = ("=", [enc.embed.weight])
    if isinstance(enc, ScheduleEncoderCNN):
        for i, block in enumerate(enc.blocks):
            pre = E + (f"ResidualConvBlock_{i}",)
            convs = [block.conv0, block.conv1] + (
                [block.proj] if block.proj is not None else [])
            for j, conv in enumerate(convs):
                out[pre + (f"Conv_{j}", "kernel")] = ("conv", [conv.weight])
                out[pre + (f"Conv_{j}", "bias")] = ("=", [conv.bias])
            for j, norm in enumerate((block.norm0, block.norm1)):
                q = pre + (f"{_norm_name(norm)}_{j}",)
                out[q + ("scale",)] = ("=", [norm.weight])
                out[q + ("bias",)] = ("=", [norm.bias])
    else:
        if enc.norm is not None:
            out[E + ("LayerNorm_0", "scale")] = ("=", [enc.norm.weight])
            out[E + ("LayerNorm_0", "bias")] = ("=", [enc.norm.bias])
        out.update({E + k: v for k, v in
                    _rnn_entries(enc.rnn, enc.cell).items()})
    _linear(E + ("Dense_0",), enc.mu, out)
    _linear(E + ("Dense_1",), enc.logvar, out)
    return out


def param_entries(model) -> dict:
    """flax path -> (layout, [PyTorch views]) for every parameter."""
    out = encoder_entries(model.encoder)
    dec = model.decoder
    D = ("decoder",)
    out[D + ("time_basis",)] = ("=", [dec.time_basis])
    if model.use_pds:
        _linear(D + ("latent_proj_in",), dec.latent_proj_in, out)
        _linear(D + ("latent_proj_out",), dec.latent_proj_out, out)
        _linear(D + ("pds_linear",), dec.pds_linear, out)
        out[D + ("latent_bias",)] = ("=", [dec.latent_bias])
        out[D + ("pds_bias",)] = ("=", [dec.pds_bias])
    else:
        _linear(D + ("latent_to_factor",), dec.latent_to_factor, out)
        out[D + ("bias",)] = ("=", [dec.bias])
    return out


def stats_entries(model) -> dict:
    """flax ``batch_stats`` path -> BatchNorm running buffer (empty for
    models without batch norm)."""
    out = {}
    enc = model.encoder
    for i, block in enumerate(getattr(enc, "blocks", ())):
        for j, norm in enumerate((block.norm0, block.norm1)):
            if isinstance(norm, nn.BatchNorm1d):
                q = ("encoder", f"ResidualConvBlock_{i}", f"SyncBatchNorm_{j}")
                out[q + ("mean",)] = norm.running_mean
                out[q + ("var",)] = norm.running_var
    return out


def _to_torch(a, layout):
    a = np.asarray(a)
    if layout == "T":
        a = a.T
    elif layout == "conv":
        a = a.transpose(2, 1, 0)
    return torch.tensor(a)


def _to_flax(t, layout):
    a = t.detach().cpu().numpy()
    if layout == "T":
        a = a.T
    elif layout == "conv":
        a = a.transpose(2, 1, 0)
    # np.ascontiguousarray makes a 0-d array 1-d
    return np.ascontiguousarray(a) if a.ndim else a.copy()


def _get(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise KeyError(f"flax tree has no {'/'.join(path)}")
        tree = tree[key]
    return tree


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


@torch.no_grad()
def load_entries(entries: dict, params: dict):
    """Copy a flax ``params`` tree into the views that ``entries`` (flax
    path -> (layout, [views])) names. Raises on a missing, extra or
    misshapen leaf."""
    extra = set(_leaf_paths(params)) - set(entries)
    if extra:
        raise KeyError(f"flax tree has leaves the model lacks: "
                       f"{sorted('/'.join(p) for p in extra)}")
    for path, (layout, views) in entries.items():
        value = _to_torch(_get(params, path), layout)
        if value.shape != views[0].shape:
            raise ValueError(f"{'/'.join(path)}: flax {tuple(value.shape)} "
                             f"vs model {tuple(views[0].shape)}")
        views[0].copy_(value)
        for other in views[1:]:
            other.zero_()


@torch.no_grad()
def load_flax_params(model, params: dict, batch_stats: dict | None = None):
    """Copy a flax ``params`` tree (and ``batch_stats``, where the model has
    batch norm) into ``model``. Raises on a missing, extra or misshapen
    leaf."""
    load_entries(param_entries(model), params)
    stats = stats_entries(model)
    if stats:
        if not batch_stats:
            raise KeyError("the model has batch norm but no batch_stats")
        for path, buf in stats.items():
            buf.copy_(torch.tensor(np.asarray(_get(batch_stats, path))))


def entries_to_flax(entries: dict) -> dict:
    """The views that ``entries`` names as a flax ``params`` tree of numpy
    arrays."""
    out = {}
    for path, (layout, views) in entries.items():
        total = views[0].detach()
        for other in views[1:]:
            total = total + other.detach()
        _set(out, path, _to_flax(total, layout))
    return out


def to_flax_params(model) -> dict:
    """The model's parameters as a flax ``params`` tree of numpy arrays."""
    return entries_to_flax(param_entries(model))


def to_flax_batch_stats(model) -> dict:
    """The running statistics as a flax ``batch_stats`` tree ({} without
    batch norm)."""
    out = {}
    for path, buf in stats_entries(model).items():
        _set(out, path, buf.detach().cpu().numpy().copy())
    return out
