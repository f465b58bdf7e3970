"""Weights across packages: the JAX package's flax parameter tree <-> the
port's :class:`~ananke_abm_tpu_torch.models.gnn_embed.model.GATODE`.

The tree is nested dicts of numpy arrays, as a checkpoint of either
package holds it. flax ``Dense.kernel`` is (in, out); ``nn.Linear.weight``
is (out, in), so kernels are transposed on the way in and out. Names:

- ``zone_gat/Dense_0``, ``zone_gat/GATLayer_k/{Dense_0, a_src, a_dst}``,
  ``zone_gat/LayerNorm_k/{scale, bias}``;
- ``context_encoder/layers_0``, ``context_encoder/layers_2``;
- ``drift/Dense_0 .. Dense_{2*num_blocks+1}`` (block i is
  ``Dense_{1+2i}`` / ``Dense_{2+2i}``, the output layer is the last);
- ``query_proj``, ``init_proj``, ``decode_proj`` (``query_proj`` and
  ``decode_proj`` have no bias).
"""
from __future__ import annotations

import numpy as np
import torch


def _linears(model):
    """flax path -> nn.Linear, for every Dense of the model."""
    out = {
        ("zone_gat", "Dense_0"): model.zone_gat.inp,
        ("context_encoder", "layers_0"): model.context_encoder[0],
        ("context_encoder", "layers_2"): model.context_encoder[2],
        ("query_proj",): model.query_proj,
        ("init_proj",): model.init_proj,
        ("decode_proj",): model.decode_proj,
    }
    for k, layer in enumerate(model.zone_gat.layers):
        out[("zone_gat", f"GATLayer_{k}", "Dense_0")] = layer.proj
    for i, layer in enumerate(model.drift.dense):
        out[("drift", f"Dense_{i}")] = layer
    return out


def _vectors(model):
    """flax path -> 1-D / 2-D parameter that is stored untransposed."""
    out = {}
    for k, layer in enumerate(model.zone_gat.layers):
        out[("zone_gat", f"GATLayer_{k}", "a_src")] = layer.a_src
        out[("zone_gat", f"GATLayer_{k}", "a_dst")] = layer.a_dst
    for k, norm in enumerate(model.zone_gat.norms):
        out[("zone_gat", f"LayerNorm_{k}", "scale")] = norm.weight
        out[("zone_gat", f"LayerNorm_{k}", "bias")] = norm.bias
    return out


def flax_leaf_params(model) -> list:
    """Every parameter of ``model`` as ``(flax path, tensor)``, in the
    order JAX flattens the flax tree (keys sorted at every level). The
    tensors are the module's own, in PyTorch's layout: a ``kernel`` path
    holds the (out, in) ``nn.Linear.weight``."""
    out = []
    for path, lin in _linears(model).items():
        out.append((path + ("kernel",), lin.weight))
        if lin.bias is not None:
            out.append((path + ("bias",), lin.bias))
    out += list(_vectors(model).items())
    return sorted(out, key=lambda item: item[0])


def _get(tree, path):
    node = tree
    for key in path:
        if key not in node:
            raise KeyError(f"flax tree has no {'/'.join(path)}")
        node = node[key]
    return node


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _copy(dst: torch.Tensor, src, path):
    src = torch.as_tensor(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: flax shape {tuple(src.shape)} "
                         f"does not fit the port's {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_flax_params(model, tree) -> None:
    """Fill ``model``'s parameters in place from a flax parameter tree.

    Raises ``KeyError`` for a missing entry, ``ValueError`` for a shape
    mismatch or for entries of the tree that the model has no place for.
    """
    used = set()
    for path, lin in _linears(model).items():
        _copy(lin.weight, np.asarray(_get(tree, path + ("kernel",))).T,
              path + ("kernel",))
        used.add(path + ("kernel",))
        if lin.bias is not None:
            _copy(lin.bias, _get(tree, path + ("bias",)), path + ("bias",))
            used.add(path + ("bias",))
    for path, p in _vectors(model).items():
        _copy(p, _get(tree, path), path)
        used.add(path)
    extra = sorted("/".join(p) for p in set(_leaf_paths(tree)) - used)
    if extra:
        raise ValueError(f"flax tree entries with no place in the model: "
                         f"{extra}")


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def to_flax_params(model) -> dict:
    """The model's parameters as a flax tree of float32 numpy arrays."""
    host = lambda t: t.detach().to("cpu", torch.float32).numpy().copy()
    tree: dict = {}
    for path, lin in _linears(model).items():
        _put(tree, path + ("kernel",), host(lin.weight).T.copy())
        if lin.bias is not None:
            _put(tree, path + ("bias",), host(lin.bias))
    for path, p in _vectors(model).items():
        _put(tree, path, host(p))
    return tree
