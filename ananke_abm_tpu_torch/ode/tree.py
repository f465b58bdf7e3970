"""Arithmetic over trees of tensors (port of ``ananke_abm_tpu/ode/tree.py``).

A tree is a tensor, or a tuple or list of trees. The solvers keep
structured states this way, as the reference keeps pytrees; leaves are
visited depth first, in order.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(f, tree, *rest):
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, *subs) for subs in zip(tree, *rest))
    return f(tree, *rest)


def tree_axpy(s, x, y):
    """y + s * x, elementwise over the trees."""
    return tree_map(lambda xi, yi: yi + s * xi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_lincomb(coeffs, trees):
    """sum_i coeffs[i] * trees[i] for same-structure trees, summed in the
    reference's order."""
    out = tree_map(lambda x: coeffs[0] * x, trees[0])
    for c, t in zip(coeffs[1:], trees[1:]):
        out = tree_axpy(c, t, out)
    return out


def tree_where(pred: bool, a, b):
    """``a`` where ``pred`` holds, else ``b`` (``pred`` is a host bool: the
    controller decides on the host)."""
    return a if pred else b


def tree_error_norm(err, y0, y1, rtol, atol):
    """Hairer's scaled RMS error norm over every element of the tree:

        sqrt(mean_i (err_i / (atol + rtol * max(|y0_i|, |y1_i|)))^2)

    Zeros count in the mean. One norm for the whole batched state: one
    step controller for the batch. Returns a float32 0-d tensor.
    """
    total = None
    n = 0
    for e, a, b in zip(tree_leaves(err), tree_leaves(y0), tree_leaves(y1)):
        scale = atol + rtol * torch.maximum(a.abs(), b.abs())
        r = e / scale
        s = torch.sum(r * r)
        total = s if total is None else total + s
        n += r.numel()
    return torch.sqrt(total / n)


__all__ = ["tree_leaves", "tree_map", "tree_axpy", "tree_zeros_like",
           "tree_lincomb", "tree_where", "tree_error_norm"]
