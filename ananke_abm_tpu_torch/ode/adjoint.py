"""Continuous-adjoint gradients for the adaptive DOPRI5 solver (port of
``ananke_abm_tpu/ode/adjoint.py``).

:func:`odeint_adjoint` is a ``torch.autograd.Function``. Its forward runs
:func:`dopri5_solve` without a graph. Its backward integrates the
augmented system

    d/ds [y, a_y, a_args] = [-f, (df/dy)^T a_y, (df/dargs)^T a_y]

backwards over each output interval with ``t = t_anchor - s``,
re-anchoring ``y`` at the saved state of each output time and adding that
time's output cotangent to ``a_y``. Each interval's solve starts cold
(HINIT). Output-time gradients are not propagated.

The augmented state is the tree ``(y, a_y, a_args)`` with every leaf of
``args`` flattened into the one vector ``a_args``: the controller's error
norm counts every element of every leaf, zeros included, so the leaves
that ``rhs`` never reads still set the norm's ``n``. A caller must pass the
same ``args`` as the reference (for the GAT-ODE trainer: every model
parameter, ``h`` and the zone embeddings) to get its step sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.ode.dopri5 import F, _host_times, dopri5_solve
from ananke_abm_tpu_torch.ode.tree import (
    tree_leaves,
    tree_map,
    tree_zeros_like,
)


def _flat(tensors, like):
    """Concatenate ``tensors`` (None -> zeros shaped as ``like``) into one
    float32 vector."""
    return torch.cat([
        (torch.zeros_like(l) if t is None else t).reshape(-1)
        for t, l in zip(tensors, like)
    ]) if like else torch.zeros(0)


class _OdeintAdjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rhs, rhs_vjp, rtol, atol, max_steps, args, stats, y0,
                ts, *leaves):
        ys, st = dopri5_solve(rhs, y0, ts, args, rtol=rtol, atol=atol,
                              max_steps=max_steps)
        if stats is not None:
            stats["forward"] = st
            stats["backward"] = []
        ctx.cfg = (rhs, rhs_vjp, rtol, atol, max_steps, args, stats)
        ctx.ts = _host_times(ts)
        ctx.save_for_backward(ys, *leaves)
        return ys

    @staticmethod
    def backward(ctx, g):
        rhs, rhs_vjp, rtol, atol, max_steps, args, stats = ctx.cfg
        ys, *leaves = ctx.saved_tensors
        ts = ctx.ts

        def rebuild(new_leaves):
            it = iter(new_leaves)
            return tree_map(lambda _: next(it), args)

        def aug_rhs(s, aug, aug_args):
            y, a_y, _ = aug
            t_anchor = aug_args
            t = float(F(t_anchor - F(s)))  # backward time
            if rhs_vjp is None:
                with torch.enable_grad():
                    yy = y.detach().requires_grad_(True)
                    aa = [l.detach().requires_grad_(True) for l in leaves]
                    f = rhs(t, yy, rebuild(aa))
                    grads = torch.autograd.grad(f, [yy, *aa], a_y,
                                                allow_unused=True)
                f = f.detach()
                v_y = (torch.zeros_like(y) if grads[0] is None
                       else grads[0])
                v_args = _flat(grads[1:], leaves)
            else:
                f, v_y, v_tree = rhs_vjp(t, y, rebuild(leaves), a_y)
                v_args = _flat(tree_leaves(v_tree), leaves)
            return (-f, v_y, v_args)

        a_y = tree_zeros_like(g[0])
        a_args = _flat([None] * len(leaves), leaves).to(g.device)
        for i in range(ts.shape[0] - 1, 0, -1):
            a_y = a_y + g[i]
            t_i = F(ts[i])
            delta = F(t_i - F(ts[i - 1]))
            aug_ys, st = dopri5_solve(
                aug_rhs, (ys[i], a_y, a_args),
                np.asarray([0.0, delta], np.float32), t_i,
                rtol=rtol, atol=atol, max_steps=max_steps,
            )
            if stats is not None:
                stats["backward"].append(st)
            _, a_y, a_args = (leaf[-1] for leaf in aug_ys)
        grad_y0 = a_y + g[0]
        grads, off = [], 0
        for leaf in leaves:
            grads.append(a_args[off: off + leaf.numel()].view_as(leaf))
            off += leaf.numel()
        return (None,) * 7 + (grad_y0, None, *grads)


def odeint_adjoint(rhs, y0, ts, args=None, *, rtol: float = 1e-5,
                   atol: float = 1e-5, max_steps: int = 16384,
                   rhs_vjp=None, stats: dict | None = None):
    """Adaptive DOPRI5 solve with continuous-adjoint gradients.

    ``y0`` is one tensor; ``args`` a tree of tensors (or None). Returns
    ``ys`` of shape ``(T,) + y0.shape``, as :func:`dopri5_solve` without
    stats. Gradients flow to ``y0`` and to every leaf of ``args``;
    output-time gradients are zero.

    ``rhs_vjp(t, y, args, a_y) -> (f, v_y, v_args)``: an optional joint
    evaluator used by the backward instead of ``torch.autograd.grad`` of
    ``rhs``; ``v_args`` must have the structure of ``args``.

    ``stats``: a dict to fill with the forward solve's stats
    (``stats["forward"]``) and, once the backward has run, one stats dict
    per backward interval, last interval first (``stats["backward"]``).
    """
    args = () if args is None else args
    return _OdeintAdjoint.apply(rhs, rhs_vjp, rtol, atol, max_steps, args,
                                stats, y0, ts, *tree_leaves(args))


__all__ = ["odeint_adjoint"]
