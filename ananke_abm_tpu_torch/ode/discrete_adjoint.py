"""Discrete-adjoint gradients for the adaptive DOPRI5 solver (port of
``ananke_abm_tpu/ode/discrete_adjoint.py``).

The forward records each accepted step's ``(t0, h)`` and a checkpoint of
the state every ``ckpt_every`` accepted steps; the backward replays those
steps in reverse, one step VJP per accepted step. The gradient is the
exact derivative of the computed output (backprop through the solver's
step sequence); accept/reject decisions and step-size proposals are not
differentiated, as in the continuous adjoint.

Memory: ``ceil(max_accepted / ckpt_every)`` checkpointed states plus one
``ckpt_every``-step window of replayed states. A segment replays only the
steps whose outputs it needs: ``min(ckpt_every, accepted steps left) - 1``
steps, none at ``ckpt_every=1``.

Hooks, the split of ``dopri5_solve``:

- ``step_impl(t0, h, y, f, args) -> (y1, f1, err, interp)``: one step, for
  the forward solve and the backward's replays (the replay must give the
  forward's bits for the VJP to be exact);
- ``step_vjp(t0, h, y, f, args, gset) -> (gy, gf, gargs)`` with ``gset =
  (g_dy, g_r5, g_k1x, g_k7x, g_y0_direct)``: one step's VJP. The generic
  one differentiates the tableau step with ``torch.autograd.grad``;
- ``step_vjp.backward_all(ckpts, ckpt_f, rec_t0, rec_h, n_acc, g,
  out_step, ts, args) -> (gy, gf, gargs)``, where a ``step_vjp`` has it:
  the whole backward at once (every step's VJP in reverse, the
  dense-output fold and the carries), taken in place of the per-step loop
  at ``ckpt_every=1`` with ``store_f`` recording and a single-tensor
  state; ``gy`` and ``gf`` are the carries after step 0. Its replays and
  VJPs are not counted in ``stats``.

Cotangent folding: with ``dy = h sum_j b5_j k_j`` the step's outputs are
``y1 = y0 + dy``, ``f1 = k7`` and the CONTD5 coefficients ``r1 = y0``,
``r2 = dy``, ``r3 = h k1 - dy``, ``r4 = 2 dy - h k1 - h k7`` and ``r5 = h
sum_j d_j k_j``. Incoming ``(g_y1, g_f1, g_r1..g_r5)`` fold to

    g_dy        = g_y1 + g_r2 - g_r3 + 2 g_r4
    g_k1x       = h (g_r3 - g_r4)        # k1 = f0 is a step input
    g_k7x       = g_f1 - h g_r4
    g_y0_direct = g_y1 + g_r1

and each stage's cotangent is ``gk_j = h (b5_j g_dy + d_j g_r5)``, plus the
extras on k1 and k7, plus the reverse tableau chain.
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.ode.dopri5 import F, _host_times, _step, dopri5_solve
from ananke_abm_tpu_torch.ode.tree import tree_leaves, tree_map


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _generic_step_vjp(step):
    """``step_vjp`` through ``torch.autograd.grad`` of ``step`` (the
    tableau step over ``rhs``), for any reverse-differentiable step."""

    def step_vjp(t0, h, y, f, args, gset):
        g_dy, g_r5, g_k1x, g_k7x, g_y0_direct = gset
        leaves = tree_leaves(args)
        with torch.enable_grad():
            yy = y.detach().requires_grad_(True)
            ff = f.detach().requires_grad_(True)
            aa = [l.detach().requires_grad_(True) for l in leaves]
            y1, f1, _err, interp = step(t0, h, yy, ff, _rebuild(args, aa))
            # dy = y1 - y routes -g_dy into y; g_y0_direct carries y1's
            # +g_y1 and r1's +g_r1
            grads = torch.autograd.grad(
                [y1 - yy, interp.r5, f1], [yy, ff, *aa],
                [g_dy, g_r5, g_k7x], allow_unused=True)
        zero = lambda g, like: torch.zeros_like(like) if g is None else g
        gy = zero(grads[0], y) + g_y0_direct
        gf = zero(grads[1], f) + g_k1x
        return gy, gf, _rebuild(args, [zero(g, l)
                                       for g, l in zip(grads[2:], leaves)])

    return step_vjp


def _dense_weights(out_step, ts, idx, t0, h):
    """(5, T) float32 weights of the rows step ``idx`` filled: row t gets
    ``(1, th, th om, th^2 om, th^2 om^2)`` with ``th`` its position in the
    step (the CONTD5 basis), 0 elsewhere. None when it filled no row."""
    mask = out_step == idx
    if not mask.any():
        return None
    safe_h = F(1.0) if F(h) == 0 else F(h)
    th = np.clip((ts - F(t0)) / safe_h, F(0.0), F(1.0)).astype(np.float32)
    om = (F(1.0) - th).astype(np.float32)
    w = np.stack([np.ones_like(th), th, th * om, th * th * om,
                  th * th * om * om]).astype(np.float32)
    return w * mask[None, :].astype(np.float32)


class _OdeintDiscrete(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rhs, step_impl, step_vjp, cfg, args, stats, y0, ts,
                *leaves):
        (rtol, atol, max_steps, max_accepted, ckpt_every, store_f,
         ckpt_dtype, group) = cfg
        # the value-only call records too, so the max_accepted cap poisons
        # the same rows whether or not a gradient is asked for
        ys, st = dopri5_solve(
            rhs, y0, ts, args, rtol=rtol, atol=atol, max_steps=max_steps,
            step_impl=step_impl, group=group,
            record={"max_accepted": max_accepted, "ckpt_every": ckpt_every,
                    "store_f": store_f, "ckpt_dtype": ckpt_dtype})
        if stats is not None:
            stats["forward"] = {k: st[k] for k in
                                ("n_steps", "n_accepted", "ok", "h_next")}
            stats["replays"] = stats["vjps"] = 0
        ctx.hooks = (rhs, step_impl, step_vjp, ckpt_every, args, stats)
        ctx.rec = (_host_times(ts), st["rec_t0"], st["rec_h"],
                   st["out_step"], st["n_accepted"])
        ctx.save_for_backward(st["ckpts"], st.get("ckpt_f"), *leaves)
        return ys

    @staticmethod
    def backward(ctx, g):
        rhs, step_impl, step_vjp, K, args, stats = ctx.hooks
        ts, rec_t0, rec_h, out_step, n_acc = ctx.rec
        ckpts, ckpt_f, *leaves = ctx.saved_tensors
        args = _rebuild(args, leaves)
        step = step_impl or (lambda t0, h, y, f, a: _step(rhs, t0, h, y, f,
                                                          a))
        vjp = step_vjp or _generic_step_vjp(step)
        g_y = torch.zeros_like(g[0])
        g_f = torch.zeros_like(g[0])
        g_args = [torch.zeros_like(l) for l in leaves]
        zero_row = torch.zeros_like(g[0])
        # the whole backward in one hook call (a kernel that carries the
        # cotangents on chip): every step checkpointed with its FSAL eval,
        # and a single-tensor state
        backward_all = getattr(vjp, "backward_all", None)
        whole = (backward_all is not None and K == 1 and ckpt_f is not None
                 and torch.is_tensor(ckpts) and torch.is_tensor(ckpt_f))
        if whole:
            if stats is not None and stats.get("keep_backward_all"):
                # the operands the hook is given, the weights copied (an
                # optimizer may update them in place after the backward)
                stats["backward_all"] = (
                    ckpts, ckpt_f, rec_t0, rec_h, n_acc, g, out_step, ts,
                    _rebuild(args, [l.detach().clone() for l in leaves]))
            g_y, g_f, gargs = backward_all(ckpts, ckpt_f, rec_t0, rec_h,
                                           n_acc, g, out_step, ts, args)
            g_args = tree_leaves(gargs)
        else:
            for s in range(-(-n_acc // K) - 1, -1, -1):
                # checkpoints may be stored narrowed: widen to the cotangent's
                # type for the replay and the VJP
                y = ckpts[s].to(g.dtype)
                if ckpt_f is not None:
                    f = ckpt_f[s].to(g.dtype)
                else:
                    f = rhs(float(rec_t0[s * K]), y, args)
                seg = [(y, f)]
                # replay the segment's steps whose outputs the VJPs read
                for idx in range(s * K, min(s * K + K, n_acc) - 1):
                    y, f, _err, _interp = step(float(rec_t0[idx]),
                                               float(rec_h[idx]), y, f, args)
                    seg.append((y, f))
                    if stats is not None:
                        stats["replays"] += 1
                for j in range(len(seg) - 1, -1, -1):
                    idx = s * K + j
                    t0j, hj = rec_t0[idx], rec_h[idx]
                    w = _dense_weights(out_step, ts, idx, t0j, hj)
                    if w is None:
                        gset = (g_y, zero_row, zero_row, g_f, g_y)
                    else:
                        gr1, gr2, gr3, gr4, gr5 = torch.tensordot(
                            torch.from_numpy(w).to(g.device), g, dims=1)
                        hf = float(F(hj))
                        gset = (g_y + gr2 - gr3 + 2.0 * gr4, gr5,
                                hf * (gr3 - gr4), g_f - hf * gr4, g_y + gr1)
                    y_j, f_j = seg[j]
                    g_y, g_f, gargs_j = vjp(float(t0j), float(hj), y_j, f_j,
                                            args, gset)
                    g_args = [a + b for a, b in zip(g_args,
                                                    tree_leaves(gargs_j))]
                    if stats is not None:
                        stats["vjps"] += 1
        # row 0 of ys is y0 itself; the rows never filled (max_accepted or
        # max_steps ran out) match no accepted step: route their cotangents
        # into y0 so that a loss that touched a NaN row gets a NaN
        # gradient, never a quietly finite one
        T = g.shape[0]
        tail = [t for t in range(1, T) if out_step[t] == -1]
        g_y0 = g_y + g[0]
        if tail:
            g_y0 = g_y0 + g[tail].sum(dim=0)
        # the solve's initial FSAL eval f0 = rhs(ts[0], y0, args)
        with torch.enable_grad():
            yy = ckpts[0].to(g.dtype).detach().requires_grad_(True)
            aa = [l.detach().requires_grad_(True) for l in leaves]
            f0 = rhs(float(F(ts[0])), yy, _rebuild(args, aa))
            grads = torch.autograd.grad(f0, [yy, *aa], g_f,
                                        allow_unused=True)
        g_y0 = g_y0 + grads[0]
        g_args = [a if b is None else a + b
                  for a, b in zip(g_args, grads[1:])]
        # output-time gradients are not propagated
        return (None,) * 6 + (g_y0, None, *g_args)


def odeint_discrete_adjoint(rhs, y0, ts, args=None, *, rtol: float = 1e-5,
                            atol: float = 1e-5, max_steps: int = 16384,
                            max_accepted: int = 512, ckpt_every: int = 16,
                            store_f=False, ckpt_dtype=None, step_impl=None,
                            step_vjp=None, stats: dict | None = None,
                            group=None):
    """Adaptive DOPRI5 solve with discrete-adjoint gradients.

    ``y0`` is one tensor; ``args`` a tree of tensors (or None). Returns
    ``ys`` (T,) + y0.shape as :func:`dopri5_solve` does; gradients flow to
    ``y0`` and every leaf of ``args``; output-time gradients are zero.

    ``max_accepted`` caps the recorded accepted steps: a solve that would
    take more stops and NaN-poisons the rows left (size it about twice the
    expected count). ``ckpt_every`` trades checkpoint memory against the
    replay window. ``store_f`` (False | True | "bf16") records each
    checkpoint's FSAL eval so the backward skips one ``rhs`` evaluation per
    segment; ``ckpt_dtype`` (None | "bf16") narrows the state checkpoints.

    ``step_impl`` and ``step_vjp`` come together (e.g. from
    ``ops.cuda.fused_dopri5.make_fused_dopri5_hooks``): the generic VJP
    differentiates the step itself, which a kernel step cannot be. A
    reverse-differentiable custom ``step_impl`` opts into the generic VJP
    with ``step_vjp="generic"``; a custom ``step_vjp`` pairs with the
    tableau step through ``step_impl="tableau"``.

    ``group``: the ranks that hold the batch's other rows; the forward
    solve's controller reads the error norms of the whole batch (see
    ``dopri5_solve``), so every rank records one step sequence.

    ``stats``: a dict to fill with the forward solve's ``n_steps``,
    ``n_accepted``, ``ok`` and ``h_next`` (``stats["forward"]``) and, once
    the backward has run, its step replays (``stats["replays"]``) and step
    VJPs (``stats["vjps"]``, one per accepted step). With
    ``stats["keep_backward_all"]`` true, a backward that takes
    ``step_vjp.backward_all`` leaves the arguments it passed there in
    ``stats["backward_all"]``, ``args`` as copies: the whole backward can
    then be run again on the same operands.
    """
    if (step_impl is None) != (step_vjp is None):
        raise ValueError(
            "step_impl and step_vjp must be provided together (see "
            "ops.cuda.fused_dopri5.make_fused_dopri5_hooks): the generic "
            "VJP differentiates the step function itself, which a kernel "
            "step cannot be. Pass step_vjp='generic' to differentiate a "
            "custom reverse-differentiable step_impl, or "
            "step_impl='tableau' to pair a custom step_vjp with the tableau "
            "step.")
    if isinstance(step_vjp, str):
        if step_vjp != "generic":
            raise ValueError(f"unknown step_vjp sentinel {step_vjp!r}")
        step_vjp = None
    if isinstance(step_impl, str):
        if step_impl != "tableau":
            raise ValueError(f"unknown step_impl sentinel {step_impl!r}")
        step_impl = None
    args = () if args is None else args
    cfg = (rtol, atol, max_steps, int(max_accepted), int(ckpt_every),
           store_f, ckpt_dtype, group)
    return _OdeintDiscrete.apply(rhs, step_impl, step_vjp, cfg, args, stats,
                                 y0, ts, *tree_leaves(args))


__all__ = ["odeint_discrete_adjoint"]
