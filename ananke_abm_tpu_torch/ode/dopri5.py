"""Adaptive Dormand-Prince 5(4) with dense output (port of
``ananke_abm_tpu/ode/dopri5.py``).

The state is a tree of tensors (``ode/tree.py``). The step controller runs
on the host: ``t``, ``h``, the step factor and the error norm are float32
scalars, computed in float32 as the reference computes its ``ts.dtype``
scalars, so the two packages take the same step sequence. Reading the
error norm is one device-to-host sync per attempted step (plus three for
the initial step size); nothing else in the loop waits for the device.

For the discrete adjoint (``ode/discrete_adjoint.py``) a ``step_impl`` may
replace the tableau step (the fused step kernel, K5), may return an
:class:`ErrNormSq` in place of the error vector, and ``record=`` keeps the
accepted-step sequence and the state checkpoints the backward replays.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ananke_abm_tpu_torch.ode.tree import (
    tree_axpy,
    tree_error_norm,
    tree_leaves,
    tree_lincomb,
    tree_map,
    tree_where,
)

F = np.float32

# Dormand-Prince 5(4) tableau.
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
# 5th-order solution weights (the last row of A: FSAL).
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
# Embedded 4th-order weights.
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)
# Dense-output coefficients (Hairer CONTD5).
_D = (
    -12715105075.0 / 11282082432.0,
    0.0,
    87487479700.0 / 32700410799.0,
    -10690763975.0 / 1880347072.0,
    701980252875.0 / 199316789632.0,
    -1453857185.0 / 822651844.0,
    69997945.0 / 29380423.0,
)

_SAFETY = F(0.9)
_MIN_FACTOR = F(0.2)
_MAX_FACTOR = F(10.0)
_ORDER_EXP = F(-0.2)  # err ** (-1/5)


def _mul(h, c) -> float:
    """f32(h) * f32(c) as a Python float (exact in float32), the product a
    float32 scalar times a weakly typed constant gives in the reference."""
    return float(F(h) * F(c))


class ErrNormSq(NamedTuple):
    """A pre-reduced error norm from a fused step: ``sq_sum`` a float32
    tensor (one element) holding ``sum((err / scale)^2)`` with Hairer's
    scale ``atol + rtol * max(|y0|, |y1|)`` already applied, ``count`` the
    number of elements. The controller then reads that one scalar instead
    of forming :func:`tree_error_norm` over the state."""

    sq_sum: torch.Tensor
    count: int


class _Interp(NamedTuple):
    """Continuous extension over one accepted step [t0, t0 + h], kept
    lazily: the CONTD5 coefficients r2..r4 are formed from the endpoints
    only when an output row is filled; ``r5`` needs the stage evals and is
    formed by the step."""

    t0: np.float32
    h: np.float32
    y0: object
    f0: object
    y1: object
    f1: object
    r5: object


def _dense_eval(interp: _Interp, t):
    h = F(interp.h)
    safe_h = F(1.0) if h == 0 else h
    theta = F(np.clip(F(F(t) - F(interp.t0)) / safe_h, F(0.0), F(1.0)))
    om = F(F(1.0) - theta)
    h, theta, om = float(h), float(theta), float(om)

    def leaf(y0, f0, y1, f1, r5):
        r2 = y1 - y0
        r3 = h * f0 - r2
        r4 = r2 - h * f1 - r3
        return y0 + theta * (r2 + om * (r3 + theta * (r4 + om * r5)))

    return tree_map(leaf, interp.y0, interp.f0, interp.y1, interp.f1,
                    interp.r5)


def _step(rhs, t0, h, y0, f0, args):
    """One DOPRI5 step. Returns (y1, f1 (FSAL), err, interp)."""
    ks = [f0]
    for i in range(1, 7):
        row = _A[i]
        y_stage = tree_axpy(_mul(h, row[0]), ks[0], y0)
        for j in range(1, len(row)):
            if row[j] != 0.0:
                y_stage = tree_axpy(_mul(h, row[j]), ks[j], y_stage)
        ks.append(rhs(float(F(t0) + F(_mul(h, _C[i]))), y_stage, args))

    incr5 = tree_lincomb([_mul(h, b) for b in _B5[:6]], ks[:6])
    y1 = tree_map(torch.add, y0, incr5)
    f1 = ks[6]
    err = tree_lincomb([_mul(h, b5 - b4) for b5, b4 in zip(_B5, _B4)], ks)
    d_nz = [(c, k) for c, k in zip(_D, ks) if c != 0.0]
    r5 = tree_lincomb([_mul(h, c) for c, _ in d_nz], [k for _, k in d_nz])
    return y1, f1, err, _Interp(F(t0), F(h), y0, ks[0], y1, f1, r5)


def _norm(tree, scale) -> torch.Tensor:
    sq = None
    n = 0
    for leaf, s in zip(tree_leaves(tree), tree_leaves(scale)):
        v = torch.sum((leaf / s) ** 2)
        sq = v if sq is None else sq + v
        n += leaf.numel()
    return torch.sqrt(sq / n)


def _initial_step(rhs, t0, y0, f0, args, rtol, atol):
    """Hairer's automatic initial step size (HINIT): one probe eval of
    ``rhs``; the exponent is 1/(p+1) = 1/6 for the DOPRI5 pair."""
    scale = tree_map(lambda y: atol + rtol * y.abs(), y0)
    d0, d1 = (F(v) for v in torch.stack(
        [_norm(y0, scale), _norm(f0, scale)]).tolist())
    h0 = F(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else F(F(F(0.01) * d0) / d1)
    y1 = tree_axpy(float(h0), f0, y0)
    f1 = rhs(float(F(t0) + h0), y1, args)
    d2 = F(F(_norm(tree_map(torch.sub, f1, f0), scale).item()) / h0)
    dm = max(d1, d2)
    if dm <= 1e-15:
        h1 = max(F(1e-6), F(h0 * F(1e-3)))
    else:
        h1 = F(F(F(0.01) / dm) ** F(1.0 / 6.0))
    return min(F(F(100.0) * h0), h1)


def _host_times(ts) -> np.ndarray:
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    return np.asarray(ts, dtype=np.float32)


_RECORD_DTYPES = {None: None, False: None, True: None,
                  "bf16": torch.bfloat16}


def _record_buffers(record, y0, f0, num_out):
    """The discrete adjoint's recording: host ``rec_t0`` / ``rec_h``
    (max_accepted,) float32 and ``out_step`` (T,) int, device ``ckpts``
    (and ``ckpt_f`` under ``store_f``) of ``ceil(max_accepted /
    ckpt_every)`` states, narrowed to bf16 where asked."""
    max_acc = int(record["max_accepted"])
    every = int(record["ckpt_every"])
    store_f = record.get("store_f", False)
    ckpt_dtype = record.get("ckpt_dtype")
    # a typo'd value would otherwise pick another memory or precision
    if store_f not in (False, True, "bf16"):
        raise ValueError(
            f"store_f must be False, True, or 'bf16'; got {store_f!r}")
    if ckpt_dtype not in (None, "bf16"):
        raise ValueError(
            f"ckpt_dtype must be None or 'bf16'; got {ckpt_dtype!r}")
    if max_acc < 1 or every < 1:
        raise ValueError("max_accepted and ckpt_every must be >= 1")
    n_ckpt = -(-max_acc // every)

    def buf(like, dtype):
        return tree_map(lambda l: torch.zeros(
            (n_ckpt,) + tuple(l.shape), dtype=dtype or l.dtype,
            device=l.device), like)

    rec = {"rec_t0": np.zeros((max_acc,), np.float32),
           "rec_h": np.zeros((max_acc,), np.float32),
           "out_step": np.full((num_out,), -1, np.int64),
           "ckpts": buf(y0, _RECORD_DTYPES[ckpt_dtype])}
    if store_f:
        rec["ckpt_f"] = buf(f0, _RECORD_DTYPES[store_f])
    return rec, max_acc, every


def dopri5_solve(rhs, y0, ts, args=None, *, rtol: float = 1e-5,
                 atol: float = 1e-5, max_steps: int = 16384,
                 first_step=None, step_impl=None, record=None):
    """Integrate ``dy/dt = rhs(t, y, args)`` with adaptive DOPRI5 and
    return dense output at ``ts``.

    ``rhs(t, y, args)``: ``t`` a Python float (a float32 value), ``y`` a
    tree of tensors. ``ts``: (T,) increasing output times, a tensor or an
    array, read as float32. ``first_step``: an initial step size, or None
    for HINIT. ``max_steps`` caps the attempted steps; when it runs out,
    the output rows not yet filled are NaN and ``ok`` is False.

    ``step_impl(t0, h, y, f, args) -> (y1, f1, err, interp)`` replaces the
    tableau step (``f`` the FSAL eval at ``(t0, y)``, ``interp`` an
    ``_Interp``; ``err`` the error vector or an :class:`ErrNormSq`); the
    controller stays this one. ``rhs`` still makes the initial eval and
    HINIT's probe.

    ``record={"max_accepted": m, "ckpt_every": k[, "store_f": False | True
    | "bf16"][, "ckpt_dtype": None | "bf16"]}`` records the accepted-step
    sequence for the discrete adjoint: stats gain ``rec_t0`` / ``rec_h``
    ((m,) float32 numpy: each accepted step's start and actual step size),
    ``out_step`` ((T,) int numpy: the accepted step whose interpolant filled
    each row; -1 for row 0 and unfilled rows) and ``ckpts`` (the pre-step
    state of every k-th accepted step, leaves ``(ceil(m / k),) +
    leaf.shape`` on the state's device, bf16 under ``ckpt_dtype="bf16"``);
    ``store_f`` adds ``ckpt_f``, the pre-step FSAL eval at the same steps.
    A solve that would take more than m accepted steps stops there: the
    unfilled rows are NaN and ``ok`` is False, as at ``max_steps``.

    Returns (ys, stats): ``ys`` with leaves of shape ``(T,) + leaf.shape``;
    ``stats`` with ``n_steps`` and ``n_accepted`` (ints), ``ok`` (bool) and
    ``h_next`` (the controller's next proposal, float32), and the record.
    """
    ts = _host_times(ts)
    num_out = ts.shape[0]
    t0, t_end = F(ts[0]), F(ts[-1])

    f0 = rhs(float(t0), y0, args)
    if first_step is None:
        h = _initial_step(rhs, t0, y0, f0, args, rtol, atol)
    else:
        h = F(first_step)
    h = min(h, F(t_end - t0))

    def buffer(leaf):
        buf = torch.zeros((num_out,) + tuple(leaf.shape), dtype=leaf.dtype,
                          device=leaf.device)
        buf[0] = leaf
        return buf

    ys = tree_map(buffer, y0)
    rec, max_acc = None, None
    if record is not None:
        rec, max_acc, every = _record_buffers(record, y0, f0, num_out)
    t, y, f = t0, y0, f0
    out_idx, n_steps, n_acc = 1, 0, 0
    while (out_idx < num_out and n_steps < max_steps
           and (rec is None or n_acc < max_acc)):
        h = min(h, F(t_end - t))
        if step_impl is None:
            y1, f1, err, interp = _step(rhs, t, h, y, f, args)
        else:
            y1, f1, err, interp = step_impl(t, h, y, f, args)
        if isinstance(err, ErrNormSq):
            # the step pre-reduced the scaled error: one scalar read
            err_norm = F(np.sqrt(F(F(err.sq_sum.item()) / F(err.count))))
        else:
            err_norm = F(tree_error_norm(err, y, y1, rtol, atol).item())
        # a NaN error is a rejection with the largest shrink
        bad = not np.isfinite(err_norm)
        if bad:
            err_norm = F(2.0)
        accept = bool(err_norm <= 1.0)
        factor = F(_SAFETY * F(max(err_norm, F(1e-10)) ** _ORDER_EXP))
        factor = F(np.clip(factor, _MIN_FACTOR, _MAX_FACTOR))
        if bad:
            factor = _MIN_FACTOR
        h_next = F(h * factor)
        t_new = F(t + h)
        if accept:
            # every output time inside this step
            eps = F(F(1e-7) * max(F(abs(t_new)), F(1.0)))
            while out_idx < num_out and ts[out_idx] <= F(t_new + eps):
                y_t = _dense_eval(interp, ts[out_idx])
                for buf, v in zip(tree_leaves(ys), tree_leaves(y_t)):
                    buf[out_idx] = v
                if rec is not None:
                    rec["out_step"][out_idx] = n_acc
                out_idx += 1
            if rec is not None:
                rec["rec_t0"][n_acc] = t
                rec["rec_h"][n_acc] = h
                if n_acc % every == 0:
                    bufs = [("ckpts", y)] + (
                        [("ckpt_f", f)] if "ckpt_f" in rec else [])
                    for key, val in bufs:
                        for buf, v in zip(tree_leaves(rec[key]),
                                          tree_leaves(val)):
                            buf[n_acc // every] = v
            t = t_new
        y = tree_where(accept, y1, y)
        f = tree_where(accept, f1, f)
        h = h_next
        n_steps += 1
        n_acc += int(accept)
    ok = out_idx >= num_out
    # rows never written hold zeros: poison them so a max_steps exhaustion
    # is loud (a NaN loss) instead of silently wrong
    if not ok:
        for buf in tree_leaves(ys):
            if torch.is_floating_point(buf):
                buf[out_idx:] = float("nan")
        if os.environ.get("ANANKE_DEBUG_ODE"):
            print(f"dopri5_solve: max_steps={max_steps} exhausted at t={t} "
                  f"({out_idx}/{num_out} outputs filled; unfilled rows "
                  "are NaN)")
    stats = {"n_steps": n_steps, "n_accepted": n_acc, "ok": ok,
             "h_next": h}
    if rec is not None:
        stats.update(rec)
    return ys, stats


__all__ = ["dopri5_solve", "ErrNormSq"]
