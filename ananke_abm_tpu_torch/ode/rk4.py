"""Fixed-step RK4 on tensors (port of ``ananke_abm_tpu/ode/rk4.py``).

The arithmetic follows the reference step for step — the same stage
times and the same order of the weighted sum — so float32 results agree
to rounding.

With ``checkpoint=True`` (the default) and autograd recording, each output
interval's substeps run under ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps each interval in ``jax.checkpoint``: the backward
keeps one state per interval and recomputes the interval's stages, so the
stored activations are those of one interval, not of the whole day. The
recomputation repeats the same operations on the same inputs, so the
gradients are those of ``checkpoint=False``; it costs one more forward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint as _remat


def rk4_step(rhs, t, dt, y, args):
    """One RK4 step of ``dy/dt = rhs(t, y, args)`` from ``t`` to ``t + dt``."""
    half = dt * 0.5
    k1 = rhs(t, y, args)
    k2 = rhs(t + half, y + half * k1, args)
    k3 = rhs(t + half, y + half * k2, args)
    k4 = rhs(t + dt, y + dt * k3, args)
    incr = (dt / 6.0) * k1
    incr = incr + (dt / 3.0) * k2
    incr = incr + (dt / 3.0) * k3
    incr = incr + (dt / 6.0) * k4
    return y + incr


def euler_step(rhs, t, dt, y, args):
    """One explicit Euler step."""
    return y + dt * rhs(t, y, args)


def _solve(step, rhs, y0, ts, args, substeps, checkpoint):
    """States at ``ts`` of ``substeps`` steps of ``step`` per interval, each
    interval rematerialised in the backward when ``checkpoint`` and autograd
    is recording."""
    remat = checkpoint and torch.is_grad_enabled()
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = (t1 - t0) / substeps

        def interval(y, t0=t0, dt=dt):
            for s in range(substeps):
                y = step(rhs, t0 + s * dt, dt, y, args)
            return y

        y = _remat(interval, y, use_reentrant=False) if remat else interval(y)
        ys.append(y)
    return torch.stack(ys, dim=0)


def rk4_solve(rhs, y0, ts, args=None, *, substeps: int = 1,
              checkpoint: bool = True):
    """Integrate ``dy/dt = rhs(t, y, args)`` with fixed-step RK4.

    ``ts``: (T,) strictly increasing float32 tensor of output times.
    Returns a (T,) + y0.shape tensor of states at ``ts`` (``ys[0] == y0``).
    ``checkpoint``: rematerialise each interval in the backward pass (the
    module docstring); it changes nothing under ``torch.no_grad()`` or
    ``torch.inference_mode()``.
    """
    return _solve(rk4_step, rhs, y0, ts, args, substeps, checkpoint)


def euler_solve(rhs, y0, ts, args=None, *, substeps: int = 1,
                checkpoint: bool = True):
    """Fixed-step explicit Euler, as :func:`rk4_solve` (a control for
    convergence tests)."""
    return _solve(euler_step, rhs, y0, ts, args, substeps, checkpoint)
