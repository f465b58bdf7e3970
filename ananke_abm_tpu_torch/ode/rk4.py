"""Fixed-step RK4 on tensors (port of ``ananke_abm_tpu/ode/rk4.py``).

The arithmetic follows the reference step for step — the same stage
times and the same order of the weighted sum — so float32 results agree
to rounding.
"""
from __future__ import annotations

import torch


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


def rk4_solve(rhs, y0, ts, args=None, *, substeps: int = 1,
              checkpoint: bool = True):
    """Integrate ``dy/dt = rhs(t, y, args)`` with fixed-step RK4.

    ``ts``: (T,) strictly increasing float32 tensor of output times.
    Returns a (T,) + y0.shape tensor of states at ``ts`` (``ys[0] == y0``).

    ``checkpoint`` is accepted for signature parity with the reference
    and ignored: this port of the solver serves the inference-only path,
    which keeps no activations for a backward pass.
    """
    del checkpoint
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = (t1 - t0) / substeps
        for s in range(substeps):
            y = rk4_step(rhs, t0 + s * dt, dt, y, args)
        ys.append(y)
    return torch.stack(ys, dim=0)


def euler_solve(rhs, y0, ts, args=None, *, substeps: int = 1,
                checkpoint: bool = True):
    """Fixed-step explicit Euler, as :func:`rk4_solve` (a control for
    convergence tests); ``checkpoint`` is ignored likewise."""
    del checkpoint
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = (t1 - t0) / substeps
        for s in range(substeps):
            y = y + dt * rhs(t0 + s * dt, y, args)
        ys.append(y)
    return torch.stack(ys, dim=0)
