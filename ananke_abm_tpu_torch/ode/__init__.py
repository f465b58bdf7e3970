"""Integrators (port of ``ananke_abm_tpu/ode``).

- :func:`odeint`: one entry over methods and gradient modes;
- :func:`rk4_solve`, :func:`euler_solve`: fixed step;
- :func:`dopri5_solve`: adaptive, dense output, forward only;
- :func:`odeint_adjoint`: adaptive with continuous-adjoint gradients;
- :func:`odeint_discrete_adjoint`: adaptive with discrete-adjoint gradients
  (the reference's ``odeint`` has no discrete mode either).

Not ported yet: ``euler_maruyama_solve`` (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import torch

from ananke_abm_tpu_torch.ode.adjoint import odeint_adjoint
from ananke_abm_tpu_torch.ode.discrete_adjoint import odeint_discrete_adjoint
from ananke_abm_tpu_torch.ode.dopri5 import dopri5_solve
from ananke_abm_tpu_torch.ode.rk4 import euler_solve, rk4_solve


def odeint(rhs, y0, ts, args=None, *, method: str = "dopri5",
           rtol: float = 1e-5, atol: float = 1e-5, substeps: int = 1,
           max_steps: int = 16384, adjoint: bool = True,
           return_stats: bool = False, checkpoint: bool = True):
    """Unified ODE solve.

    ``method="rk4"``/``"euler"``: fixed step, ``substeps`` per output
    interval. ``method="dopri5"``: adaptive; ``adjoint=True`` gives
    continuous-adjoint gradients (``y0`` one tensor), ``adjoint=False`` is
    forward only. ``return_stats=True`` returns ``(ys, stats)`` with
    ``n_steps``, ``n_accepted`` and ``ok``; the adjoint mode reports no
    step counts and takes ``ok`` from the last row being finite (a
    ``max_steps`` exhaustion NaN-poisons the unfilled rows).
    """

    def fixed_stats():
        n = (len(ts) - 1) * substeps
        return {"n_steps": n, "n_accepted": n, "ok": True}

    if method in ("rk4", "euler"):
        solve = rk4_solve if method == "rk4" else euler_solve
        ys = solve(rhs, y0, ts, args, substeps=substeps,
                   checkpoint=checkpoint)
        return (ys, fixed_stats()) if return_stats else ys
    if method == "dopri5":
        if adjoint:
            ys = odeint_adjoint(rhs, y0, ts, args, rtol=rtol, atol=atol,
                                max_steps=max_steps)
            if not return_stats:
                return ys
            ok = bool(torch.isfinite(ys[-1]).all())
            return ys, {"n_steps": None, "n_accepted": None, "ok": ok}
        ys, stats = dopri5_solve(rhs, y0, ts, args, rtol=rtol, atol=atol,
                                 max_steps=max_steps)
        return (ys, stats) if return_stats else ys
    raise ValueError(f"Unknown ODE method: {method!r}")


__all__ = ["odeint", "odeint_adjoint", "odeint_discrete_adjoint",
           "dopri5_solve", "rk4_solve", "euler_solve"]
