"""Euler–Maruyama for diagonal-noise Itô SDEs (port of
``ananke_abm_tpu/ode/sde.py``).

``dy = f(t, y) dt + g(t, y) dW``, ``y`` one tensor. Two modes, as the
reference's:

- per interval (``substeps``): ``substeps`` equal steps inside each output
  interval, so the discretisation and the noise path depend on the output
  grid;
- fixed grid (``dt`` and ``num_steps``): the uniform internal grid
  ``ts[0] + i * dt``, independent of the output grid; each output row is
  the state at the internal point nearest its time (``round((t - ts[0]) /
  dt)`` in float32, half to even), the state *before* that step advances.
  Duplicate snaps repeat the first hit's row.

Step times, step sizes and their square roots are computed on the host in
float32 in the reference's order (``t = ts[0] + i * dt``, ``dt_i =
clip(ts[-1] - t, 0, dt)``) and reach ``drift`` and ``diffusion`` as Python
floats. The reference's fixed-grid scan runs all ``num_steps + 1`` steps;
the steps after the last output's internal point write no row, so the loop
here stops at that point and its rows equal the reference's.

Noise: each step draws ``torch.randn(y.shape)`` from ``generator``. For
parity, ``noise`` (``(steps,) + y0.shape``, step ``i``'s standard normal
draw in row ``i``) replaces the draws: the reference's step ``i`` draws
``normal(split(fold_in(key, i), 1)[0])`` on the fixed grid and
``fold_in(key, interval * substeps + s)`` per interval.

``checkpoint`` (default True, as the reference's): with autograd
recording, each fixed-grid step or each output interval runs under
``torch.utils.checkpoint`` and is recomputed in the backward. It changes
memory, not results.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _remat

from ananke_abm_tpu_torch.utils.seed import draw


def _host_f32(ts) -> np.ndarray:
    if isinstance(ts, torch.Tensor):
        return ts.detach().cpu().numpy().astype(np.float32)
    return np.asarray(ts, dtype=np.float32)


def _draw(noise, i, y, generator):
    if noise is not None:
        return noise[i]
    return draw(torch.randn, y.shape, generator, y.device, y.dtype)


def euler_maruyama_solve(drift, diffusion, y0, ts, generator=None,
                         args=None, *, substeps: int = 1,
                         dt: float | None = None,
                         num_steps: int | None = None,
                         checkpoint: bool = True, noise=None):
    """Integrate ``dy = drift(t, y, args) dt + diffusion(t, y, args) dW``.

    ``ts``: (T,) increasing output times (a tensor or an array; read on
    the host). ``generator``: the ``torch.Generator`` the noise comes from
    (on ``y0``'s device), unless ``noise`` replaces it. ``dt`` with
    ``num_steps`` selects the fixed grid; ``num_steps * dt`` must cover
    ``ts[-1] - ts[0]`` (raises otherwise). Returns (T,) + y0.shape.
    """
    t_host = _host_f32(ts)
    if dt is not None:
        if num_steps is None:
            raise ValueError("fixed-grid mode needs a static num_steps")
        return _fixed_grid(drift, diffusion, y0, t_host, generator, args,
                           float(dt), int(num_steps), checkpoint, noise)
    if generator is None and noise is None:
        raise ValueError("euler_maruyama_solve needs a generator or noise")
    remat = checkpoint and torch.is_grad_enabled()
    ys, y = [y0], y0
    for k in range(t_host.shape[0] - 1):
        t0, t1 = t_host[k], t_host[k + 1]
        h = np.float32((t1 - t0) / np.float32(substeps))
        sqrt_h = float(np.sqrt(np.abs(h)))
        times = [float(t0 + np.float32(s) * h) for s in range(substeps)]
        ws = [_draw(noise, k * substeps + s, y, generator)
              for s in range(substeps)]

        def interval(y, *ws, times=times, h=float(h), sqrt_h=sqrt_h):
            for t, w in zip(times, ws):
                f = drift(t, y, args)
                g = diffusion(t, y, args)
                y = y + h * f
                y = y + g * w * sqrt_h
            return y

        y = (_remat(interval, y, *ws, use_reentrant=False) if remat
             else interval(y, *ws))
        ys.append(y)
    return torch.stack(ys, dim=0)


def _fixed_grid(drift, diffusion, y0, t_host, generator, args, dt,
                num_steps, checkpoint, noise):
    T = t_host.shape[0]
    t_start, t_end = t_host[0], t_host[-1]
    span = float(t_end - t_start)
    if num_steps * dt < span - 1e-9:
        raise ValueError(
            f"fixed-grid SDE: num_steps * dt = {num_steps * dt:g} does not "
            f"cover ts span {span:g}; raise num_steps (or the caller's "
            f"sde_span_hours)")
    if generator is None and noise is None:
        raise ValueError("euler_maruyama_solve needs a generator or noise")
    dt32 = np.float32(dt)
    raw_idx = np.round((t_host - t_start) / dt32).astype(np.int64)
    out_of_span = raw_idx > num_steps
    idx = np.clip(raw_idx, 0, num_steps)
    wanted = sorted(set(idx.tolist()))
    row_of = {i: r for r, i in enumerate(wanted)}
    last = wanted[-1]
    remat = checkpoint and torch.is_grad_enabled()

    def step(y, w, t, h, sqrt_h):
        f = drift(t, y, args)
        g = diffusion(t, y, args)
        return y + h * f + g * w * sqrt_h

    # without autograd the rows go straight into one buffer (half the peak
    # memory of stacking a list of them)
    buf = None if torch.is_grad_enabled() else y0.new_empty(
        (len(wanted),) + tuple(y0.shape))
    rows, y = [], y0
    for i in range(last + 1):
        if i in row_of:
            if buf is None:
                rows.append(y)
            else:
                buf[row_of[i]].copy_(y)
        if i == last:
            break
        t = np.float32(t_start + np.float32(i) * dt32)
        h = np.float32(np.clip(np.float32(t_end - t), np.float32(0.0), dt32))
        args_i = (float(t), float(h), float(np.sqrt(h)))
        w = _draw(noise, i, y, generator)
        y = (_remat(step, y, w, *args_i, use_reentrant=False) if remat
             else step(y, w, *args_i))
    out = torch.stack(rows, dim=0) if buf is None else buf
    pick = [row_of[i] for i in idx.tolist()]
    if pick != list(range(len(wanted))):
        out = out[torch.as_tensor(pick, device=out.device)]
    if out_of_span.any() and out.is_floating_point():
        mask = torch.as_tensor(out_of_span, device=out.device)
        out = torch.where(mask.view((T,) + (1,) * (out.dim() - 1)),
                          torch.full_like(out, float("nan")), out)
    return out


__all__ = ["euler_maruyama_solve"]
