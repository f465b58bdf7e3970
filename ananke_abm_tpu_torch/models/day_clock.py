"""The time-of-day features the trajectory ODE drifts read: ``[sin, cos]``
of ``t * 2 * pi / 24`` (``t`` in hours), in float32 in the reference's
order of operations."""
from __future__ import annotations

import math

import numpy as np
import torch


def day_clock(t, b: int, like: torch.Tensor) -> torch.Tensor:
    """(b, 2) ``[sin, cos]`` of hour ``t`` on ``like``'s device and dtype.
    ``t`` is a 0-d tensor (the fixed-step and adaptive solvers' stage
    times, computed on the device) or a Python float (the SDE solver's
    host-computed step times, turned into two fills, no host-to-device
    copy)."""
    if isinstance(t, torch.Tensor):
        ang = t * 2 * math.pi / 24.0
        return torch.stack([torch.sin(ang), torch.cos(ang)]).to(
            like.dtype).expand(b, 2)
    ang = (np.float32(t) * np.float32(2) * np.float32(np.pi)
           / np.float32(24.0))
    out = like.new_empty((b, 2))
    out[:, 0] = float(np.sin(ang))
    out[:, 1] = float(np.cos(ang))
    return out
