"""Jensen–Shannon divergence in nats, numpy float64 (a copy of
``ananke_abm_tpu/losses/jsd.py``)."""
from __future__ import annotations

import numpy as np


def jsd(p, q, eps: float = 1e-12) -> float:
    p = np.clip(np.asarray(p, dtype=np.float64), eps, None)
    q = np.clip(np.asarray(q, dtype=np.float64), eps, None)
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        return float(np.sum(a * np.log(a / b)))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)
