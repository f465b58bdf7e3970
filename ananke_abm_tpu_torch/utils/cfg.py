"""Small filesystem helpers (the port's copy of ``ananke_abm_tpu.utils.cfg``'s
``ensure_dir``)."""
from __future__ import annotations

import os


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
