"""The purpose and mode id maps of the mock world (copied from
``ananke_abm_tpu/data_generator/features.py``, which the port does not
import)."""
from __future__ import annotations

MODE_NAMES = ("stay", "walk", "bike", "car", "public_transit")
PURPOSE_NAMES = ("home", "work", "education", "shopping", "social", "travel")

MODE_ID_MAP = {n: i for i, n in enumerate(MODE_NAMES)}
PURPOSE_ID_MAP = {n: i for i, n in enumerate(PURPOSE_NAMES)}
