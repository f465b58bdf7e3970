"""Enriched continuous features for the discrete purpose and mode
attributes of the mock world (a copy of
``ananke_abm_tpu/data_generator/features.py``, which the port does not
import): 5 travel modes x [is_moving, avg_speed, cost_per_km, convenience]
and 6 purposes x [is_stationary, is_mandatory, typical_duration,
social_level], with id maps both ways. The first column of each table is
the physical flag the latent-ODE constraint potential reads (a state is
implausible when is_moving and is_stationary agree).
"""
from __future__ import annotations

import numpy as np

MODE_FEATURE_NAMES = ("is_moving", "avg_speed", "cost_per_km", "convenience")
MODE_NAMES = ("stay", "walk", "bike", "car", "public_transit")
MODE_TABLE = np.array(
    [
        [0.0, 0.00, 0.0, 1.0],  # stay
        [1.0, 0.10, 0.0, 0.8],  # walk
        [1.0, 0.25, 0.1, 0.7],  # bike
        [1.0, 0.70, 0.8, 0.9],  # car
        [1.0, 0.50, 0.4, 0.4],  # public_transit
    ],
    dtype=np.float32,
)

PURPOSE_FEATURE_NAMES = (
    "is_stationary", "is_mandatory", "typical_duration", "social_level",
)
PURPOSE_NAMES = ("home", "work", "education", "shopping", "social", "travel")
PURPOSE_TABLE = np.array(
    [
        [1.0, 1.0, 1.00, 0.3],  # home
        [1.0, 1.0, 0.80, 0.6],  # work
        [1.0, 0.9, 0.60, 0.7],  # education
        [1.0, 0.2, 0.20, 0.2],  # shopping
        [1.0, 0.1, 0.30, 1.0],  # social
        [0.0, 0.5, 0.05, 0.0],  # travel
    ],
    dtype=np.float32,
)

MODE_ID_MAP = {n: i for i, n in enumerate(MODE_NAMES)}
ID_TO_MODE_MAP = {i: n for i, n in enumerate(MODE_NAMES)}
PURPOSE_ID_MAP = {n: i for i, n in enumerate(PURPOSE_NAMES)}
ID_TO_PURPOSE_MAP = {i: n for i, n in enumerate(PURPOSE_NAMES)}

NUM_MODES = len(MODE_NAMES)
NUM_PURPOSES = len(PURPOSE_NAMES)


def get_mode_features(mode_id: int) -> np.ndarray:
    if not 0 <= mode_id < NUM_MODES:
        raise ValueError(f"Invalid mode_id: {mode_id}")
    return MODE_TABLE[mode_id]


def get_purpose_features(purpose_id: int) -> np.ndarray:
    if not 0 <= purpose_id < NUM_PURPOSES:
        raise ValueError(f"Invalid purpose_id: {purpose_id}")
    return PURPOSE_TABLE[purpose_id]


def get_feature_dimensions():
    return MODE_TABLE.shape[1], PURPOSE_TABLE.shape[1]
