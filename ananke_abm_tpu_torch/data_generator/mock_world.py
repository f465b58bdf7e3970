"""Mock 8-zone city + two personas with daily event schedules.

Capability parity with the reference mock world
(src/ananke_abm/data_generator/mock_locations.py:27-146, mock_2p.py:10-289):
an 8-zone spatial graph with 7 per-zone features + weighted edges and a
Euclidean distance matrix; two personas — a rigid car-commuting office
worker and a flexible transit retail worker — with timestamped daily events
(time, zone, activity, travel mode, anchor importance); per-person
attribute vectors (8,) and optional noisy multi-day repetition.

Implementation is numpy-first (no networkx dependency on the model path;
an adjacency matrix is exposed directly). Zone/persona values are this
framework's own mock city.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ananke_abm_tpu_torch.data_generator.features import MODE_ID_MAP, PURPOSE_ID_MAP

ZONE_FEATURE_NAMES = (
    "population", "job_opportunities", "retail_accessibility",
    "transit_accessibility", "attractiveness", "x_coord", "y_coord",
)

# zone_id (1-based): name, type, population, jobs, retail, transit, attract, (x, y)
ZONES = {
    1: ("Maple Court", "residential_medium", 2200, 40, 0.35, 0.55, 0.70, (0.0, 0.0)),
    2: ("Corner Market Row", "retail_local", 150, 350, 0.90, 0.65, 0.55, (1.0, 0.0)),
    3: ("Cedar Flats", "residential_high", 7400, 120, 0.75, 0.90, 0.80, (2.0, 0.0)),
    4: ("Old Quarter", "entertainment", 450, 900, 0.80, 0.85, 0.92, (2.0, 1.0)),
    5: ("Harbor Office Tower", "commercial_office", 80, 5200, 0.40, 0.75, 0.50, (3.0, 1.0)),
    6: ("Northside Campus", "education", 900, 1200, 0.30, 0.80, 0.65, (3.0, 0.0)),
    7: ("Greenbelt Gym", "recreation", 30, 180, 0.20, 0.50, 0.70, (1.0, 1.0)),
    8: ("Riverpark", "park", 10, 30, 0.10, 0.40, 0.95, (0.0, 1.0)),
}

# (zone_a, zone_b, distance_km, travel_time_h, road_type)
EDGES = [
    (1, 2, 1.0, 0.12, "arterial"),
    (1, 7, 1.4, 0.15, "local"),
    (1, 8, 1.0, 0.12, "local"),
    (2, 3, 1.0, 0.10, "arterial"),
    (2, 7, 1.0, 0.12, "local"),
    (3, 4, 1.0, 0.10, "arterial"),
    (3, 6, 1.0, 0.10, "highway"),
    (4, 5, 1.0, 0.08, "arterial"),
    (5, 6, 1.0, 0.08, "arterial"),
    (6, 4, 1.4, 0.12, "local"),
    (7, 4, 1.4, 0.15, "local"),
    (8, 7, 1.0, 0.12, "local"),
]


def zone_names() -> List[str]:
    return [ZONES[i + 1][0] for i in range(len(ZONES))]


def zone_feature_matrix() -> np.ndarray:
    """(Z, 7) float32: population, jobs, retail, transit, attract, x, y
    (population/jobs log-scaled to keep features O(1))."""
    rows = []
    for z in range(1, len(ZONES) + 1):
        _, _, pop, jobs, retail, transit, attract, (x, y) = ZONES[z]
        rows.append(
            [np.log1p(pop) / 10.0, np.log1p(jobs) / 10.0, retail, transit,
             attract, x / 3.0, y / 3.0]
        )
    return np.array(rows, dtype=np.float32)


def distance_matrix() -> np.ndarray:
    """(Z, Z) Euclidean distances from coordinates (reference
    mock_locations.py:5-24 semantics)."""
    coords = np.array([ZONES[z][7] for z in range(1, len(ZONES) + 1)])
    diff = coords[:, None, :] - coords[None, :, :]
    return np.sqrt((diff**2).sum(-1)).astype(np.float32)


def adjacency_matrix(self_loops: bool = True) -> np.ndarray:
    Z = len(ZONES)
    A = np.zeros((Z, Z), np.float32)
    for a, b, *_ in EDGES:
        A[a - 1, b - 1] = 1.0
        A[b - 1, a - 1] = 1.0
    if self_loops:
        np.fill_diagonal(A, 1.0)
    return A


def edge_index() -> np.ndarray:
    """(2, 2E) directed edge list (both directions), 0-based."""
    pairs = []
    for a, b, *_ in EDGES:
        pairs.append((a - 1, b - 1))
        pairs.append((b - 1, a - 1))
    return np.array(pairs, np.int64).T


@dataclasses.dataclass
class Persona:
    person_id: int
    name: str
    age: int
    income: float
    home_zone: int  # 1-based
    work_zone: int  # 1-based
    employment: str
    commute_mode: str
    flexibility: float  # 0 rigid .. 1 flexible
    # events: (time_h, zone_1based, purpose, mode, anchor)
    events: List[Tuple[float, int, str, str, int]]

    def attributes(self) -> np.ndarray:
        """(8,) person attribute vector (normalized)."""
        return np.array(
            [
                self.age / 100.0,
                self.income / 1e5,
                self.flexibility,
                1.0 if self.employment == "fulltime" else 0.5,
                1.0 if self.commute_mode == "car" else 0.0,
                (self.home_zone - 1) / 7.0,
                (self.work_zone - 1) / 7.0,
                1.0,
            ],
            dtype=np.float32,
        )


def create_persona_one() -> Persona:
    """Rigid car-commuting office worker (reference Sarah analogue)."""
    return Persona(
        person_id=1,
        name="Ava",
        age=33,
        income=82000.0,
        home_zone=1,
        work_zone=5,
        employment="fulltime",
        commute_mode="car",
        flexibility=0.2,
        events=[
            (7.25, 1, "home", "stay", 1),
            (8.50, 1, "home", "stay", 0),
            (9.00, 5, "work", "car", 1),
            (12.50, 5, "work", "stay", 0),
            (13.00, 2, "shopping", "walk", 0),
            (13.50, 5, "work", "walk", 0),
            (17.50, 5, "work", "stay", 0),
            (18.25, 7, "social", "car", 0),
            (19.50, 1, "home", "car", 1),
            (22.50, 1, "home", "stay", 1),
        ],
    )


def create_persona_two() -> Persona:
    """Flexible transit retail worker (reference Marcus analogue)."""
    return Persona(
        person_id=2,
        name="Theo",
        age=26,
        income=43000.0,
        home_zone=3,
        work_zone=6,
        employment="parttime",
        commute_mode="public_transit",
        flexibility=0.8,
        events=[
            (8.00, 3, "home", "stay", 1),
            (9.75, 3, "home", "stay", 0),
            (10.25, 6, "education", "public_transit", 1),
            (14.00, 6, "education", "stay", 0),
            (14.75, 4, "social", "walk", 0),
            (16.50, 2, "shopping", "public_transit", 0),
            (17.25, 3, "home", "public_transit", 1),
            (20.00, 8, "social", "walk", 0),
            (21.50, 3, "home", "walk", 1),
            (23.00, 3, "home", "stay", 1),
        ],
    )


def get_persona(person_id: int) -> Persona:
    if person_id == 1:
        return create_persona_one()
    if person_id == 2:
        return create_persona_two()
    raise ValueError(f"Unknown mock person_id {person_id}")


def persona_timeline(
    persona: Persona,
    repeat_days: int = 1,
    noise_std_h: float = 0.0,
    seed: int = 0,
):
    """Event schedule -> training arrays (reference
    create_training_data_single_person, mock_2p.py:268-289).

    Returns dict with times (T,), zone_ids (T,) 0-based, purpose ids,
    mode ids, anchor flags, person attrs (8,), zone features (Z,7),
    distance matrix (Z,Z).
    """
    rng = np.random.default_rng(seed)
    times, zones, purps, modes, anchors = [], [], [], [], []
    for day in range(repeat_days):
        for (t, z, purpose, mode, anchor) in persona.events:
            tt = t + 24.0 * day
            if noise_std_h > 0 and not anchor:
                tt = tt + rng.normal(0.0, noise_std_h)
            times.append(tt)
            zones.append(z - 1)
            purps.append(PURPOSE_ID_MAP[purpose])
            modes.append(MODE_ID_MAP[mode])
            anchors.append(anchor)
    order = np.argsort(times, kind="stable")
    return {
        "person_id": persona.person_id,
        "person_name": persona.name,
        "times": np.asarray(times, np.float32)[order],
        "zone_ids": np.asarray(zones, np.int64)[order],
        "purpose_ids": np.asarray(purps, np.int64)[order],
        "mode_ids": np.asarray(modes, np.int64)[order],
        "anchors": np.asarray(anchors, np.int64)[order],
        "person_attrs": persona.attributes(),
        "home_zone_id": persona.home_zone - 1,
        "work_zone_id": persona.work_zone - 1,
        "zone_features": zone_feature_matrix(),
        "distance_matrix": distance_matrix(),
    }
