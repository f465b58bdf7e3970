"""Mock-data loader (a copy of ``ananke_abm_tpu/data_generator/
load_data.py`` without pandas): persona timelines -> trajectories dict +
people / zones tables + adjacency with self loops.

The people and zones tables are {column: numpy array} in the columns and
the order of the reference's frames (``data_generator.population``'s
table form)."""
from __future__ import annotations

import numpy as np

from ananke_abm_tpu_torch.data_generator.mock_world import (
    ZONES,
    adjacency_matrix,
    distance_matrix,
    get_persona,
    persona_timeline,
    zone_feature_matrix,
    zone_names,
)

PEOPLE_COLUMNS = ("person_id", "name", "age", "income", "home_zone",
                  "work_zone", "employment", "commute_mode", "flexibility")
ZONE_COLUMNS = ("zone_id", "name", "type", "population", "job_opportunities",
                "retail_accessibility", "transit_accessibility",
                "attractiveness", "x_coord", "y_coord")


def _table(rows: list, columns) -> dict:
    return {c: np.array([r[i] for r in rows]) for i, c in enumerate(columns)}


def load_mock_data(person_ids=(1, 2)):
    """Returns dict with trajectories {pid: timeline}, people, zones
    ({column: array}), adjacency (self-looped), distance matrix, zone
    features and zone names."""
    trajectories = {pid: persona_timeline(get_persona(pid))
                    for pid in person_ids}
    people = _table([
        (p.person_id, p.name, p.age, p.income, p.home_zone, p.work_zone,
         p.employment, p.commute_mode, p.flexibility)
        for p in (get_persona(i) for i in person_ids)], PEOPLE_COLUMNS)
    zones = _table([
        (z, ZONES[z][0], ZONES[z][1], *ZONES[z][2:7], ZONES[z][7][0],
         ZONES[z][7][1]) for z in range(1, len(ZONES) + 1)], ZONE_COLUMNS)
    return {
        "trajectories": trajectories,
        "people": people,
        "zones": zones,
        "adjacency": adjacency_matrix(self_loops=True),
        "distance_matrix": distance_matrix(),
        "zone_features": zone_feature_matrix(),
        "zone_names": zone_names(),
    }
