"""Trajectory CSV -> person x time-bin label grid (port of
``ananke_abm_tpu/utils/traj_fig/make_buffer_grid.py``): 5-minute bins
over a 1800-minute (30 h) allocation horizon, the final bin forced to
Home. The activities are read with ``dataio/rasterize.py::read_csv`` and
rasterized by its ``rasterize_frame`` (the native host pass where the
library is built, else its numpy recurrence)."""
from __future__ import annotations

from ananke_abm_tpu_torch.dataio.rasterize import rasterize_frame, read_csv

BUFFER_HORIZON_MIN = 1800  # 30 h allocation horizon
DEFAULT_GRID_MIN = 5
HOME_NAME = "Home"


def make_buffer_grid(activities, grid_min: int = DEFAULT_GRID_MIN,
                     horizon_min: int = BUFFER_HORIZON_MIN):
    """``activities``: a CSV path or a dict of numpy columns (as
    ``read_csv`` gives). Returns (grid (N, L) int64, purpose_map, persids):
    purposes sorted and unique, Home added where absent; the final bin is
    Home."""
    cols = read_csv(activities) if isinstance(activities, str) \
        else dict(activities)
    if "startime" in cols and "starttime" not in cols:
        cols["starttime"] = cols.pop("startime")
    purposes = sorted(set(cols["purpose"].tolist()) | {HOME_NAME})
    purpose_map = {p: i for i, p in enumerate(purposes)}
    Y, persids = rasterize_frame(cols, purpose_map, grid_min, horizon_min)
    Y[:, -1] = purpose_map[HOME_NAME]  # forced Home in the final bin
    return Y, purpose_map, persids
