"""Trajectory-figure utilities: the buffer grid and the stacked / zoomed
figures (port of ``ananke_abm_tpu/utils/traj_fig``)."""
