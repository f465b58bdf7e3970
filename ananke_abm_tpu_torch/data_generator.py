"""Synthetic zone worlds and agent populations.

The generators are numpy-only host code, shared with the JAX package
rather than copied: importing them loads no JAX. Re-exported here so that
users of the port find them beside the rest of the port.
"""
from ananke_abm_tpu.data_generator.agent_trajectories import (
    ZONES,
    generate_agent_population,
)

__all__ = ["ZONES", "generate_agent_population"]
