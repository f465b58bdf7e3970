"""Synthetic zone worlds and agent populations: numpy-only host code.

A copy of the JAX package's ``data_generator.agent_trajectories`` and
``mock_world`` (and the two id maps of its ``features``), so that the port
imports nothing of the JAX package. The same seeds give the same arrays in
both packages (``tests/test_torch_data_generator.py``).
"""
from ananke_abm_tpu_torch.data_generator.agent_trajectories import (
    ZONES,
    generate_agent_population,
)

__all__ = ["ZONES", "generate_agent_population"]
