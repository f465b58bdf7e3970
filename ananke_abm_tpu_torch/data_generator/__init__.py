"""Synthetic zone worlds, agent populations and activity schedules:
numpy-only host code.

A copy of the JAX package's ``data_generator.agent_trajectories``,
``mock_world``, ``population``, ``features`` and (numpy and ``csv``, no
pandas) ``export_csvs``, so that the port imports nothing of the JAX
package. The
same seeds give the same arrays in both packages
(``tests/test_torch_data_generator.py``,
``tests/test_torch_schedule_pipeline.py``).
"""
from ananke_abm_tpu_torch.data_generator.agent_trajectories import (
    ZONES,
    generate_agent_population,
)

__all__ = ["ZONES", "generate_agent_population"]
