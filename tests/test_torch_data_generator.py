"""The port's copy of the numpy generator against the JAX package's: the
same arguments give the same arrays, dtypes and keys."""
import numpy as np
import pytest

from ananke_abm_tpu.data_generator import agent_trajectories as jgen
from ananke_abm_tpu_torch import data_generator as tgen


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        elif isinstance(a[k], tuple):
            assert len(a[k]) == len(b[k]), k
            for u, v in zip(a[k], b[k]):
                assert u.dtype == v.dtype and np.array_equal(u, v), k
        else:
            u, v = np.asarray(a[k]), np.asarray(b[k])
            assert u.dtype == v.dtype, (k, u.dtype, v.dtype)
            assert np.array_equal(u, v), k


@pytest.mark.parametrize("kw", [
    dict(n_agents=256, num_times=12, seed=0),
    dict(n_agents=512, num_times=12, seed=1, num_zones=500),
    dict(n_agents=512, num_times=8, seed=2, num_zones=2048),
    dict(n_agents=512, num_times=8, seed=2, num_zones=2048, world_seed=7),
    dict(n_agents=256, num_times=6, seed=3, num_zones=4096,
         sparse_world=True),
], ids=["default", "z500", "z2048", "z2048-world-seed", "sparse-z4096"])
def test_port_generator_matches_jax(kw):
    n = kw.pop("n_agents")
    _same(tgen.generate_agent_population(n, **kw),
          jgen.generate_agent_population(n, **kw))


def test_zone_tables_match():
    assert tgen.ZONES == jgen.ZONES
