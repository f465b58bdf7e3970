"""Shared set-up for the ``test_torch_*`` parity tests: the same config,
world and flax parameters in the JAX package and in the PyTorch port."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from ananke_abm_tpu.data_generator.agent_trajectories import (
    generate_agent_population,
)
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
from ananke_abm_tpu_torch.models.gnn_embed.params import load_flax_params

# the widths of tests/test_rollout_fused.py::_tiny_setup
TINY = dict(zone_dim=16, agent_dim=8, context_dim=8, hidden_dim=16,
            gat_heads=2, gat_layers=1, substeps=2)


@dataclasses.dataclass
class Pair:
    jcfg: object
    tcfg: object
    data: dict
    jmodel: object
    params: dict
    tmodel: object

    def arrays(self):
        """(zone_feats, adj, times, person_feats, home_zone) as numpy."""
        d = self.data
        return (d["zone_features"], d["adj"], d["times"],
                d["person_feats"], d["home_zone"])

    def tensors(self):
        zf, adj, times, pf, hz = self.arrays()
        return t32(zf), t32(adj), t32(times), t32(pf), tlong(hz)


def make_pair(num_blocks=1, n_agents=128, num_times=10, num_zones=12,
              full=False, seed=0, **overrides) -> Pair:
    """JAX model + flax params (``init_params`` at PRNGKey(seed)) and the
    port's model loaded from the same params, on the CPU."""
    kw = dict(overrides) if full else {**TINY, **overrides}
    jcfg = jtrain.GATODEConfig(num_blocks=num_blocks, **kw)
    data = generate_agent_population(
        n_agents, num_times=num_times, num_zones=num_zones, seed=seed
    )
    nzf = data["zone_features"].shape[-1]
    npf = data["person_feats"].shape[-1]
    jmodel = jtrain.build_model(jcfg, nzf, npf)
    params = jtrain.init_params(jmodel, jcfg, data, n_agents,
                                jax.random.PRNGKey(seed))
    tcfg = ttrain.GATODEConfig(**dataclasses.asdict(jcfg))
    tmodel = ttrain.build_model(tcfg, nzf, npf, device="cpu")
    load_flax_params(tmodel, params)
    return Pair(jcfg, tcfg, data, jmodel, params, tmodel)


def t32(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def tlong(a):
    return torch.as_tensor(np.array(a), dtype=torch.long)


def bf16_bits(a) -> np.ndarray:
    """Raw 16-bit patterns of a bf16 jax array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.mean(a == b))
