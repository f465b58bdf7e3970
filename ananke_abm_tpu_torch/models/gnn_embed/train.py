"""GAT-ODE configuration, construction, initialisation and serving (port
of the serving part of ``ananke_abm_tpu/models/gnn_embed/train.py``).

Training, the optimizer and ``train()`` are not ported yet (ROADMAP.md
queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.data_generator import (
    ZONES,
    generate_agent_population,
)
from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gnn_embed.model import GATODE
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    _linears,
    load_flax_params,
)
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint


@dataclasses.dataclass
class GATODEConfig:
    zone_dim: int = 64
    agent_dim: int = 32
    context_dim: int = 32
    hidden_dim: int = 128
    gat_heads: int = 4
    gat_layers: int = 2
    num_blocks: int = 2
    method: str = "rk4"
    substeps: int = 2
    rtol: float = 1e-5
    atol: float = 1e-5
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    batch_size: int = 4096
    epochs: int = 10
    compute_dtype: str = "float32"  # or "bfloat16"


def build_model(config: GATODEConfig, num_zone_features: int,
                person_feat_dim: int, *, device) -> GATODE:
    """A GATODE with uninitialised parameters on ``device``; fill it with
    :func:`init_params` or ``load_flax_params``."""
    return GATODE(
        num_zone_features=num_zone_features,
        person_feat_dim=person_feat_dim,
        zone_dim=config.zone_dim,
        agent_dim=config.agent_dim,
        context_dim=config.context_dim,
        hidden_dim=config.hidden_dim,
        gat_heads=config.gat_heads,
        gat_layers=config.gat_layers,
        num_blocks=config.num_blocks,
        compute_dtype=torch.bfloat16
        if config.compute_dtype == "bfloat16"
        else torch.float32,
        device=resolve_device(device),
    )


# flax's lecun_normal: a normal truncated at +-2 standard deviations,
# rescaled by the truncated distribution's standard deviation
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: GATODE, generator: torch.Generator) -> None:
    """Initialise ``model`` in place as flax initialises the reference:
    lecun-normal (truncated) Dense kernels, zero biases, xavier-uniform
    ``a_src`` / ``a_dst``, LayerNorm scale 1 and bias 0. Every draw comes
    from ``generator`` (the numbers differ from JAX's for the same seed)."""
    gdev = generator.device
    for lin in _linears(model).values():
        fan_in = lin.weight.shape[1]
        w = torch.empty(lin.weight.shape, device=gdev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        lin.weight.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        if lin.bias is not None:
            lin.bias.zero_()
    for layer in model.zone_gat.layers:
        for p in (layer.a_src, layer.a_dst):
            heads, d = p.shape  # flax: fan_in = heads, fan_out = d
            limit = math.sqrt(6.0 / (heads + d))
            u = torch.rand(p.shape, generator=generator, device=gdev)
            p.copy_(u * (2 * limit) - limit)
    for norm in model.zone_gat.norms:
        norm.weight.fill_(1.0)
        norm.bias.zero_()


def serve(
    ckpt_path: str,
    out_npz: str,
    n_agents: int = 4096,
    num_times: int | None = None,
    seed: int = 1,
    use_kernel: str | bool = "auto",
    world_seed: int | None = None,
    *,
    device,
):
    """Serve a GAT-ODE checkpoint (written by either package): regenerate
    its zone world from the checkpoint's world keys, draw a FRESH agent
    population of ``n_agents`` (``seed`` governs the agents only), run the
    decoded rollout on ``device`` and write
    ``out_npz{zone_ids (N, T) int32, times (T,)}``.

    ``use_kernel`` as in ``make_decoded_rollout``. ``world_seed``
    overrides the checkpoint's stored world seed. Checkpoints written
    before the world keys existed record none; serving them requires
    passing it, because guessing would rebuild a different zone world than
    the model was trained on.
    """
    device = resolve_device(device)
    ck = load_checkpoint(ckpt_path)
    config = GATODEConfig(**ck["config"])
    sparse = bool(ck.get("sparse_world", False))
    if sparse:
        raise NotImplementedError(
            "sparse-world checkpoints are not served by the port yet: "
            "ROADMAP.md queue 1 item 9"
        )
    if world_seed is None:
        if "world_seed" in ck:
            world_seed = int(ck["world_seed"])
        elif int(ck["num_zones"]) == len(ZONES):
            # the default mock world is fixed and seed-independent
            world_seed = 0
        else:
            raise ValueError(
                f"checkpoint {ckpt_path} predates the world-reconstruction "
                "keys (no 'world_seed') and its zone world is seeded; pass "
                "world_seed= (the seed the model was trained with) to "
                "serve it"
            )
    data = generate_agent_population(
        n_agents,
        num_times=int(num_times or ck["num_times"]),
        seed=seed,
        num_zones=int(ck["num_zones"]),
        world_seed=int(world_seed),
    )
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=device)
    load_flax_params(model, ck["params"])
    on = lambda a, dtype: torch.as_tensor(a, dtype=dtype).to(device)
    rollout = make_decoded_rollout(
        model, config, on(data["zone_features"], torch.float32),
        on(data["adj"], torch.float32), on(data["times"], torch.float32),
        use_kernel=use_kernel,
    )
    t0 = time.time()
    ids = rollout(on(data["person_feats"], torch.float32),
                  on(data["home_zone"], torch.long)).cpu().numpy()
    elapsed = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez(out_npz, zone_ids=ids, times=data["times"])
    return {
        "n_agents": n_agents,
        "num_times": ids.shape[1],
        "seconds": elapsed,
        "out": out_npz,
    }
