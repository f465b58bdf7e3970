"""latent_ode training (port of
``ananke_abm_tpu/models/latent_ode/train.py``): Adam over the composite
loss on the mock personas' unified-timeline batch, the best-by-loss
checkpoint ``latent_ode_best_model.ckpt`` and the per-component
``loss_history.npz``.

The reference's cadence is kept: the iterations run in calls of
``steps_per_call``; at the end of each call the components are read once,
and the checkpoint is written when the call's *last* step's total beats
the best so far. Iteration ``i``'s draws (the reparameterisation noise,
then the SDE's) come from ``utils.seed.generator(device, seed, i)`` (the
reference: ``fold_in(PRNGKey(seed), i)``). The optimizer is optax.adam's:
``torch.optim.Adam`` with betas (0.9, 0.999), eps 1e-8, no weight decay.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.latent_ode.config import GenerativeODEConfig
from ananke_abm_tpu_torch.models.latent_ode.data import (
    get_person_sample,
    unify_and_interpolate_batch,
)
from ananke_abm_tpu_torch.models.latent_ode.loss import (
    COMPONENTS,
    calculate_composite_loss,
)
from ananke_abm_tpu_torch.models.latent_ode.model import (
    GenerativeODE,
    init_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.utils.cfg import ensure_dir
from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator

# the keys of loss_history.npz: the components in sorted order, the order
# in which the reference's jitted steps return their dict
HISTORY_KEYS = tuple(sorted(COMPONENTS))

BATCH_ARRAY_KEYS = (
    "t_unified", "y_loc_dense", "y_purp_dense", "y_mode_dense",
    "y_purp_feat_dense", "y_mode_feat_dense", "loss_mask",
    "prev_real_indices", "next_real_indices", "person_features",
    "all_zone_features", "distance_matrix",
    "initial_purpose_features", "initial_mode_features",
    "home_zone_ids", "work_zone_ids",
)


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_ARRAY_KEYS}


def build_model_and_batch(config, person_ids=(1, 2), *, device="cuda"):
    """(model, the batch's tensors on ``device``, the host batch)."""
    device = resolve_device(device)
    samples = [get_person_sample(pid, config) for pid in person_ids]
    batch = unify_and_interpolate_batch(samples, config)
    model = GenerativeODE(batch["person_features"].shape[-1],
                          batch["all_zone_features"].shape[-1],
                          config).to(device)
    return model, batch_to_device(batch, device), batch


def make_forward(model):
    """``forward(b, generator=None, eps=None, noise=None, times=None)``:
    the model on batch ``b`` at ``times`` (default ``b["t_unified"]``; a
    host array spares the SDE a device read)."""
    def forward(b, generator=None, eps=None, noise=None, times=None):
        zf = b["all_zone_features"]
        return model(b["person_features"], zf[b["home_zone_ids"]],
                     zf[b["work_zone_ids"]], b["initial_purpose_features"],
                     b["initial_mode_features"],
                     b["t_unified"] if times is None else times, zf,
                     generator, eps, noise)

    return forward


def make_loss_fn(model, config):
    """``loss_fn(b, generator=None, eps=None, noise=None, times=None) ->
    (total, components)``."""
    forward = make_forward(model)

    def loss_fn(b, generator=None, eps=None, noise=None, times=None):
        outputs = forward(b, generator, eps, noise, times)
        cand = model.encode_zones(b["all_zone_features"])
        return calculate_composite_loss(b, outputs, cand, config)

    return loss_fn


def make_optimizer(model, config):
    """optax.adam(learning_rate)."""
    return torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def train(
    outdir: str,
    config: GenerativeODEConfig | None = None,
    num_iterations: int | None = None,
    person_ids=(1, 2),
    seed: int = 0,
    steps_per_call: int = 10,
    log_every: int = 500,
    *,
    device="cuda",
):
    """Train on ``person_ids``' unified batch (the reference's arguments,
    files and printed lines). ``device``: the card unless the caller asks
    for the CPU (no fallback). Returns {best_loss, seconds, ckpt}."""
    device = resolve_device(device)
    config = config or GenerativeODEConfig()
    if num_iterations is not None:
        config = dataclasses.replace(config, num_iterations=num_iterations)
    ensure_dir(outdir)

    model, b, host = build_model_and_batch(config, person_ids, device=device)
    init_params(model, torch.Generator().manual_seed(seed))
    optimizer = make_optimizer(model, config)
    loss_fn = make_loss_fn(model, config)
    times = host["t_unified"].astype(np.float32)

    def train_steps(base, n_steps):
        rows = []
        for i in range(n_steps):
            optimizer.zero_grad(set_to_none=True)
            loss, comps = loss_fn(b, generator(device, seed, base + i),
                                  times=times)
            loss.backward()
            optimizer.step()
            rows.append(torch.stack([comps[k].detach()
                                     for k in HISTORY_KEYS]))
        out = torch.stack(rows).cpu().numpy()  # the call's one host read
        return {k: out[:, j] for j, k in enumerate(HISTORY_KEYS)}

    best = np.inf
    history = []
    ckpt_path = os.path.join(outdir, "latent_ode_best_model.ckpt")
    t0 = time.time()
    it = 0
    while it < config.num_iterations:
        n = min(steps_per_call, config.num_iterations - it)
        comps = train_steps(it, n)
        history.append(comps)
        it += n
        last = float(comps["total"][-1])
        if last < best:
            best = last
            save_checkpoint({
                "params": to_flax_params(model),
                "config": dataclasses.asdict(config),
                "person_ids": list(person_ids),
                "iteration": it,
            }, ckpt_path)
        if log_every and (it % log_every < steps_per_call):
            print(f"iter {it}: total={last:.4f} best={best:.4f}")

    elapsed = time.time() - t0
    hist = {k: np.concatenate([h[k] for h in history]) for k in history[0]}
    np.savez_compressed(os.path.join(outdir, "loss_history.npz"), **hist)
    print(f"latent_ode training: {config.num_iterations} iters in "
          f"{elapsed:.2f}s ({config.num_iterations / max(elapsed, 1e-9):.1f}"
          f" it/s)")
    return {"best_loss": best, "seconds": elapsed, "ckpt": ckpt_path}
