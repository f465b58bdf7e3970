"""mode_sep training (port of ``ananke_abm_tpu/models/mode_sep/train.py``):
the optimizer steps over the total objective, a ``curves.csv`` row an
epoch, the best-by-loss checkpoint ``best.ckpt`` {params, config, Z,
zone_names, epoch}.

The union grid is built once over the whole dataset and lives on the
device; a step gathers a row batch of persons from it. An epoch's order
is ``np.random.default_rng(seed + epoch).permutation(n)``, the
reference's; a short batch is padded with its own first rows; batch
``bi``'s SDE draws come from ``utils.seed.generator(device, seed, epoch,
bi)``. The optimizer is the reference's chain ``zero_nonfinite ->
clip_by_global_norm(grad_clip) -> adamw(lr, weight_decay)``: non-finite
gradient values are zeroed (the step is still taken), then
``ClippedAdamW`` steps. One host read an epoch.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.mode_sep.batching import (
    UnionBatch,
    build_union_batch,
)
from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig
from ananke_abm_tpu_torch.models.mode_sep.data import load_trajectory_csvs
from ananke_abm_tpu_torch.models.mode_sep.losses import COMPONENTS, total_loss
from ananke_abm_tpu_torch.models.mode_sep.model import (
    ModeSepModel,
    init_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.utils.cfg import ensure_dir
from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
from ananke_abm_tpu_torch.utils.seed import generator

# the columns of curves.csv after ``epoch``: the components in sorted
# order, the order in which the reference's jitted step returns its dict
CURVE_COLUMNS = tuple(sorted(COMPONENTS))

BATCH_FIELDS = (
    "is_gt", "y_union", "stay_loc_ids", "gt_interior", "stay_non_gt",
    "travel_mask", "prev_zone", "dest_zone", "progress",
    "home_idx", "work_idx", "traits",
)


def union_to_device(union: UnionBatch, device):
    """(times (T,) on the device, {field: tensor on the device})."""
    batch = {f: torch.as_tensor(getattr(union, f)).to(device)
             for f in BATCH_FIELDS}
    return torch.as_tensor(union.times_union).to(device), batch


def zero_nonfinite(params) -> None:
    """Replace the non-finite values (nan and +-inf) of each gradient with
    zero, in place: an inf would make the global norm inf and the clip
    would then scale every update to zero."""
    for p in params:
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)


def make_train_step(model, optimizer, config, dist_mat, times):
    """``train_step(full_batch, rows, generator=None, noise=None)``: one
    step on the rows ``rows`` of the resident batch; the components in
    CURVE_COLUMNS' order as a tensor on the device."""
    def train_step(full_batch, rows, generator=None, noise=None):
        b = {k: v[rows] for k, v in full_batch.items()}
        optimizer.zero_grad()
        pred_emb, logits, v = model(times, b["home_idx"], b["work_idx"],
                                    b["traits"], generator, noise)
        loss, comps = total_loss(config, logits, pred_emb, v,
                                 model.class_table, dist_mat, b)
        loss.backward()
        zero_nonfinite(model.parameters())
        optimizer.step()
        return torch.stack([comps[k].detach().float()
                            for k in CURVE_COLUMNS])

    return train_step


def make_optimizer(model, config):
    return ClippedAdamW(model.parameters(), config.lr, config.weight_decay,
                        config.grad_clip)


def epoch_rows(seed: int, epoch: int, n: int, bsz: int) -> np.ndarray:
    """(n_batches, bsz) row indices of an epoch: the reference's
    permutation, each short batch padded with its own first rows."""
    perm = np.random.default_rng(seed + epoch).permutation(n)
    out = []
    for bi in range(max(1, n // bsz)):
        rows = perm[bi * bsz: bi * bsz + bsz]
        if rows.shape[0] < bsz:
            rows = np.concatenate([rows, rows[: bsz - rows.shape[0]]])
        out.append(rows)
    return np.stack(out)


def train(
    periods_csv: str,
    snaps_csv: str,
    outdir: str,
    config: ModeSepConfig | None = None,
    zones_csv: str | None = None,
    persons_csv: str | None = None,
    dist_mat_csv: str | None = None,
    max_epochs: int | None = None,
    *,
    device="cuda",
):
    """Train on the CSV family (the reference's arguments, files and
    printed line). ``device``: the card unless the caller asks for the CPU
    (no fallback). Returns {best_loss, seconds, ckpt}."""
    device = resolve_device(device)
    config = config or ModeSepConfig()
    if max_epochs is not None:
        config = dataclasses.replace(config, max_epochs=max_epochs)
    ensure_dir(outdir)

    people, shared = load_trajectory_csvs(
        periods_csv, snaps_csv, zones_csv, persons_csv, dist_mat_csv)
    union = build_union_batch(people, config.K_internal,
                              config.time_match_tol)
    times, full_batch = union_to_device(union, device)
    if config.enable_sde:
        times = union.times_union  # the SDE's step times live on the host
    dist_mat = torch.as_tensor(shared.dist_mat).to(device)
    Z = shared.id_maps.Z
    n = len(people)
    bsz = min(config.batch_size, n)

    model = ModeSepModel(Z, config).to(device)
    init_params(model, torch.Generator().manual_seed(config.seed))
    optimizer = make_optimizer(model, config)
    train_step = make_train_step(model, optimizer, config, dist_mat, times)

    curves_path = os.path.join(outdir, "curves.csv")
    best_path = os.path.join(outdir, "best.ckpt")
    best_loss = np.inf
    wrote_header = False

    t0 = time.time()
    n_batches = max(1, n // bsz)
    for epoch in range(1, config.max_epochs + 1):
        rows = torch.as_tensor(epoch_rows(config.seed, epoch, n, bsz)).to(
            device)
        comps_acc = None
        for bi in range(n_batches):
            comps = train_step(full_batch, rows[bi],
                               generator(device, config.seed, epoch, bi))
            comps_acc = comps if comps_acc is None else comps_acc + comps
        sums = comps_acc.cpu().numpy()  # the epoch's one host read
        comps_mean = {k: float(v) / n_batches
                      for k, v in zip(CURVE_COLUMNS, sums)}

        with open(curves_path, "a", encoding="utf-8") as f:
            if not wrote_header and os.path.getsize(curves_path) == 0:
                f.write("epoch," + ",".join(comps_mean.keys()) + "\n")
                wrote_header = True
            f.write(f"{epoch}," + ",".join(f"{v:.6f}"
                                          for v in comps_mean.values())
                    + "\n")

        if comps_mean["loss"] < best_loss:
            best_loss = comps_mean["loss"]
            save_checkpoint({
                "params": to_flax_params(model),
                "config": dataclasses.asdict(config),
                "Z": Z,
                "zone_names": shared.zone_names,
                "epoch": epoch,
            }, best_path)

    elapsed = time.time() - t0
    print(f"mode_sep training completed in {elapsed:.2f}s, best loss "
          f"{best_loss:.4f}")
    return {"best_loss": best_loss, "seconds": elapsed, "ckpt": best_path}
