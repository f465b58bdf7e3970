"""TrajEmbed training (port of
``ananke_abm_tpu/models/traj_syn/pipeline/train_full.py``): train on an
activities CSV and a purposes catalog with ``crf_mode`` in {linear,
semi}; the best-by-validation checkpoint ``ckpt_best.ckpt``.

The VAE and the CRF head train jointly: total = CE + beta * KL +
lambda_crf * CRF-NLL(logits, labels), the CRF term the linear-chain NLL
(with the CRF's per-state bias) or the semi-Markov NLL under the Dmax
duration cap. One ``ClippedAdamW`` (optax's global-norm clip, then AdamW)
steps the VAE's and the CRF's parameters together.

The grid lives on the device; an epoch gathers shuffled rows by index and
pads its tail batch with wrapped rows, masked out of every loss mean. An
epoch's logged components are the unweighted mean over its batches; the
validation loss is one pass over all validation rows in eval mode, still
drawing the reparameterisation noise. Every draw (the permutation, the
dropout masks, the noise) comes from a generator seeded by ``(seed,
epoch)``. One host read per epoch.

Under a mesh each batch's rows (and the validation split's) split over the
``agents`` axis as in the schedule trainer
(``gen_schedule.pipeline.train.BatchRows``): whole-batch draws, means and
gradients summed over the ``agents`` group, rank 0 writing the files.
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.losses import cross_entropy_masked, kl_gaussian
from ananke_abm_tpu_torch.models.gen_schedule.crf.model import init_crf_params
from ananke_abm_tpu_torch.models.gen_schedule.pipeline.train import (
    BatchRows,
    _padded,
)
from ananke_abm_tpu_torch.models.traj_syn.configs import (
    CRFConfig,
    TrajEmbedConfig,
)
from ananke_abm_tpu_torch.models.traj_syn.model import (
    TrajEmbedVAE,
    init_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.ops.crf import crf_nll
from ananke_abm_tpu_torch.ops.semi_crf import semicrf_nll
from ananke_abm_tpu_torch.utils.cfg import ensure_dir
from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint
from ananke_abm_tpu_torch.utils.make_purposes import (
    build_purposes_catalog,
    read_catalog,
)
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
from ananke_abm_tpu_torch.utils.seed import generator
from ananke_abm_tpu_torch.utils.traj_fig.make_buffer_grid import (
    make_buffer_grid,
)

# the logged loss components, in the order of the reference's log columns
COMPONENTS = ("ce", "crf_nll", "kl", "loss")
FLUSH_EVERY = 100  # epochs between writes of ckpt_best.ckpt


def purpose_features_from_catalog(catalog: dict, purpose_map) -> np.ndarray:
    """(P, 8) catalog feature vectors ordered by purpose index, from the
    reference purposes.csv schema as {name: numpy column}: participation,
    occurrences per participating day, median duration and start, start
    circular variance, flexibility, and the two tags."""
    feats = np.zeros((len(purpose_map), 8), np.float32)
    row = {str(p): i for i, p in enumerate(catalog["purpose"].tolist())}
    for name, idx in purpose_map.items():
        if name not in row:
            continue
        r = {k: v[row[name]] for k, v in catalog.items()}
        occ_per_pd = float(r["n_occurrences"]) / max(
            float(r["n_person_days_with_purpose"]), 1.0)
        feats[idx] = [
            r["person_day_participation_rate"],
            np.log1p(occ_per_pd),
            r["median_duration_min"] / 480.0,
            r["median_start_min"] / 1440.0,
            r["start_circ_var"],
            r["flexibility"],
            float(r["is_primary"]),
            float(r["can_open_close_day"]),
        ]
    return feats


def load_catalog(activities_csv: str, purposes_csv: str | None) -> dict:
    """The catalog at ``purposes_csv`` when it has the feature columns,
    else one built from the activities."""
    if purposes_csv and os.path.exists(purposes_csv):
        catalog = read_catalog(purposes_csv)
        needed = {"person_day_participation_rate", "flexibility"}
        if needed <= set(catalog):
            return catalog
    return build_purposes_catalog(activities_csv)


def init_crf_head(gen: torch.Generator, P: int, crf_cfg: CRFConfig) -> dict:
    """The CRF head's parameters on the generator's device: the linear
    CRF's {A, bias}, or the semi-CRF's {A, dur (P, Dmax_bins) zeros}."""
    base = init_crf_params(gen, P)
    if crf_cfg.crf_mode == "semi":
        return {"A": base["A"],
                "dur": torch.zeros((P, crf_cfg.Dmax_bins),
                                   device=base["A"].device)}
    if crf_cfg.crf_mode == "linear":
        return base
    raise ValueError(f"Unknown crf_mode {crf_cfg.crf_mode!r}")


def make_loss_fn(model, crf_params, crf_cfg: CRFConfig, lambda_crf: float,
                 purpose_feats, group=None):
    """``loss_fn(batch_y, mask, beta, generator=None, eps=None) -> (loss,
    comps)``: CE + beta KL [+ lambda_crf CRF NLL]. ``crf_params`` None
    trains the VAE alone (``crf_nll`` logged as 0). ``generator`` draws the
    dropout masks and the noise, ``eps`` (B, z_dim) replaces the noise.
    Training mode is the model's. ``group``: the batch's rows lie on that
    process group's ranks; every mean runs over all of them."""

    def loss_fn(batch_y, mask, beta, generator=None, eps=None):
        logits, mu, logvar = model(batch_y, purpose_feats, generator, eps)
        ce = cross_entropy_masked(logits, batch_y, mask, group)
        kl = kl_gaussian(mu, logvar, mask, group)
        loss = ce + beta * kl
        comps = {"ce": ce, "kl": kl}
        if crf_params is not None:
            if crf_cfg.crf_mode == "semi":
                nll = semicrf_nll(logits, batch_y, crf_params["dur"],
                                  crf_params["A"], mask_b=mask,
                                  exact_long=crf_cfg.exact_long,
                                  group=group)
            else:
                nll = crf_nll(logits + crf_params["bias"][None, None, :],
                              batch_y, crf_params["A"], mask_b=mask,
                              group=group)
            loss = loss + lambda_crf * nll
            comps["crf_nll"] = nll
        else:
            comps["crf_nll"] = logits.new_zeros(())
        comps["loss"] = loss
        return loss, comps

    return loss_fn


def make_epoch_fns(model, optimizer, loss_fn, batch_size, mesh=None):
    """(train_epoch, val_loss). Each returns device tensors.

    ``train_epoch(Y, generator, beta, n_batches, perm=None, eps=None)``:
    shuffles (``perm`` replaces the generator's permutation), steps once a
    batch; the (len(COMPONENTS),) unweighted mean of the components over
    the batches. ``val_loss(Y, generator, beta, eps=None)``: the loss of
    one pass over all of Y in eval mode, the noise still drawn (``eps``
    replaces it). ``mesh``: the batches' and Y's rows split over its
    ``agents`` axis; ``loss_fn`` must then reduce over the ``agents``
    group."""
    split = BatchRows(batch_size, mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_epoch(Y, gen, beta, n_batches, perm=None, eps=None):
        model.train()
        if perm is None:
            perm = torch.randperm(Y.shape[0], generator=gen, device=Y.device)
        idx, mask = _padded(perm, n_batches, batch_size)
        rows = []
        for i in range(n_batches):
            sl = split.rows_of(i)
            optimizer.zero_grad()
            loss, comps = loss_fn(Y[idx[sl]], mask[sl], beta,
                                  split.generator(gen),
                                  None if eps is None else split.local(
                                      eps[i]))
            loss.backward()
            split.reduce_grads(params)
            optimizer.step()
            rows.append(torch.stack([comps[k].detach() for k in COMPONENTS]))
        return torch.stack(rows).mean(dim=0)

    @torch.no_grad()
    def val_loss(Y, gen, beta, eps=None):
        model.eval()
        whole = BatchRows(Y.shape[0], mesh)
        mask = torch.ones(Y.shape[0], device=Y.device)
        return loss_fn(whole.local(Y), whole.local(mask), beta,
                       whole.generator(gen),
                       None if eps is None else whole.local(eps))[0]

    return train_epoch, val_loss


def build_model(cfg: TrajEmbedConfig, L: int, P: int, device) -> TrajEmbedVAE:
    return TrajEmbedVAE(L, P, cfg.z_dim, cfg.emb_dim, cfg.cnn_channels,
                        cfg.cnn_kernel, cfg.cnn_dropout,
                        cfg.purpose_feat_dim).to(device)


def train_traj_embed(
    activities_csv: str,
    purposes_csv: str | None,
    epochs: int = 100,
    batch_size: int = 32,
    lr: float = 1e-3,
    val_ratio: float = 0.1,
    outdir: str = "runs/traj_embed",
    crf_mode: str = "linear",
    seed: int = 0,
    vae_only: bool = False,
    semi_Dmax_minutes: int = 300,
    config: TrajEmbedConfig | None = None,
    mesh=None,
    *,
    device="cuda",
):
    """Train the TrajEmbed model (the reference's arguments, files and
    printed line). ``mesh``: data-parallel over its ``agents`` axis (the
    module's notes); every rank returns the same dict. ``device``: the card
    unless the caller asks for the CPU (no fallback).

    Returns {best_val_loss, seconds, ckpt}."""
    device = resolve_device(device)
    writer = mesh is None or torch.distributed.get_rank() == 0
    group = None
    if mesh is not None:
        from ananke_abm_tpu_torch.parallel.mesh import AGENT_AXIS

        group = mesh.get_group(AGENT_AXIS)
    cfg = config or TrajEmbedConfig(lr=lr)
    crf_cfg = CRFConfig(crf_mode=crf_mode,
                        semi_Dmax_minutes=semi_Dmax_minutes,
                        grid_min=cfg.grid_min)
    ensure_dir(outdir)

    Y, purpose_map, _ = make_buffer_grid(
        activities_csv, grid_min=cfg.grid_min, horizon_min=cfg.horizon_min)
    P, L = len(purpose_map), Y.shape[1]
    feats_np = purpose_features_from_catalog(
        load_catalog(activities_csv, purposes_csv), purpose_map)
    purpose_feats = torch.as_tensor(feats_np).to(device)

    perm = np.random.default_rng(seed).permutation(Y.shape[0])
    n_val = int(round(val_ratio * Y.shape[0]))
    Y_dev = torch.as_tensor(Y.astype(np.int64))
    Y_val = Y_dev[torch.as_tensor(perm[:n_val])].to(device)
    Y_train = Y_dev[torch.as_tensor(perm[n_val:])].to(device)

    model = build_model(cfg, L, P, device)
    init_params(model, torch.Generator().manual_seed(seed))
    crf_params = None if vae_only else init_crf_head(
        generator(device, seed, 1), P, crf_cfg)
    crf_list = [] if crf_params is None else list(crf_params.values())
    for v in crf_list:
        v.requires_grad_(True)

    bsz = int(min(batch_size, max(1, Y_train.shape[0])))
    optimizer = ClippedAdamW(list(model.parameters()) + crf_list, cfg.lr,
                             cfg.weight_decay, cfg.grad_clip)
    loss_fn = make_loss_fn(model, crf_params, crf_cfg, cfg.lambda_crf,
                           purpose_feats, group)
    train_epoch, val_loss = make_epoch_fns(model, optimizer, loss_fn, bsz,
                                           mesh)
    n_tb = max(1, -(-Y_train.shape[0] // bsz))

    meta = {"purpose_map": purpose_map, "grid_min": cfg.grid_min,
            "horizon_min": cfg.horizon_min, "L": int(L), "N": int(Y.shape[0])}

    warmup = max(1, int(epochs * cfg.beta_warm_frac))
    best = np.inf
    ckpt_path = os.path.join(outdir, "ckpt_best.ckpt")
    logs = []
    t0 = time.time()
    # the best state is cloned on the device at each improvement (the live
    # parameters change in place); ckpt_best is written every FLUSH_EVERY
    # epochs and once at exit
    best_state = None  # (model state, CRF params, epoch)
    last_flushed = 0

    def flush_best():
        nonlocal last_flushed
        if (not writer or best_state is None
                or best_state[2] == last_flushed):
            return
        state, crf_best, bepoch = best_state
        shadow = copy.deepcopy(model)
        shadow.load_state_dict(state)
        save_checkpoint({
            "params": to_flax_params(shadow),
            "crf_params": crf_best,
            "cfg": dataclasses.asdict(cfg),
            "crf_cfg": dataclasses.asdict(crf_cfg),
            "meta": meta,
            "purpose_feats": feats_np,
            "epoch": bepoch,
        }, ckpt_path)
        last_flushed = bepoch

    for epoch in range(1, epochs + 1):
        beta = cfg.beta_target * min(1.0, epoch / warmup)
        gen = generator(device, seed, epoch)
        comps = train_epoch(Y_train, gen, beta, n_tb)
        vl = val_loss(Y_val, gen, beta) if Y_val.shape[0] > 0 \
            else comps[COMPONENTS.index("loss")]
        values = torch.cat([comps, vl.reshape(1)]).tolist()  # host read
        vl = values[-1]
        logs.append({"epoch": epoch, "val_loss": vl,
                     **dict(zip(COMPONENTS, values[:-1]))})
        if vl < best:
            best = vl
            best_state = (
                {k: v.detach().clone() for k, v in model.state_dict().items()},
                None if crf_params is None else
                {k: v.detach().clone() for k, v in crf_params.items()},
                epoch)
        if epoch % FLUSH_EVERY == 0:
            flush_best()
    flush_best()
    elapsed = time.time() - t0

    if writer:
        with open(os.path.join(outdir, "training_log.csv"), "w", newline="",
                  encoding="utf-8") as f:
            if logs:
                w = csv.DictWriter(f, fieldnames=list(logs[0]),
                                   lineterminator="\n")
                w.writeheader()
                w.writerows(logs)
        with open(os.path.join(outdir, "meta.json"), "w",
                  encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
    print(f"traj_embed training completed in {elapsed:.2f}s, best val "
          f"{best:.4f}")
    return {"best_val_loss": best, "seconds": elapsed, "ckpt": ckpt_path}


def train_vae_only(*args, **kwargs):
    """The VAE-only variant (reference scripts/traj_embed/vae_only_test.sh)."""
    kwargs["vae_only"] = True
    return train_traj_embed(*args, **kwargs)
