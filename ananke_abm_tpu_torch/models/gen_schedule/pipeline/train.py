"""Schedule-VAE training (port of
``ananke_abm_tpu/models/gen_schedule/pipeline/train.py``).

The composite loss is CE + beta * KL (beta warmed up linearly over
``beta_warm_frac`` of the epochs) + lambda_tv * total variation +
lambda_home * start/end-home loss [+ lambda_tod / lambda_presence /
lambda_share calibration terms for auto_pds]; AdamW after optax's
global-norm clip (``ClippedAdamW``); the best-by-val checkpoint on an
improvement above IMPROVEMENT_THRESHOLD; early stop after ``patience``
stale epochs once past ``min_epochs``; {last, best_val} checkpoints
embedding meta and cfg; a per-epoch ``training_log.csv``.

The whole (N, T) grid lives on the device and an epoch gathers shuffled
rows there by index; the tail batch is padded with wrapped indices and
masked out of every loss mean. The loss components stay on the device:
one host read per epoch. Every random draw (the permutation, the dropout
masks, the reparameterisation noise) comes from a generator seeded by
``(seed, epoch)``, so a resumed run repeats the uninterrupted one.

Under a mesh every rank holds the whole grid and the same generator: each
batch's rows split over the ``agents`` axis, every draw is made at the
whole batch's shape and each rank keeps its rows (``utils.seed.RowDraws``),
the losses' means, the batch-norm statistics and the gradients are summed
over the ``agents`` group: the single-device run's numbers. Rank 0 writes
the files.
"""
from __future__ import annotations

import copy
import csv
import json
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.losses import (
    cross_entropy_masked,
    kl_gaussian,
    minutes_share_loss,
    presence_rate_loss,
    start_end_home_loss,
    time_of_day_marginal_loss,
    time_total_variation,
)
from ananke_abm_tpu_torch.models.gen_schedule.factory import build_model
from ananke_abm_tpu_torch.models.gen_schedule.params import (
    load_flax_params,
    to_flax_batch_stats,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gen_schedule.vae import init_params
from ananke_abm_tpu_torch.utils.cfg import ensure_dir, load_config
from ananke_abm_tpu_torch.utils.ckpt import (
    adamw_state,
    load_adamw_state,
    load_training_checkpoint,
    save_checkpoint,
)
from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
from ananke_abm_tpu_torch.utils.seed import RowDraws, generator, set_seed

IMPROVEMENT_THRESHOLD = 0.003  # the reference's train.py:250

# the loss components, in the order of the reference's log columns
COMPONENTS = ("ce", "home", "kl", "loss", "presence", "share", "tod", "tv")


def _resolve_splits_path(cfg: dict) -> str:
    data = cfg["data"]
    p = data.get("splits") or data.get("split_pt") or ""
    if p.endswith(".pt"):  # reference-style config pointing at torch splits
        p = p[: -len(".pt")] + ".npz"
    if not p:
        p = data["npz"].replace(".npz", "_splits.npz")
    return p


def loss_weights(cfg: dict) -> dict:
    """The composite loss's weights from ``cfg["train"]`` (the reference's
    defaults: lambda_home 0.1, the others 0)."""
    tr = cfg["train"]
    return {"tv": float(tr.get("lambda_tv", 0.0)),
            "home": float(tr.get("lambda_home", 0.1)),
            "tod": float(tr.get("lambda_tod", 0.0)),
            "presence": float(tr.get("lambda_presence", 0.0)),
            "share": float(tr.get("lambda_share", 0.0))}


def load_pds_arrays(cfg: dict, pds_features):
    """The PDS calibration targets of an auto_pds ``cfg`` on the device of
    ``pds_features`` (from ``build_model``), else None."""
    if cfg["model"]["method"] != "auto_pds":
        return None
    with np.load(cfg["model"]["pds_path"]) as pds:
        m_tod = torch.as_tensor(pds["m_tod"], dtype=torch.float32)
        presence = torch.as_tensor(pds["presence_rate"], dtype=torch.float32)
    dev = pds_features.device
    return {"pds_features": pds_features, "m_tod": m_tod.to(dev),
            "presence": presence.to(dev),
            # empirical minutes share = time-mean of the ToD marginal
            "share_emp": m_tod.mean(dim=1).to(dev)}


def make_loss_fn(model, home_idx, lambdas, pds_arrays, group=None):
    """The composite masked loss. ``pds_arrays`` is None or a dict with
    pds_features (P, T, D), m_tod (P, T), presence (P,), share_emp (P,).

    ``loss_fn(batch_y, mask, beta, generator=None, eps=None) -> (loss,
    comps)``: ``generator`` draws the dropout masks and the noise, ``eps``
    (B, z_dim) replaces the noise. Training mode is the model's
    (``model.train()``: dropout, batch statistics and their running
    update). ``group``: the batch's rows lie on that process group's ranks
    and every mean runs over all of them (``losses.schedule``)."""

    def loss_fn(batch_y, mask, beta, generator=None, eps=None):
        pds = pds_arrays["pds_features"] if pds_arrays is not None else None
        logits, mu, logvar = model(batch_y, generator, pds, eps)
        ce = cross_entropy_masked(logits, batch_y, mask, group)
        kl = kl_gaussian(mu, logvar, mask, group)
        tv = time_total_variation(logits, mask, group)
        home = start_end_home_loss(logits, home_idx, mask, group)
        loss = ce + beta * kl + lambdas["tv"] * tv + lambdas["home"] * home
        zero = logits.new_zeros(())
        comps = {"ce": ce, "kl": kl, "tv": tv, "home": home,
                 "tod": zero, "presence": zero, "share": zero}
        if pds_arrays is not None:
            tod = time_of_day_marginal_loss(logits, pds_arrays["m_tod"], mask,
                                            group)
            pres = presence_rate_loss(logits, pds_arrays["presence"], mask,
                                      group)
            loss = loss + lambdas["tod"] * tod + lambdas["presence"] * pres
            comps["tod"], comps["presence"] = tod, pres
            if lambdas.get("share", 0.0) > 0.0:
                shr = minutes_share_loss(logits, pds_arrays["share_emp"],
                                         mask, group)
                loss = loss + lambdas["share"] * shr
                comps["share"] = shr
        comps["loss"] = loss
        return loss, comps

    return loss_fn


def _padded(order, n_batches, batch_size, wrap=True):
    """Row indices padded to n_batches * batch_size, by wrapping (else with
    row 0), and the row-validity mask."""
    n = order.shape[0]
    pad = n_batches * batch_size - n
    fill = order[:pad] if wrap else torch.zeros_like(order[:1]).expand(pad)
    idx = torch.cat([order, fill]) if pad else order
    mask = torch.ones(n_batches * batch_size, device=order.device)
    if pad:
        mask[n:] = 0.0
    return idx, mask


class BatchRows:
    """How a batch of ``batch_size`` rows splits over a mesh's ``agents``
    axis: this rank's ``rows`` of it, the ``generator`` its draws come from
    (a ``RowDraws`` of the whole batch) and the gradients' sum over the
    ``agents`` group. Without a mesh every row is this process's."""

    def __init__(self, batch_size, mesh=None):
        self.group = self.rows = None
        if mesh is not None:
            from ananke_abm_tpu_torch.parallel.mesh import (
                AGENT_AXIS,
                row_slice,
            )

            self.group = mesh.get_group(AGENT_AXIS)
            self.rows = row_slice(batch_size, mesh)
        self.batch_size = batch_size

    def local(self, x):
        """This rank's rows of a tensor holding the whole batch."""
        return x if self.rows is None else x[self.rows]

    def rows_of(self, i):
        """This rank's rows of batch ``i``: a slice of the epoch's padded
        order."""
        lo = i * self.batch_size
        if self.rows is None:
            return slice(lo, lo + self.batch_size)
        return slice(lo + self.rows.start, lo + self.rows.stop)

    def generator(self, gen):
        if self.rows is None or gen is None:
            return gen
        return RowDraws(gen, self.rows, self.batch_size, self.group)

    def reduce_grads(self, params):
        if self.group is not None:
            from ananke_abm_tpu_torch.parallel.collectives import (
                all_reduce_grads,
            )

            all_reduce_grads(params, self.group)


def make_epoch_fns(model, optimizer, loss_fn, batch_size, mesh=None):
    """(train_epoch, eval_epoch). Each returns the epoch's mean loss
    components as one (len(COMPONENTS),) device tensor. ``mesh``: each
    batch splits over its ``agents`` axis (:class:`BatchRows`); ``loss_fn``
    must then reduce over the ``agents`` group.

    ``train_epoch(Y, generator, beta, n_batches, perm=None, eps=None)``:
    shuffles (``perm`` replaces the generator's permutation), steps the
    optimizer once a batch, the components' mean over the batches.
    ``eval_epoch(Y, generator, beta, n_batches, eps=None)``: in eval mode,
    the components weighted by each batch's valid rows. ``eps``: one noise
    tensor per batch, replacing the draws."""

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
    def eval_epoch(Y, gen, beta, n_batches, eps=None):
        model.eval()
        idx, mask = _padded(torch.arange(Y.shape[0], device=Y.device),
                            n_batches, batch_size, wrap=False)
        rows, weights = [], []
        for i in range(n_batches):
            whole = slice(i * batch_size, (i + 1) * batch_size)
            sl = split.rows_of(i)
            _, comps = loss_fn(Y[idx[sl]], mask[sl], beta,
                               split.generator(gen),
                               None if eps is None else split.local(eps[i]))
            rows.append(torch.stack([comps[k] for k in COMPONENTS]))
            weights.append(mask[whole].sum())
        w = torch.stack(weights)
        return (torch.stack(rows) * w[:, None]).sum(0) / torch.clamp(
            w.sum(), min=1.0)

    return train_epoch, eval_epoch


def _snapshot(model, optimizer):
    """The model's and the optimizer's state, copied on the device (no host
    sync)."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.adamw.state_dict()))


def _last_ckpt_due(epoch, start_epoch, num_epochs, ckpt_every, chunk, stop):
    """Whether ``last.ckpt`` is written after ``epoch``: at every
    ``ckpt_every``-th epoch; with ``chunk`` (``train.epochs_per_jit``) > 1
    on the cadence of the reference's fused scan, which writes it at the
    end of a chunk of ``chunk`` epochs from ``start_epoch`` (or at the
    run's last or stopping epoch) when that chunk crossed a multiple of
    ``ckpt_every`` (its ``train.py:484-540``)."""
    if chunk <= 1:
        return epoch % ckpt_every == 0
    chunk_start = start_epoch + (epoch - start_epoch) // chunk * chunk
    chunk_end = stop or epoch in (num_epochs, chunk_start + chunk - 1)
    return chunk_end and epoch // ckpt_every > (chunk_start - 1) // ckpt_every


def train(config, output_dir: str, seed: int = 123, resume: bool = False,
          mesh=None, *, device="cuda"):
    """Train a schedule VAE. ``config`` is a path or a dict. The reference's
    ``train()``: same keys, checkpoints, log and early stop.
    ``train.epochs_per_jit`` > 1 runs this same per-epoch loop (the
    reference's fused multi-epoch scan reproduces it) and writes
    ``last.ckpt`` on that scan's cadence (``_last_ckpt_due``). ``resume=True``
    continues from ``checkpoints/last.ckpt`` when it exists (the port's own;
    a JAX-written one holds an optax state and is refused). ``mesh``: an
    (agents, zones) ``parallel.make_mesh`` mesh; data-parallel training with
    the single-device run's numbers (the module's notes), rank 0 writing
    the checkpoints and the log. ``device``: the card unless the caller
    asks for the CPU (no fallback).

    Returns {best_val_loss, epochs_ran, seconds}, the same on every
    rank."""
    device = resolve_device(device)
    writer = mesh is None or torch.distributed.get_rank() == 0
    cfg = load_config(config) if isinstance(config, str) else config
    set_seed(seed)

    outdir = output_dir
    if writer:
        ensure_dir(outdir)
        ensure_dir(os.path.join(outdir, "checkpoints"))

    data_npz = cfg["data"]["npz"]
    with open(data_npz.replace(".npz", "_meta.json"), "r",
              encoding="utf-8") as f:
        meta = json.load(f)
    home_idx = meta["purpose_map"].get("Home")
    if home_idx is None:
        raise ValueError("Purpose map must contain 'Home'.")

    t_start = time.time()

    with np.load(data_npz) as grid:
        Y_all = torch.as_tensor(grid["Y"].astype(np.int64))
    with np.load(_resolve_splits_path(cfg)) as splits:
        Y_train = Y_all[torch.as_tensor(splits["train_idx"])].to(device)
        Y_val = Y_all[torch.as_tensor(splits["val_idx"])].to(device)

    model, pds_features = build_model(cfg, meta, device=device)
    init_params(model, torch.Generator().manual_seed(seed))

    tr = cfg["train"]
    batch_size = int(min(tr["batch_size"], max(1, Y_train.shape[0])))
    lambdas = loss_weights(cfg)
    pds_arrays = load_pds_arrays(cfg, pds_features)

    optimizer = ClippedAdamW(model.parameters(), float(tr["lr"]),
                             float(tr.get("weight_decay", 0.0)),
                             float(tr.get("grad_clip", 5.0)))
    names = [n for n, _ in model.named_parameters()]
    start_epoch = 1

    last_ckpt = os.path.join(outdir, "checkpoints", "last.ckpt")
    best_ckpt = os.path.join(outdir, "checkpoints", "best_val.ckpt")
    if resume and os.path.exists(last_ckpt):
        obj = load_training_checkpoint(last_ckpt)
        load_flax_params(model, obj["params"], obj.get("batch_stats"))
        load_adamw_state(optimizer.adamw, obj["opt_state"], names)
        start_epoch = int(obj.get("epoch", 0)) + 1

    group = None
    if mesh is not None:
        from ananke_abm_tpu_torch.models.gen_schedule.encoders import (
            set_batch_norm_group,
        )
        from ananke_abm_tpu_torch.parallel.mesh import AGENT_AXIS

        group = mesh.get_group(AGENT_AXIS)
        set_batch_norm_group(model, group)
    train_epoch, eval_epoch = make_epoch_fns(
        model, optimizer,
        make_loss_fn(model, home_idx, lambdas, pds_arrays, group),
        batch_size, **({} if mesh is None else {"mesh": mesh}))

    num_epochs = int(tr["epochs"])
    min_epochs = int(tr.get("min_epochs", num_epochs))
    patience = int(tr.get("patience", 0))
    warmup_epochs = max(1, int(num_epochs * float(tr.get("beta_warm_frac",
                                                         0.3))))
    beta_target = float(tr.get("beta_target", 1.0))
    n_tb = -(-Y_train.shape[0] // batch_size)
    n_vb = max(1, -(-Y_val.shape[0] // batch_size))
    ckpt_every = int(tr.get("ckpt_every", 25))
    chunk = int(tr.get("epochs_per_jit", 1))

    def save(obj, path):
        if writer:
            save_checkpoint(obj, path)

    def ckpt(epoch):
        return {"params": to_flax_params(model),
                "opt_state": adamw_state(optimizer.adamw, names),
                "batch_stats": to_flax_batch_stats(model),
                "meta": meta, "cfg": cfg, "epoch": epoch}

    best_val_loss = np.inf
    best_state = None  # (model state, optimizer state, epoch) on the device
    wait = 0
    logs = []
    epoch = start_epoch - 1
    for epoch in range(start_epoch, num_epochs + 1):
        beta = beta_target * min(1.0, epoch / warmup_epochs)
        gen = generator(device, seed, epoch)
        tr_m = train_epoch(Y_train, gen, beta, n_tb)
        va_m = (eval_epoch(Y_val, gen, beta, n_vb) if Y_val.shape[0] > 0
                else tr_m)
        values = torch.cat([tr_m, va_m]).tolist()  # the epoch's host read
        tr_v = dict(zip(COMPONENTS, values[:len(COMPONENTS)]))
        va_v = dict(zip(COMPONENTS, values[len(COMPONENTS):]))

        logs.append({"epoch": epoch, "beta": beta,
                     **{f"train_{k}": v for k, v in tr_v.items()},
                     **{f"val_{k}": v for k, v in va_v.items()}})

        improved = best_val_loss - va_v["loss"] > IMPROVEMENT_THRESHOLD
        if improved:
            best_val_loss = va_v["loss"]
            best_state = (*_snapshot(model, optimizer), epoch)

        # the reference's semantics (train.py:249-253): past min_epochs,
        # stop once `wait` reaches `patience` (0 stops right at min_epochs)
        wait += 1
        stop = epoch >= min_epochs and wait >= patience
        if _last_ckpt_due(epoch, start_epoch, num_epochs, ckpt_every, chunk,
                          stop):
            save(ckpt(epoch), last_ckpt)
        if stop:
            print(f"No improvement for {patience} epochs, stopping.")
            break
        if improved:
            wait = 0

    save(ckpt(epoch), last_ckpt)
    if best_state is not None:
        model_state, opt_state, b_epoch = best_state
        model.load_state_dict(model_state)
        optimizer.adamw.load_state_dict(opt_state)
        save(ckpt(b_epoch), best_ckpt)

    elapsed = time.time() - t_start
    print(f"Training completed in {elapsed:.2f} seconds.")

    if writer and not os.path.exists(best_ckpt):
        save(ckpt(num_epochs), best_ckpt)

    if writer:
        with open(os.path.join(outdir, "training_log.csv"), "w", newline="",
                  encoding="utf-8") as f:
            if logs:
                w = csv.DictWriter(f, fieldnames=list(logs[0]))
                w.writeheader()
                w.writerows(logs)
    return {"best_val_loss": best_val_loss, "epochs_ran": len(logs),
            "seconds": elapsed}
