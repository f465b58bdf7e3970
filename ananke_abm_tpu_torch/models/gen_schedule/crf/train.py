"""CRF training over frozen-VAE unaries (port of
``ananke_abm_tpu/models/gen_schedule/crf/train.py``).

AdamW (optax's defaults and ``weight_decay``, no clip) on the CRF NLL over
(U, Y) pairs; each epoch a permutation from a generator seeded by
``(seed, epoch)``, its remainder of rows dropped; the validation NLL over
the whole split; the best-by-val checkpoint holding {params, P, T,
home_idx}. The data lives on the device; one host read per epoch.

Under a mesh each batch's rows (and the validation split's) split over
the ``agents`` axis; the NLL means and the gradients are summed over the
``agents`` group, so every rank steps the single-device run's parameters.
Rank 0 writes the checkpoint.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gen_schedule.crf.model import (
    crf_nll_loss,
    init_crf_params,
)
from ananke_abm_tpu_torch.parallel.collectives import all_reduce_grads
from ananke_abm_tpu_torch.parallel.mesh import AGENT_AXIS, row_slice
from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator


def train_crf(cfg: dict, seed: int = 0, log_every: int | None = None,
              mesh=None, *, device="cuda", init: dict | None = None):
    """``cfg`` carries the reference crf_config.yaml's ``crf`` section keys:
    train_npz, val_npz, save_path, meta_json, num_epochs, batch_size, lr,
    weight_decay, log_every. ``init``: initial {"A", "bias"} arrays
    (default ``init_crf_params`` from ``seed``). ``mesh``: data-parallel
    over its ``agents`` axis (the module's notes); every rank returns the
    same dict. ``device``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    group = None if mesh is None else mesh.get_group(AGENT_AXIS)

    def local(x):
        """This rank's rows of ``x`` (all of them without a mesh)."""
        return x if mesh is None else x[row_slice(x.shape[0], mesh)]

    c = cfg["crf"] if "crf" in cfg else cfg
    with open(c["meta_json"], "r", encoding="utf-8") as f:
        crf_meta = json.load(f)
    home_idx = int(crf_meta.get("home_idx", -1))
    if home_idx < 0:
        raise ValueError("home_idx missing from crf_meta.json")

    def load(path):
        with np.load(path) as d:
            return (torch.as_tensor(d["U"], dtype=torch.float32).to(device),
                    torch.as_tensor(d["Y"]).long().to(device))

    U_train, Y_train = load(c["train_npz"])
    U_val, Y_val = load(c["val_npz"])
    _, T, P = U_train.shape

    batch_size = int(min(int(c["batch_size"]), U_train.shape[0]))
    num_epochs = int(c["num_epochs"])
    log_every = int(c.get("log_every", 10)) if log_every is None else log_every

    if init is None:
        params = init_crf_params(generator(device, seed), P)
    else:
        params = {k: torch.tensor(np.asarray(v), dtype=torch.float32
                                     ).to(device) for k, v in init.items()}
    for v in params.values():
        v.requires_grad_(True)
    optimizer = torch.optim.AdamW(
        list(params.values()), lr=float(c["lr"]), betas=(0.9, 0.999),
        eps=1e-8, weight_decay=float(c.get("weight_decay", 0.0)))

    n_tb = max(1, U_train.shape[0] // batch_size)  # drop the remainder

    def train_epoch(gen):
        perm = torch.randperm(U_train.shape[0], generator=gen, device=device)
        losses = []
        for i in range(n_tb):
            bidx = local(perm[i * batch_size:(i + 1) * batch_size])
            optimizer.zero_grad(set_to_none=True)
            loss = crf_nll_loss(params, U_train[bidx], Y_train[bidx], group)
            loss.backward()
            if group is not None:
                all_reduce_grads(list(params.values()), group)
            optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    save_path = c["save_path"]
    d = os.path.dirname(save_path)
    if d:
        os.makedirs(d, exist_ok=True)

    best_val = None
    t0 = time.time()
    for epoch in range(1, num_epochs + 1):
        tr_loss = train_epoch(generator(device, seed, epoch))
        with torch.no_grad():
            va_loss = (crf_nll_loss(params, local(U_val), local(Y_val),
                                    group)
                       if U_val.shape[0] else tr_loss)
        tr_v, mean_val = torch.stack([tr_loss, va_loss]).tolist()

        if epoch % log_every == 0 or epoch in (1, num_epochs):
            print(json.dumps({"epoch": epoch, "train_nll": tr_v,
                              "val_nll": mean_val}))
        if best_val is None or mean_val < best_val:
            best_val = mean_val
            if group is None or torch.distributed.get_rank() == 0:
                save_checkpoint(
                    {"params": {k: v.detach() for k, v in params.items()},
                     "P": P, "T": T, "home_idx": home_idx},
                    save_path,
                )
    print(f"Training CRF completed in {time.time() - t0:.2f} seconds.")
    print(f"Saved best CRF to {save_path} with val_nll={best_val:.4f}")
    return {"best_val_nll": best_val}
