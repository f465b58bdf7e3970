"""Freeze a trained VAE and dump (U logits, Y labels) pairs for CRF
training (port of ``ananke_abm_tpu/models/gen_schedule/crf/prepare.py``).

Artifacts: ``crf_train.npz`` / ``crf_val.npz`` each holding U (N, T, P)
float32 and Y (N, T) int64, and ``crf_meta.json`` (P, L, purpose_map,
grid info, home_idx, provenance). The forward pass is a whole VAE pass on
the labels in eval mode: encode -> reparameterised z -> decode.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gen_schedule.pipeline.sample import load_vae
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator


def prepare_crf_data(
    vae_ckpt: str,
    splits_path: str,
    outdir: str,
    batch_size: int = 1024,
    seed: int = 0,
    *,
    device="cuda",
):
    """The reference's ``prepare_crf_data``: same files and keys; z's noise
    from a generator seeded by ``seed``. ``device``: the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    obj = load_checkpoint(vae_ckpt)
    cfg, meta = obj["cfg"], obj["meta"]
    P, L = len(meta["purpose_map"]), meta["L"]
    model, pds = load_vae(obj, device)

    with np.load(cfg["data"]["npz"]) as grid:
        Y_all = grid["Y"].astype(np.int64)
    with np.load(splits_path) as splits:
        parts = {"train": splits["train_idx"], "val": splits["val_idx"]}
    gen = generator(device, seed)

    @torch.inference_mode()
    def unaries(Y):
        out = []
        for s in range(0, Y.shape[0], batch_size):
            batch = torch.as_tensor(Y[s:s + batch_size]).to(device)
            logits, _, _ = model(batch, gen, pds)
            out.append(logits.cpu())
        if not out:
            return np.zeros((0, L, P), np.float32)
        return torch.cat(out).numpy()

    for tag, idx in parts.items():
        Y = Y_all[idx]
        np.savez_compressed(
            os.path.join(outdir, f"crf_{tag}.npz"),
            U=unaries(Y).astype(np.float32),
            Y=Y.astype(np.int64),
        )

    purpose_map = meta["purpose_map"]
    if "Home" not in purpose_map:
        raise ValueError("Purpose map does not contain 'Home'.")
    meta_out = {
        "P": P,
        "L": L,
        "purpose_map": purpose_map,
        "grid_min": meta["grid_min"],
        "horizon_min": meta["horizon_min"],
        "vae_ckpt": vae_ckpt,
        "splits": splits_path,
        "home_idx": int(purpose_map["Home"]),
    }
    with open(os.path.join(outdir, "crf_meta.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta_out, f, indent=2)
    return meta_out
