"""The VAE-only variant of the traj_syn pipeline (port of
``ananke_abm_tpu/models/traj_syn/pipeline/vae_only.py``): train_vae_only /
synthesize_vae / analyze_vae at 5-minute steps over the 1800-minute
allocation horizon."""
from __future__ import annotations

import json
import os

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.evals.metrics import (
    minutes_share,
    tod_marginals,
)
from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
    train_vae_only,  # re-export
)
from ananke_abm_tpu_torch.models.traj_syn.pipeline.validate import (
    generate_trajectories,
)

__all__ = ["train_vae_only", "synthesize_vae", "analyze_vae"]


def synthesize_vae(ckpt_path: str, num_gen: int, out_npz: str,
                   seed: int = 0, *, device="cuda"):
    """Prior samples decoded WITHOUT the CRF head (the VAE's argmax)."""
    Y, meta = generate_trajectories(ckpt_path, num_gen, seed=seed,
                                    use_samples=True, crf_mode="none",
                                    device=device)
    d = os.path.dirname(out_npz)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(out_npz, Y_generated=Y.astype(np.int64))
    with open(out_npz.replace(".npz", "_meta.json"), "w",
              encoding="utf-8") as f:
        json.dump({"purpose_map": meta["purpose_map"],
                   "grid_min": meta["grid_min"],
                   "horizon_min": meta["horizon_min"],
                   "L": meta["L"],
                   "num_samples": int(num_gen)}, f, indent=2)
    return out_npz


def analyze_vae(samples_npz: str, out_json: str):
    """Summary statistics of a synthesized population."""
    with np.load(samples_npz) as arr:
        Y = arr["Y_generated"].astype(np.int64)
    with open(samples_npz.replace(".npz", "_meta.json"), "r",
              encoding="utf-8") as f:
        meta = json.load(f)
    P = len(meta["purpose_map"])
    share = minutes_share(Y, P)
    tod = tod_marginals(Y, P)
    inv = {v: k for k, v in meta["purpose_map"].items()}
    out = {
        "N": int(Y.shape[0]),
        "L": int(Y.shape[1]),
        "minutes_share": {inv[p]: float(share[p]) for p in range(P)},
        "peak_share_time_bin": {
            inv[p]: int(np.argmax(tod[:, p])) for p in range(P)
        },
        "unique_schedules": int(np.unique(Y, axis=0).shape[0]),
    }
    d = os.path.dirname(out_json)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
    return out
