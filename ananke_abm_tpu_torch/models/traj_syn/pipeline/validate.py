"""Generate and validate trajectories from a trained TrajEmbed checkpoint
(port of ``ananke_abm_tpu/models/traj_syn/pipeline/validate.py``).

Load a checkpoint (written by either package) -> generate ``num_gen``
trajectories in chunks of CHUNK -> decode (argmax, the linear CRF, or
the semi-CRF under the Dmax cap) -> the segment-format activities CSV
(read back by the buffer-grid visualizer) -> a validation summary JSON
against a held-out activities CSV at ``eval_step_minutes`` resolution.
The latents of chunk i come from a generator seeded by ``(seed, i)``.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    segments_run_length_fast,
)
from ananke_abm_tpu_torch.models.gen_schedule.evals.report import make_report
from ananke_abm_tpu_torch.models.traj_syn.configs import TrajEmbedConfig
from ananke_abm_tpu_torch.models.traj_syn.model import (
    TrajEmbedVAE,
    load_flax_params,
)
from ananke_abm_tpu_torch.ops.crf import (
    viterbi_decode,
    viterbi_decode_no_all_home,
)
from ananke_abm_tpu_torch.ops.semi_crf import semicrf_decode
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator
from ananke_abm_tpu_torch.utils.traj_fig.make_buffer_grid import (
    make_buffer_grid,
)

CHUNK = 512


def load_generator(ckpt_path: str, crf_mode: str | None = None,
                   semi_Dmax_minutes: int | None = None,
                   enforce_nonhome: bool = False, *, device="cuda"):
    """(decode_chunk, z_dim, meta): ``decode_chunk(z)`` maps latents (B,
    z_dim) on ``device`` to (B, L) int32 labels in the checkpoint's (or
    the given) decode mode."""
    device = resolve_device(device)
    obj = load_checkpoint(ckpt_path)
    cfg = TrajEmbedConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in obj["cfg"].items()})
    meta = obj["meta"]
    purpose_map = meta["purpose_map"]
    P, L = len(purpose_map), meta["L"]
    purpose_feats = torch.as_tensor(np.asarray(obj["purpose_feats"]),
                                    dtype=torch.float32).to(device)
    model = TrajEmbedVAE(L, P, cfg.z_dim, cfg.emb_dim, cfg.cnn_channels,
                         cfg.cnn_kernel, cfg.cnn_dropout,
                         purpose_feats.shape[1]).to(device).eval()
    load_flax_params(model, obj["params"])
    crf_cfg = obj.get("crf_cfg", {})
    mode = crf_mode or crf_cfg.get("crf_mode", "linear")
    dmax_min = semi_Dmax_minutes or crf_cfg.get("semi_Dmax_minutes", 300)
    dmax_bins = max(1, dmax_min // meta["grid_min"])
    cp = obj.get("crf_params")
    if cp is not None:
        cp = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32
                                 ).to(device) for k, v in cp.items()}
    # default False: checkpoints saved before exact_long existed were
    # trained with the self-transition diagonal masked out
    allow_self = bool(crf_cfg.get("exact_long", False))

    @torch.no_grad()
    def decode_chunk(z):
        logits = model.decode(z, purpose_feats)
        if cp is None or mode == "none":
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if mode == "semi":
            dur = cp["dur"][:, :dmax_bins]
            pad = dmax_bins - dur.shape[1]
            if pad > 0:
                dur = torch.nn.functional.pad(dur, (0, pad), value=-1e9)
            return semicrf_decode(logits, dur, cp["A"], allow_self=allow_self)
        u = logits + cp.get("bias", torch.zeros(P, device=device))[None, None]
        if enforce_nonhome and "Home" in purpose_map:
            return viterbi_decode_no_all_home(u, cp["A"], purpose_map["Home"])
        return viterbi_decode(u, cp["A"])

    return decode_chunk, cfg.z_dim, meta


def generate_trajectories(
    ckpt_path: str,
    num_gen: int,
    seed: int = 0,
    use_samples: bool = True,
    crf_mode: str | None = None,
    semi_Dmax_minutes: int | None = None,
    enforce_nonhome: bool = False,
    *,
    device="cuda",
    z=None,
):
    """Returns (Y (num_gen, L) int64 labels, meta dict). ``z``: optional
    (>= num_gen, z_dim) latents replacing the draws (tests pass the
    reference's), read in chunks of CHUNK. ``device``: the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    decode_chunk, z_dim, meta = load_generator(
        ckpt_path, crf_mode, semi_Dmax_minutes, enforce_nonhome,
        device=device)
    outs, got, i = [], 0, 0
    while got < num_gen:
        if z is not None:
            zc = torch.as_tensor(np.asarray(z[i * CHUNK:(i + 1) * CHUNK]),
                                 dtype=torch.float32).to(device)
        elif use_samples:
            zc = torch.randn((CHUNK, z_dim), device=device,
                             generator=generator(device, seed, i))
        else:
            zc = torch.zeros((CHUNK, z_dim), device=device)
        y = decode_chunk(zc).cpu().numpy()
        outs.append(y)
        got += y.shape[0]
        i += 1
    Y = np.concatenate(outs, axis=0)[:num_gen].astype(np.int64)
    return Y, meta


def write_segments_csv(Y, gen_csv, grid_min, inv_map):
    """The whole population's segment CSV from one run-length pass (the
    native host kernel where built) and vectorised columns, in the
    reference sample.py writer's schema and row order. Returns the
    segmentation (person, purpose, length)."""
    d = os.path.dirname(gen_csv)
    if d:
        os.makedirs(d, exist_ok=True)
    person, purpose, length = segments_run_length_fast(Y)
    # every row spans exactly T bins, so the global segment-length cumsum
    # at person p's first segment is p*T
    start_bin = (np.cumsum(length) - length) - person * Y.shape[1]
    first_seg = np.flatnonzero(
        np.r_[True, person[1:] != person[:-1]]
    ) if person.size else np.zeros(0, np.int64)
    seg_per_person = np.diff(np.r_[first_seg, person.size])
    stopno = np.arange(person.size) - np.repeat(first_seg, seg_per_person)
    name_table = np.array(
        [inv_map.get(i, str(i)) for i in range(max(inv_map) + 1)],
        dtype=object)
    persid = np.char.add("gen_", np.char.zfill(person.astype("U12"), 6))
    with open(gen_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["persid", "stopno", "purpose", "starttime",
                    "total_duration"])
        w.writerows(zip(persid.tolist(), stopno.tolist(),
                        name_table[purpose].tolist(),
                        (start_bin * grid_min).tolist(),
                        (length * grid_min).tolist()))
    return person, purpose, length


def gen_n_val_traj(
    ckpt_path: str,
    num_gen: int,
    gen_csv: str,
    val_csv: str | None = None,
    eval_step_minutes: int = 5,
    crf_mode: str | None = None,
    semi_Dmax_minutes: int = 300,
    summary_json: str | None = None,
    use_samples: bool = True,
    seed: int = 0,
    *,
    device="cuda",
):
    """Generate -> write the segment CSV -> validate -> summary JSON."""
    Y, meta = generate_trajectories(
        ckpt_path, num_gen, seed=seed, use_samples=use_samples,
        crf_mode=crf_mode, semi_Dmax_minutes=semi_Dmax_minutes,
        device=device)
    inv_map = {v: k for k, v in meta["purpose_map"].items()}
    grid_min = meta["grid_min"]
    person, purpose, length = write_segments_csv(Y, gen_csv, grid_min,
                                                 inv_map)
    summary = {
        "num_gen": int(num_gen),
        "ckpt": ckpt_path,
        "gen_csv": gen_csv,
        "crf_mode": crf_mode,
        "semi_Dmax_minutes": semi_Dmax_minutes,
        "use_samples": bool(use_samples),
    }
    if val_csv and os.path.exists(val_csv):
        # rasterize the validation activities onto the SAME grid; the
        # evaluation can run at a coarser step: subsample both grids
        Y_val, _, _ = make_buffer_grid(val_csv, grid_min=grid_min,
                                       horizon_min=meta["horizon_min"])
        stride = max(1, eval_step_minutes // grid_min)
        summary["validation"] = make_report(
            Y[:, ::stride], Y_val[:, ::stride], meta["purpose_map"])
    # duration statistics of the generated population (the segmentation
    # of the CSV write)
    summary["generated_stats"] = {
        "mean_segments_per_person": float(len(purpose) / max(Y.shape[0], 1)),
        "max_segment_minutes": int(length.max() * grid_min)
        if length.size else 0,
        "mean_segment_minutes": float(length.mean() * grid_min)
        if length.size else 0.0,
    }
    if summary_json:
        d = os.path.dirname(summary_json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(summary_json, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
    return summary
