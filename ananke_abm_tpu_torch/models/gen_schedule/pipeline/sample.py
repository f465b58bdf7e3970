"""Population sampling from a trained schedule VAE (port of
``ananke_abm_tpu/models/gen_schedule/pipeline/sample.py``).

Artifacts: ``<prefix>.npz`` {Y_generated (N, T) int64, U_mean_logits
(T, P) f32, U_std_logits (T, P) f32, Z_stats (2, z_dim) f32},
``<prefix>_meta.json``, ``<prefix>_preview.csv`` (persid, stopno,
purpose, starttime, total_duration segments).

Each chunk (z ~ N(0, I) -> decode -> argmax or CRF Viterbi -> all-home
mask -> the chunk's masked count / mean / M2 and latent sums) has a fixed
shape on the device; rejection never changes a device shape. The chunk
summaries are float32 on the device; their merge (Chan's parallel
Welford update) is float64 on the host.

Under a mesh the chunk is rounded up to a multiple of the ``agents`` axis
and every rank draws the whole chunk's z from the same generator and keeps
its rows; the ids, the kept rows and each rank's summaries are gathered,
and the summaries merged in rank order. Rank 0 writes the artifacts.
"""
from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gen_schedule.crf.model import crf_decode
from ananke_abm_tpu_torch.models.gen_schedule.factory import build_model
from ananke_abm_tpu_torch.models.gen_schedule.params import load_flax_params
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator

DEFAULT_CHUNK = 1024


def decode_person_to_segments(seq_row, person_id, grid_minutes, inv_map):
    """One generated timeline -> activity segments (host side, preview)."""
    seq = np.asarray(seq_row)
    change = np.nonzero(np.diff(seq))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(seq)]])
    return [
        {
            "persid": person_id,
            "stopno": i,
            "purpose": inv_map[int(seq[s])],
            "starttime": int(s * grid_minutes),
            "total_duration": int((e - s) * grid_minutes),
        }
        for i, (s, e) in enumerate(zip(starts, ends))
    ]


def _merge_welford(count, mean, m2, c_count, c_mean, c_m2):
    """Chan et al. parallel combine of (count, mean, M2) summaries."""
    if c_count == 0:
        return count, mean, m2
    if count == 0:
        return c_count, c_mean, c_m2
    delta = c_mean - mean
    tot = count + c_count
    new_mean = mean + delta * (c_count / tot)
    new_m2 = m2 + c_m2 + delta * delta * (count * c_count / tot)
    return tot, new_mean, new_m2


def load_vae(obj: dict, device):
    """(model in eval mode, pds_features or None) from a VAE checkpoint
    dict of either package."""
    model, pds = build_model(obj["cfg"], obj["meta"], device=device)
    load_flax_params(model, obj["params"], obj.get("batch_stats"))
    return model.eval(), pds


def make_chunk_fn(model, pds, decode_mode="argmax", crf_params=None,
                  home_idx=None, enforce_nonhome=False,
                  reject_all_home=False):
    """``chunk(z) -> (y, keep, cnt, mean, m2, z_sum, z_sq)`` on the
    device: decode ids (B, T), the kept rows, and the kept rows' logits
    count, mean and M2 (T, P) and latent sums (z_dim,)."""

    @torch.inference_mode()
    def chunk(z):
        u = model.decode(z, pds)  # (B, T, P)
        if decode_mode == "crf":
            y = crf_decode(crf_params, u, home_idx=home_idx,
                           enforce_nonhome=enforce_nonhome)
        else:
            y = torch.argmax(u, dim=-1).to(torch.int32)
        if reject_all_home and home_idx is not None:
            keep = (y != home_idx).any(dim=1)
        else:
            keep = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
        w = keep.to(torch.float32)
        cnt = w.sum()
        mean = torch.einsum("b,btp->tp", w, u) / torch.clamp(cnt, min=1.0)
        m2 = torch.einsum("b,btp->tp", w, (u - mean[None]) ** 2)
        return (y, keep, cnt, mean, m2, (z * w[:, None]).sum(0),
                (z**2 * w[:, None]).sum(0))

    return chunk


def sample(
    ckpt_path: str,
    num_samples: int,
    outprefix: str,
    seed: int = 123,
    csv_max_persons: int = 200,
    decode_mode: str = "argmax",
    crf_path: str | None = None,
    enforce_nonhome: bool = False,
    reject_all_home: bool = False,
    chunk_size: int | None = None,
    mesh=None,
    *,
    device="cuda",
):
    """The reference's ``sample()``: same arguments, artifacts and meta
    keys. Chunks of DEFAULT_CHUNK, or 8192 past 16,384 samples; z from a
    generator seeded by ``seed``. ``mesh``: the chunks' rows split over its
    ``agents`` axis (the module's notes); every rank returns the same dict.
    ``device``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    obj = load_checkpoint(ckpt_path)
    cfg, meta = obj["cfg"], obj["meta"]
    purpose_map = meta["purpose_map"]
    inv_map = {v: k for k, v in purpose_map.items()}
    names_ordered = [inv_map[i] for i in range(len(inv_map))]
    grid_min = meta["grid_min"]
    horizon_min = meta["horizon_min"]
    T = meta["L"]
    z_dim = cfg["model"]["z_dim"]
    P = len(purpose_map)
    home_idx = purpose_map.get("Home")

    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK if num_samples <= 16384 else 8192
    CHUNK = int(chunk_size)
    rows = agents = None
    if mesh is not None:
        from ananke_abm_tpu_torch.parallel.mesh import (
            AGENT_AXIS,
            axis_size,
            row_slice,
        )

        n_agent = axis_size(mesh, AGENT_AXIS)
        CHUNK = -(-CHUNK // n_agent) * n_agent
        rows, agents = row_slice(CHUNK, mesh), mesh.get_group(AGENT_AXIS)

    t0 = time.time()
    model, pds = load_vae(obj, device)

    crf_params = None
    if decode_mode == "crf":
        if not crf_path:
            raise ValueError("decode_mode='crf' requires crf_path")
        crf_obj = load_checkpoint(crf_path)
        crf_home = crf_obj.get("home_idx")
        if crf_home != home_idx:
            raise AssertionError(
                f"CRF home_idx {crf_home} != VAE home_idx {home_idx}"
            )
        crf_params = {k: torch.tensor(np.asarray(v), dtype=torch.float32
                                         ).to(device)
                      for k, v in crf_obj["params"].items()}
    elif decode_mode != "argmax":
        raise ValueError(f"Unknown decode_mode: {decode_mode}")

    chunk_fn = make_chunk_fn(model, pds, decode_mode, crf_params, home_idx,
                             enforce_nonhome, reject_all_home)
    gen = generator(device, seed)
    ids_dtype = torch.uint8 if P <= 256 else torch.int32
    accepted = []
    W_count, W_mean, W_m2 = 0, np.zeros((T, P)), np.zeros((T, P))
    z_sum = np.zeros(z_dim)
    z_sq = np.zeros(z_dim)
    z_n = 0
    remaining = num_samples
    while remaining > 0:
        z = torch.randn((CHUNK, z_dim), generator=gen, device=device)
        if rows is not None:
            z = z[rows]
        y, keep, cnt, mean, m2, zs, zq = chunk_fn(z)
        summ = torch.cat([cnt[None], mean.reshape(-1), m2.reshape(-1), zs,
                          zq])[None]
        if agents is not None:
            from ananke_abm_tpu_torch.parallel.collectives import gather_rows

            y = gather_rows(y, CHUNK, agents)
            keep = gather_rows(keep.to(torch.uint8), CHUNK, agents).bool()
            summ = gather_rows(summ, summ.shape[0] * n_agent, agents)
        # the chunk's host read: its kept ids (one byte each) and summaries
        keep_np = keep.cpu().numpy()
        n_keep = int(keep_np.sum())
        if n_keep == 0:
            continue
        y_keep = y.to(ids_dtype).cpu().numpy()[keep_np]
        take = min(n_keep, remaining)
        accepted.append(y_keep[:take])

        # merge full-chunk stats (acceptance stats use all accepted rows of
        # the chunk, as the reference's do); one summary a rank
        for part in summ.double().cpu().numpy():
            c_mean, c_m2, zs, zq = np.split(
                part[1:], np.cumsum([T * P, T * P, z_dim]))
            W_count, W_mean, W_m2 = _merge_welford(
                W_count, W_mean, W_m2, int(part[0]), c_mean.reshape(T, P),
                c_m2.reshape(T, P))
            z_sum += zs
            z_sq += zq
        z_n += n_keep
        remaining -= take

    Y_gen = np.concatenate(accepted, axis=0)[:num_samples].astype(np.int64)

    if W_count > 1:
        U_mean = W_mean
        U_std = np.sqrt(np.maximum(W_m2 / (W_count - 1), 0.0))
    else:
        U_mean = W_mean if W_count else np.zeros((T, P))
        U_std = np.zeros((T, P))

    z_mean = z_sum / max(1, z_n)
    z_var = z_sq / max(1, z_n) - z_mean**2
    Z_stats = np.stack(
        [z_mean, np.sqrt(np.maximum(z_var, 1e-12))], axis=0
    ).astype(np.float32)

    elapsed = time.time() - t0
    print(f"[sample:{decode_mode}] Sampling completed in {elapsed:.2f} seconds.")
    if agents is not None and torch.distributed.get_rank() != 0:
        return {"seconds": elapsed, "generated": int(Y_gen.shape[0])}

    d = os.path.dirname(outprefix)
    if d:
        os.makedirs(d, exist_ok=True)

    rows = []
    for i in range(min(csv_max_persons, Y_gen.shape[0])):
        rows.extend(decode_person_to_segments(
            Y_gen[i], f"gen_{i:06d}", grid_min, inv_map))
    with open(f"{outprefix}_preview.csv", "w", newline="",
              encoding="utf-8") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["persid", "stopno", "purpose", "starttime",
                        "total_duration"],
        )
        w.writeheader()
        w.writerows(rows)

    np.savez_compressed(
        f"{outprefix}.npz",
        Y_generated=Y_gen,
        U_mean_logits=U_mean.astype(np.float32),
        U_std_logits=U_std.astype(np.float32),
        Z_stats=Z_stats,
    )

    meta_out = {
        "purpose_map": purpose_map,
        "purpose_names_ordered": names_ordered,
        "grid_min": grid_min,
        "horizon_min": horizon_min,
        "num_time_bins": T,
        "latent_dim": z_dim,
        "num_samples": int(num_samples),
        "seed": int(seed),
        "vae_ckpt": ckpt_path,
        "decode_mode": decode_mode,
        "crf_path": crf_path,
        "pds_method": cfg["model"].get("method", "auto_pds"),
        "reject_all_home": bool(reject_all_home),
    }
    with open(f"{outprefix}_meta.json", "w", encoding="utf-8") as f:
        json.dump(meta_out, f, indent=2)
    return {"seconds": elapsed, "generated": int(Y_gen.shape[0])}
