"""mode_sep inference (port of
``ananke_abm_tpu/models/mode_sep/inference.py``, no pandas): every person
rolled out over the union grid, the predictions at the ground-truth snaps
(``predictions.csv``: gt / predicted zone, distance, match, written as
``DataFrame.to_csv(index=False)`` writes them), and a dense [0, 24] h x
``dense_resolution`` rollout (``dense_rollout.npz``) with a trajectory
plot a person where matplotlib is installed.
"""
from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.mode_sep.batching import build_union_batch
from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig
from ananke_abm_tpu_torch.models.mode_sep.data import load_trajectory_csvs
from ananke_abm_tpu_torch.models.mode_sep.model import (
    ModeSepModel,
    load_flax_params,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator as make_generator

PREDICTION_COLUMNS = ("person_id", "time", "gt_zone", "pred_zone",
                      "distance_km", "match")


def _cfg_from_dict(d: dict) -> ModeSepConfig:
    fields = {f.name for f in dataclasses.fields(ModeSepConfig)}
    return ModeSepConfig(**{k: v for k, v in d.items() if k in fields})


def load_model(ckpt_path: str, *, device="cuda"):
    """(model on ``device`` in eval mode, config, the checkpoint dict) of a
    checkpoint of either package."""
    device = resolve_device(device)
    obj = load_checkpoint(ckpt_path)
    config = _cfg_from_dict(obj["config"])
    model = ModeSepModel(int(obj["Z"]), config).to(device)
    load_flax_params(model, obj["params"])
    return model.eval(), config, obj


def rollout(model, config, times, home_idx, work_idx, traits,
            generator=None, noise=None):
    """The batched forward without gradients: (pred_emb, logits, v) as
    numpy. The SDE's draws come from ``generator`` (default: seed 0) or
    ``noise``."""
    dev = model.class_table.device
    if generator is None:
        generator = make_generator(dev, 0)
    on = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)
    with torch.inference_mode():
        pred_emb, logits, v = model(
            np.asarray(times, np.float32), on(home_idx, torch.long),
            on(work_idx, torch.long), on(traits, torch.float32),
            generator, noise)
    return pred_emb.cpu().numpy(), logits.cpu().numpy(), v.cpu().numpy()


def _cell(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def write_predictions(rows: list, path: str) -> None:
    """Prediction records as ``pd.DataFrame(rows).to_csv(index=False)``
    writes them (floats by repr; no rows: an empty line)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(PREDICTION_COLUMNS)
        for r in rows:
            w.writerow([_cell(r[k]) for k in PREDICTION_COLUMNS])


def run_inference(
    ckpt_path: str,
    periods_csv: str,
    snaps_csv: str,
    outdir: str,
    zones_csv: str | None = None,
    persons_csv: str | None = None,
    dist_mat_csv: str | None = None,
    *,
    device="cuda",
) -> dict:
    """Write ``predictions.csv``, ``dense_rollout.npz`` and the plots;
    return the predictions as {column: numpy array}, in row order."""
    os.makedirs(outdir, exist_ok=True)
    model, config, _ = load_model(ckpt_path, device=device)
    people, shared = load_trajectory_csvs(
        periods_csv, snaps_csv, zones_csv, persons_csv, dist_mat_csv)
    union = build_union_batch(people, config.K_internal,
                              config.time_match_tol)

    _, logits, v = rollout(model, config, union.times_union, union.home_idx,
                           union.work_idx, union.traits)
    pred = logits.argmax(-1)  # (B, T)

    rows = []
    for i, p in enumerate(people):
        for j in np.nonzero(union.is_gt[i])[0]:
            gt_z = int(union.y_union[i, j])
            pd_z = int(pred[i, j])
            rows.append({
                "person_id": p.person_id,
                "time": float(union.times_union[j]),
                "gt_zone": shared.zone_names[gt_z],
                "pred_zone": shared.zone_names[pd_z],
                "distance_km": float(shared.dist_mat[gt_z, pd_z]),
                "match": int(gt_z == pd_z),
            })
    write_predictions(rows, os.path.join(outdir, "predictions.csv"))

    dense_times = np.linspace(0.0, 24.0, config.dense_resolution).astype(
        np.float32)
    emb_d, logits_d, v_d = rollout(model, config, dense_times,
                                   union.home_idx, union.work_idx,
                                   union.traits)
    np.savez_compressed(
        os.path.join(outdir, "dense_rollout.npz"),
        times=dense_times,
        logits=logits_d,
        velocity=v_d,
        pred_emb=emb_d,
        person_ids=np.array([p.person_id for p in people]),
    )

    try:
        from ananke_abm_tpu_torch.models.mode_sep.viz import (
            plot_person_trajectory,
        )

        table = model.class_table.detach().cpu().numpy()
        for i, p in enumerate(people):
            v_abs = np.linalg.norm(v_d[i], axis=-1)
            emb_dist = np.linalg.norm(
                emb_d[i][:, None, :] - table[None, :, :], axis=-1).min(-1)
            plot_person_trajectory(
                dense_times,
                logits_d[i].argmax(-1),
                shared.zone_names,
                os.path.join(outdir, f"trajectory_{p.person_name}.png"),
                v_abs=v_abs,
                emb_dist=emb_dist,
                stay_intervals=p.stay_segments,
                tau_stay=config.tau_stay_embed,
                v_band=(config.v_min_move, config.v_max_move),
                title=f"{p.person_name} dense rollout",
            )
    except ImportError as e:
        import warnings

        warnings.warn(f"trajectory plots skipped (matplotlib missing): {e}")

    return {
        "person_id": np.array([r["person_id"] for r in rows], np.int64),
        "time": np.array([r["time"] for r in rows], np.float64),
        "gt_zone": np.array([r["gt_zone"] for r in rows], dtype=object),
        "pred_zone": np.array([r["pred_zone"] for r in rows], dtype=object),
        "distance_km": np.array([r["distance_km"] for r in rows],
                                np.float64),
        "match": np.array([r["match"] for r in rows], np.int64),
    }
