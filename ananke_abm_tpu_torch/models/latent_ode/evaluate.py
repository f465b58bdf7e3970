"""latent_ode evaluation: loss-component curves and stochastic rollouts
against the ground truth (port of
``ananke_abm_tpu/models/latent_ode/evaluate.py``). matplotlib is imported
only inside the plotting branches; where it is missing they warn."""
from __future__ import annotations

import json
import os

import numpy as np

from ananke_abm_tpu_torch.models.latent_ode.data import get_person_sample
from ananke_abm_tpu_torch.models.latent_ode.inference import BatchedInferenceEngine


def evaluate(
    ckpt_path: str,
    outdir: str,
    person_ids=(1, 2),
    num_samples: int = 3,
    num_eval_points: int = 500,
    make_plots: bool = True,
    *,
    device="cuda",
) -> dict:
    """Zone and purpose accuracy at the ground truth's event times (the
    majority over ``num_samples`` rollouts on ``num_eval_points`` times),
    ``eval_metrics.json``, and the rollout and loss plots."""
    os.makedirs(outdir, exist_ok=True)
    engine = BatchedInferenceEngine(ckpt_path, person_ids, device=device)

    times = np.linspace(0.0, 24.0, num_eval_points).astype(np.float32)
    preds = engine.predict_trajectories(num_samples=num_samples, times=times)

    # agreement at GT event times (nearest eval point), majority over samples
    metrics = {"persons": {}}
    for i, pid in enumerate(person_ids):
        s = get_person_sample(pid, engine.config)
        nearest = np.searchsorted(times, s["times"]).clip(0, len(times) - 1)
        zones = preds["zones"][i][:, nearest]  # (S, events)
        maj = np.apply_along_axis(
            lambda x: np.bincount(x, minlength=1).argmax(), 0, zones
        )
        acc = float((maj == s["trajectory_y"]).mean())
        purp = preds["purposes"][i][:, nearest]
        maj_p = np.apply_along_axis(
            lambda x: np.bincount(x, minlength=1).argmax(), 0, purp
        )
        acc_p = float((maj_p == s["target_purpose_ids"]).mean())
        metrics["persons"][s["person_name"]] = {
            "zone_accuracy": acc,
            "purpose_accuracy": acc_p,
            "n_events": int(len(s["times"])),
        }

    # per-person stochastic rollouts vs ground truth (zone/purpose/mode
    # subplots)
    if make_plots:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for i, pid in enumerate(person_ids):
                s = get_person_sample(pid, engine.config)
                fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
                panels = (
                    ("zone", preds["zones"][i], s["times"], s["trajectory_y"]),
                    ("purpose", preds["purposes"][i], s["times"],
                     s["target_purpose_ids"]),
                    ("mode", preds["modes"][i], s["times"], s["target_mode_ids"]),
                )
                for ax, (name, samples_arr, gt_t, gt_v) in zip(axes, panels):
                    for k in range(samples_arr.shape[0]):
                        ax.step(times, samples_arr[k], where="post",
                                alpha=0.5, lw=0.9,
                                label="sample" if k == 0 else None)
                    ax.scatter(gt_t, gt_v, color="black", s=22, zorder=3,
                               label="ground truth")
                    ax.set_ylabel(name)
                    ax.legend(fontsize=7, loc="upper right")
                axes[-1].set_xlabel("hour of day")
                fig.suptitle(f"{s['person_name']}: stochastic rollouts vs GT")
                fig.tight_layout()
                fig.savefig(
                    os.path.join(outdir, f"rollout_{s['person_name']}.png"),
                    dpi=110,
                )
                plt.close(fig)
        except ImportError as e:
            import warnings

            warnings.warn(f"rollout plots skipped (matplotlib missing): {e}")

    # loss-history plot if available
    hist_path = os.path.join(os.path.dirname(ckpt_path), "loss_history.npz")
    if make_plots and os.path.exists(hist_path):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            hist = np.load(hist_path)
            fig, ax = plt.subplots(figsize=(9, 5))
            for k in hist.files:
                ax.plot(np.maximum(hist[k], 1e-9), label=k)
            ax.set_yscale("log")
            ax.set_xlabel("iteration")
            ax.set_ylabel("loss")
            ax.legend(fontsize=7)
            fig.tight_layout()
            fig.savefig(os.path.join(outdir, "loss_components.png"), dpi=100)
            plt.close(fig)
            metrics["loss_plot"] = os.path.join(outdir, "loss_components.png")
        except ImportError as e:
            import warnings

            warnings.warn(f"loss plot skipped (matplotlib missing): {e}")

    with open(os.path.join(outdir, "eval_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics
