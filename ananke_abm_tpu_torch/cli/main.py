"""``ananke``: the port's main command line (the counterpart of the JAX
package's click group ``ananke_abm_tpu/cli/main.py``).

    python -m ananke_abm_tpu_torch.cli.main <command> [options]

The reference's seven commands (traj-embed, gval-traj,
visualize-combined-traj, make-purposes, gatode-train, gatode-serve, info)
with the same option strings, defaults, flags and printed lines, on
``argparse``. An error exits non-zero with its message.

Commands run on the card; ``ANANKE_PLATFORM=cpu`` asks for the CPU
(``cli/__init__.py::platform_device``). ``traj-embed --data-parallel``
hands the trainer a mesh over the ranks ``torchrun`` starts
(``cli/__init__.py::_mesh``); ``gatode-train --data-parallel`` starts the
same process group and is ``train(data_parallel=True)``. A process that
runs alone takes the single-card step, as the reference does on one
device.
``gatode-serve --use-pallas {auto,on,off}`` is ``serve(use_kernel=)``: the
serving kernel K1 where "on".
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os

from ananke_abm_tpu_torch.cli import (
    _existing,
    _mesh,
    finish,
    platform_device,
)


def traj_embed(args):
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
        train_traj_embed,
    )

    res = train_traj_embed(
        args.activities_csv, args.purposes_csv, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, val_ratio=args.val_ratio,
        outdir=args.outdir, crf_mode=args.crf_mode, seed=args.seed,
        vae_only=args.vae_only, semi_Dmax_minutes=args.semi_dmax_minutes,
        mesh=_mesh(args.data_parallel), device=platform_device())
    print(f"Best val loss {res['best_val_loss']:.4f}; ckpt {res['ckpt']}")


def gval_traj(args):
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.validate import (
        gen_n_val_traj,
    )

    summary = gen_n_val_traj(
        args.ckpt, args.num_gen, args.gen_csv, args.val_csv,
        args.eval_step_minutes, args.crf_mode, args.semi_dmax_minutes,
        args.summary_json, args.use_samples, args.seed,
        device=platform_device())
    print(json.dumps(summary, indent=2))


def visualize_combined_traj(args):
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("visualize-combined-traj draws with matplotlib, "
                         "which is not installed")
    from ananke_abm_tpu_torch.utils.traj_fig.figures import (
        fig_primary_lunch_time,
        fig_specific_trajs,
        fig_stacked_traj,
    )
    from ananke_abm_tpu_torch.utils.traj_fig.make_buffer_grid import (
        make_buffer_grid,
    )

    outdir, grid_min = args.outdir, args.grid_min
    os.makedirs(outdir, exist_ok=True)
    Y, pm, _ = make_buffer_grid(args.trajectory_csv, grid_min=grid_min)
    fig_stacked_traj(Y, pm, os.path.join(outdir, "stacked_traj.png"),
                     grid_min)
    fig_specific_trajs(Y, pm, outdir, grid_min)
    fig_primary_lunch_time(Y, pm, outdir, grid_min)
    print(f"Figures written to {outdir}")


def make_purposes_cmd(args):
    from ananke_abm_tpu_torch.utils.make_purposes import (
        build_purposes_catalog,
    )

    catalog = build_purposes_catalog(
        args.activities_csv, args.out_csv, args.overrides,
        override_csv=args.override_csv, persons_csv=args.persons_csv,
        purpose_col=args.purpose_col, start_col=args.start_col,
        dur_col=args.dur_col, person_col=args.person_col,
        day_col=args.day_col, day_horizon_minutes=args.day_horizon_minutes)
    print(f"Wrote {len(catalog['purpose'])} purposes to {args.out_csv}")


def gatode_train(args):
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        train,
    )

    config = GATODEConfig(epochs=args.epochs, lr=args.lr,
                          batch_size=args.batch_size,
                          num_blocks=args.num_blocks, method=args.method)
    _mesh(args.data_parallel)  # the process group, under torchrun
    res = train(args.outdir, n_agents=args.n_agents,
                num_times=args.num_times, config=config, seed=args.seed,
                num_zones=args.num_zones, sparse_world=args.sparse_world,
                data_parallel=args.data_parallel,
                ckpt_every=args.ckpt_every, resume=args.resume,
                device=platform_device())
    print(f"Final loss {res['final_loss']:.4f}, acc {res['final_acc']:.3f} "
          f"in {res['seconds']:.1f} s; ckpt {res['ckpt']}")


def gatode_serve(args):
    from ananke_abm_tpu_torch.models.gnn_embed.train import serve

    use = {"auto": "auto", "on": True, "off": False}[args.use_pallas]
    res = serve(args.ckpt, args.out_npz, n_agents=args.n_agents,
                num_times=args.num_times, seed=args.seed,
                world_seed=args.world_seed, use_kernel=use,
                device=platform_device())
    print(f"Served {res['n_agents']} agents x {res['num_times']} times in "
          f"{res['seconds']:.2f} s -> {res['out']}")


def info(args):
    import torch

    import ananke_abm_tpu_torch

    print(f"ananke_abm_tpu_torch {ananke_abm_tpu_torch.__version__}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = ", ".join(torch.cuda.get_device_name(i) for i in range(count))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{count} device(s)" + (f": {names}" if names else ""))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ananke", description="Ananke ABM - trajectory synthesis "
        "toolkit on PyTorch.")
    sub = parser.add_subparsers(dest="command", required=True,
                                metavar="COMMAND")

    def command(name, func, text):
        p = sub.add_parser(name, help=text, description=text)
        p.set_defaults(func=func)
        return p

    def flag(p, name, text=None):
        p.add_argument(name, action="store_true", default=False, help=text)

    p = command("traj-embed", traj_embed,
                "Train the TrajEmbed model (full VAE+CRF or VAE-only).")
    p.add_argument("--activities-csv", type=_existing, required=True)
    p.add_argument("--purposes-csv", type=_existing, default=None)
    p.add_argument("--crf-mode", choices=["linear", "semi"],
                   default="linear")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch", dest="batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--val-ratio", type=float, default=0.1)
    p.add_argument("--outdir", default="runs/traj_embed")
    flag(p, "--vae-only")
    p.add_argument("--semi-dmax-minutes", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    flag(p, "--data-parallel",
         "Shard batches over all attached devices (agents axis).")

    p = command("gval-traj", gval_traj,
                "Generate trajectories from a checkpoint and validate them.")
    p.add_argument("--ckpt", type=_existing, required=True)
    p.add_argument("--num-gen", type=int, default=1000)
    p.add_argument("--gen-csv", required=True)
    p.add_argument("--val-csv", type=_existing, default=None)
    p.add_argument("--eval-step-minutes", type=int, default=5)
    p.add_argument("--crf-mode", choices=["linear", "semi", "none"],
                   default=None)
    p.add_argument("--semi-dmax-minutes", type=int, default=300)
    p.add_argument("--summary-json", default=None)
    p.add_argument("--use-samples", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--seed", type=int, default=0)

    p = command("visualize-combined-traj", visualize_combined_traj,
                "Buffer grid + stacked/zoomed/lunch figures from a "
                "trajectory CSV.")
    p.add_argument("--trajectory-csv", type=_existing, required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--grid-min", type=int, default=5)

    p = command("make-purposes", make_purposes_cmd,
                "Build the purposes catalog from an activities CSV.")
    p.add_argument("--activities-csv", type=_existing, required=True)
    p.add_argument("--out-csv", required=True)
    p.add_argument("--overrides", "--override-yaml", type=_existing,
                   default=None)
    p.add_argument("--override-csv", type=_existing, default=None)
    p.add_argument("--persons-csv", type=_existing, default=None)
    p.add_argument("--purpose-col", default="purpose")
    p.add_argument("--start-col", default="startime")
    p.add_argument("--dur-col", default="total_duration")
    p.add_argument("--person-col", default="persid")
    p.add_argument("--day-col", default=None)
    p.add_argument("--day-horizon-minutes", type=float, default=1440.0)

    p = command("gatode-train", gatode_train,
                "Train the flagship GAT-ODE model on a synthetic "
                "population.")
    p.add_argument("--outdir", default="runs/gatode")
    p.add_argument("--n-agents", type=int, default=8192)
    p.add_argument("--num-times", type=int, default=48)
    p.add_argument("--num-zones", type=int, default=None,
                   help="Zone count (default: the 8-zone mock world).")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch", dest="batch_size", type=int, default=4096)
    p.add_argument("--num-blocks", type=int, default=2)
    p.add_argument("--method", choices=["rk4", "dopri5"], default="rk4")
    p.add_argument("--seed", type=int, default=0)
    flag(p, "--sparse-world",
         "Edge-list zone graph end to end (no (Z, Z) array).")
    flag(p, "--data-parallel",
         "Shard each batch over all visible devices (one card: the "
         "single-card step).")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="Write gatode_last.ckpt (params+opt_state) every k "
                   "epochs (0 = final save only).")
    flag(p, "--resume",
         "Continue from outdir's gatode_last.ckpt; reproduces the "
         "uninterrupted run exactly.")

    p = command("gatode-serve", gatode_serve,
                "Roll out a trained GAT-ODE over a fresh agent population.")
    p.add_argument("--ckpt", type=_existing, required=True)
    p.add_argument("--out-npz", required=True)
    p.add_argument("--n-agents", type=int, default=4096)
    p.add_argument("--num-times", type=int, default=None,
                   help="Output grid size (default: the ckpt's).")
    p.add_argument("--seed", type=int, default=1,
                   help="Agent-population seed (the zone world comes from "
                   "the ckpt).")
    p.add_argument("--world-seed", type=int, default=None,
                   help="Override the ckpt's zone-world seed (required for "
                   "checkpoints that predate the world keys).")
    p.add_argument("--use-pallas", choices=["auto", "on", "off"],
                   default="auto",
                   help="The fused serving kernel K1: auto = the rollout's "
                   "dispatch rule, on = always, off = the plain body.")

    command("info", info, "Version + backend information.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.func(args)
    finally:
        finish()


if __name__ == "__main__":
    main()
