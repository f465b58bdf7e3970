"""``rgen_schedule``: the schedule family's command line (the port's
counterpart of ``ananke_abm_tpu/cli/rgen_schedule.py``).

    python -m ananke_abm_tpu_torch.cli.rgen_schedule <command> [options]

The reference's eleven commands (prepare, fit, sample-population,
eval-population, viz-population, compute-pds, prepare-crf-data,
train-crf, compare-samples, metric-tables, plot-overview) with the same
option strings, defaults and printed lines, on ``argparse``. An error
exits non-zero with its message.

Commands run on the card. ``ANANKE_PLATFORM=cpu`` asks for the CPU
(``gpu`` or ``cuda``: the card); it is passed as the ``device=`` of
``train``, ``sample``, ``prepare_crf_data`` and ``train_crf``.
``--data-parallel`` is handed on as a mesh, which those entry points
refuse, naming ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import argparse
import json

from ananke_abm_tpu_torch.cli import _existing, _mesh, platform_device


def prepare(args):
    from ananke_abm_tpu_torch.dataio.rasterize import prepare_from_csv

    prepare_from_csv(args.activities, args.out, grid_min=args.grid,
                     val_frac=args.val_frac, seed=args.seed)
    print(f"Prepared grid at {args.out}")


def fit(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.train import train
    from ananke_abm_tpu_torch.utils.cfg import load_config

    config = args.config
    if args.epochs_per_jit is not None:
        config = load_config(config)
        config["train"]["epochs_per_jit"] = int(args.epochs_per_jit)
    train(config, args.output_dir, args.seed, resume=args.resume,
          mesh=_mesh(args.data_parallel), device=platform_device())
    print(f"Training complete in {args.output_dir}")


def sample_population(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.sample import (
        sample,
    )

    sample(args.ckpt_path, args.num_samples, args.outprefix, args.seed,
           args.csv_max_persons, args.decode_mode, args.crf_path,
           args.enforce_nonhome, args.reject_all_home,
           mesh=_mesh(args.data_parallel), device=platform_device())
    print(f"Sampled {args.num_samples} individuals to {args.outprefix}.npz")


def eval_population(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.eval import (
        evaluate,
    )

    evaluate(args.samples_npz_path, args.samples_meta_path,
             args.reference_grid_path, args.out_json_path)
    print(f"Evaluation complete. Report saved to {args.out_json_path}.")


def viz_population(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.viz import (
        visualize,
    )

    visualize(args.samples_npz_path, args.samples_meta_path,
              args.outdir_path, args.reference_grid_path,
              use_logits=not args.not_use_logits)
    print(f"Visualization complete. Plots saved to {args.outdir_path}.")


def compute_pds_cli(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pds import compute_pds

    summary = compute_pds(args.grid, args.out, args.grid_min,
                          args.purpose_json)
    print(json.dumps(summary, indent=2))


def prepare_crf_data_cmd(args):
    from ananke_abm_tpu_torch.models.gen_schedule.crf.prepare import (
        prepare_crf_data,
    )

    prepare_crf_data(args.vae_ckpt, args.splits_path, args.outdir,
                     args.batch_size, device=platform_device())
    print(f"[prepare-crf-data] wrote crf_train/val npz + meta to "
          f"{args.outdir}")


def train_crf_cmd(args):
    from ananke_abm_tpu_torch.models.gen_schedule.crf.train import train_crf
    from ananke_abm_tpu_torch.utils.cfg import load_config

    train_crf(load_config(args.cfg_path), mesh=_mesh(args.data_parallel),
              device=platform_device())


def compare_samples_cmd(args):
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.comparisons import (
        compare_samples,
    )

    specs = []
    for s in args.samples:
        name, prefix = s.split("=", 1)
        specs.append((name, f"{prefix}.npz", f"{prefix}_meta.json"))
    compare_samples(specs, args.reference, args.outdir,
                    make_plots=not args.no_plots)
    print(f"Comparison written to {args.outdir}")


def metric_tables_cli(args):
    from ananke_abm_tpu_torch.models.gen_schedule.compare.tables import (
        metric_tables,
    )

    ran = metric_tables(args.ref_npz, args.ref_meta, args.compare_dir,
                        args.outdir)
    print(f"Ran metrics: {', '.join(ran)}")


def plot_overview_cli(args):
    from ananke_abm_tpu_torch.models.gen_schedule.compare.plot_viz import (
        plot_overview,
    )

    plot_overview(args.ref_npz, args.ref_meta, args.compare_dir, args.outdir)
    print(f"Overview plots saved to {args.outdir}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rgen_schedule",
        description="Schedule-generation pipelines on PyTorch.")
    sub = parser.add_subparsers(dest="command", required=True,
                                metavar="COMMAND")

    def command(name, func, text):
        p = sub.add_parser(name, help=text, description=text)
        p.set_defaults(func=func)
        return p

    def flag(p, name, text=None):
        p.add_argument(name, action="store_true", default=False, help=text)

    p = command("prepare", prepare,
                "Rasterize an activities CSV into the (N, L) training grid.")
    p.add_argument("--activities", type=_existing, required=True)
    p.add_argument("--grid", type=int, default=10)
    p.add_argument("--out", required=True)
    p.add_argument("--val-frac", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)

    p = command("fit", fit, "Train a schedule VAE from a YAML/JSON config.")
    p.add_argument("--config", type=_existing, required=True)
    p.add_argument("--output-dir", default="runs")
    p.add_argument("--seed", type=int, default=123)
    flag(p, "--resume",
         "Restore params/opt state from last.ckpt and continue.")
    flag(p, "--data-parallel",
         "Shard batches over all attached devices (agents axis).")
    p.add_argument("--epochs-per-jit", type=int, default=None,
                   help="Overrides train.epochs_per_jit: last.ckpt is then "
                   "written at the ends of chunks of this many epochs.")

    p = command("sample-population", sample_population,
                "Generate a synthetic population from a trained checkpoint.")
    p.add_argument("--ckpt", dest="ckpt_path", type=_existing, required=True)
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--outprefix", required=True)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--csv-max-persons", type=int, default=200)
    p.add_argument("--decode-mode", choices=["argmax", "crf"],
                   default="argmax")
    p.add_argument("--crf-path", type=_existing, default=None)
    flag(p, "--enforce-nonhome")
    flag(p, "--reject-all-home")
    flag(p, "--data-parallel",
         "Shard chunk batches over all attached devices.")

    p = command("eval-population", eval_population,
                "Metric report JSON for a generated population vs a "
                "reference grid.")
    p.add_argument("--samples", dest="samples_npz_path", type=_existing,
                   required=True)
    p.add_argument("--samples-meta", dest="samples_meta_path",
                   type=_existing, required=True)
    p.add_argument("--reference", dest="reference_grid_path",
                   type=_existing, required=True)
    p.add_argument("--out-json", dest="out_json_path", required=True)

    p = command("viz-population", viz_population,
                "Plots for a generated population.")
    p.add_argument("--samples", dest="samples_npz_path", type=_existing,
                   required=True)
    p.add_argument("--samples-meta", dest="samples_meta_path",
                   type=_existing, required=True)
    p.add_argument("--outdir", dest="outdir_path", required=True)
    p.add_argument("--reference", dest="reference_grid_path", default="")
    flag(p, "--not-use-logits")

    p = command("compute-pds", compute_pds_cli,
                "Purpose Distribution Space statistics from a rasterized "
                "grid.")
    p.add_argument("--grid", type=_existing, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--grid-min", type=int, required=True)
    p.add_argument("--purpose-json", type=_existing, default=None)

    p = command("prepare-crf-data", prepare_crf_data_cmd,
                "Freeze a trained VAE, dump (U, Y) pairs for CRF training.")
    p.add_argument("--vae_ckpt", type=_existing, required=True)
    p.add_argument("--splits", dest="splits_path", type=_existing,
                   required=True,
                   help="Splits npz with train_idx/val_idx (from prepare).")
    p.add_argument("--outdir", required=True)
    p.add_argument("--batch_size", type=int, default=1024)

    p = command("train-crf", train_crf_cmd,
                "Train a TransitionCRF from a crf_config.yaml.")
    p.add_argument("--cfg", dest="cfg_path", type=_existing, required=True)
    flag(p, "--data-parallel",
         "Shard (U, Y) batches over all attached devices.")

    p = command("compare-samples", compare_samples_cmd,
                "Compare several sample-population outputs against one "
                "reference.")
    p.add_argument("--sample", dest="samples", action="append",
                   required=True,
                   help="name=<npz_prefix>; expects <prefix>.npz and "
                   "<prefix>_meta.json.")
    p.add_argument("--reference", type=_existing, required=True)
    p.add_argument("--outdir", required=True)
    flag(p, "--no-plots")

    for name, func, text in (
            ("metric-tables", metric_tables_cli,
             "Run the full metric registry into CSV tables."),
            ("plot-overview", plot_overview_cli,
             "Lorenz+Gini overview, ToD curves, duration boxplots.")):
        p = command(name, func, text)
        p.add_argument("--ref-npz", type=_existing, required=True)
        p.add_argument("--ref-meta", type=_existing, required=True)
        p.add_argument("--compare-dir", type=_existing, required=True)
        p.add_argument("--outdir", required=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
