"""The port's ``rgen_schedule`` command line
(``ananke_abm_tpu_torch/cli/rgen_schedule.py``) against the JAX package's
click group: the same commands, option strings, defaults and flags; the
whole workflow on the CPU (``ANANKE_PLATFORM=cpu``) at tiny widths;
``prepare``'s files equal to the JAX CLI's; ``--data-parallel`` exiting
non-zero with the item-11 message."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import click
import numpy as np
import pytest
from click.testing import CliRunner

from ananke_abm_tpu.cli.rgen_schedule import main as jmain
from ananke_abm_tpu_torch.cli import rgen_schedule as tcli
from ananke_abm_tpu_torch.data_generator.population import (
    generate_population_activities,
    write_csv,
)

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = ["prepare", "fit", "sample-population", "eval-population",
            "viz-population", "compute-pds", "prepare-crf-data", "train-crf",
            "compare-samples", "metric-tables", "plot-overview"]


def _subparsers():
    parser = tcli.build_parser()
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def _click_spec(param):
    kind = param.type
    if isinstance(kind, click.Path):
        kind = "existing path" if kind.exists else None
    elif isinstance(kind, click.Choice):
        kind = tuple(kind.choices)
    elif isinstance(kind, (click.types.IntParamType,
                           click.types.FloatParamType)):
        kind = {"integer": int, "float": float}[kind.name]
    else:
        kind = None
    default = None if param.required else param.default
    return (tuple(param.opts), param.name, default, param.required,
            bool(param.is_flag), bool(param.multiple), kind)


def _argparse_spec(action):
    kind = ("existing path" if action.type is tcli._existing
            else tuple(action.choices) if action.choices else action.type)
    return (tuple(action.option_strings), action.dest, action.default,
            action.required, isinstance(action, argparse._StoreTrueAction),
            isinstance(action, argparse._AppendAction), kind)


def test_commands_options_and_defaults_equal_the_click_group():
    subs = _subparsers()
    assert list(subs) == list(jmain.commands) == COMMANDS
    for name, cmd in jmain.commands.items():
        want = [_click_spec(p) for p in cmd.params]
        got = [_argparse_spec(a) for a in subs[name]._actions
               if not isinstance(a, argparse._HelpAction)]
        assert got == want, name


def test_help_lists_the_eleven_commands_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "ananke_abm_tpu_torch.cli.rgen_schedule",
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    for name in COMMANDS:
        assert name in out.stdout


def test_platform_names_the_device(monkeypatch):
    monkeypatch.delenv("ANANKE_PLATFORM", raising=False)
    assert tcli.platform_device() == "cuda"
    for name, device in (("cpu", "cpu"), ("gpu", "cuda"), ("cuda", "cuda")):
        monkeypatch.setenv("ANANKE_PLATFORM", name)
        assert tcli.platform_device() == device
    monkeypatch.setenv("ANANKE_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="ANANKE_PLATFORM"):
        tcli.platform_device()


def test_a_missing_path_exits_with_a_usage_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["prepare", "--activities", str(tmp_path / "none.csv"),
                   "--out", str(tmp_path / "g.npz")])
    assert e.value.code != 0
    assert "does not exist" in capsys.readouterr().err


@pytest.fixture(scope="module")
def acts(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_acts")
    return write_csv(str(d / "acts.csv"),
                     generate_population_activities(64, seed=5))


def _run(argv, capsys):
    tcli.main(argv)
    return capsys.readouterr().out


def test_prepare_equals_the_jax_cli(acts, tmp_path, capsys):
    args = ["prepare", "--activities", acts, "--grid", "30", "--val-frac",
            "0.25", "--seed", "3"]
    jgrid, tgrid = str(tmp_path / "j" / "g.npz"), str(tmp_path / "t" / "g.npz")
    r = CliRunner().invoke(jmain, args + ["--out", jgrid])
    assert r.exit_code == 0, r.output
    out = _run(args + ["--out", tgrid], capsys)
    assert out == r.output.replace(jgrid, tgrid)
    for suffix in (".npz", "_splits.npz"):
        with np.load(jgrid.replace(".npz", suffix)) as a, \
                np.load(tgrid.replace(".npz", suffix)) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_array_equal(np.load(tgrid.replace(".npz", "_tod.npy")),
                                  np.load(jgrid.replace(".npz", "_tod.npy")))
    for suffix in ("_meta.json", "_purpose_map.json"):
        with open(jgrid.replace(".npz", suffix)) as f, \
                open(tgrid.replace(".npz", suffix)) as g:
            assert json.load(g) == json.load(f)


def test_whole_workflow_on_the_cpu(acts, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    grid = str(tmp_path / "data" / "grid.npz")
    out = _run(["prepare", "--activities", acts, "--grid", "30", "--out",
                grid, "--val-frac", "0.2", "--seed", "1"], capsys)
    assert out == f"Prepared grid at {grid}\n"

    out = _run(["compute-pds", "--grid", grid, "--out",
                str(tmp_path / "pds"), "--grid-min", "30", "--purpose-json",
                grid.replace(".npz", "_purpose_map.json")], capsys)
    assert len(json.loads(out)["purposes"]) == 7
    assert (tmp_path / "pds_pds.npz").exists()

    cfg = {"data": {"npz": grid},
           "train": {"epochs": 2, "min_epochs": 2, "patience": 0,
                     "batch_size": 32, "lr": 1e-3, "weight_decay": 0.0,
                     "grad_clip": 1.0, "beta_target": 1.0,
                     "beta_warm_frac": 0.5, "lambda_tv": 0.0,
                     "lambda_home": 0.1},
           "model": {"method": "baseline_cnn", "z_dim": 4, "emb_dim": 8,
                     "cnn_channels": [8], "cnn_kernel": 3,
                     "cnn_dropout": 0.1}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    run = str(tmp_path / "run")
    out = _run(["fit", "--config", str(cfg_path), "--output-dir", run,
                "--seed", "1", "--epochs-per-jit", "2"], capsys)
    assert out.endswith(f"Training complete in {run}\n")
    ckpt = os.path.join(run, "checkpoints", "best_val.ckpt")
    with open(os.path.join(run, "training_log.csv")) as f:
        assert len(f.read().splitlines()) == 3

    prefix = str(tmp_path / "samples" / "s")
    out = _run(["sample-population", "--ckpt", ckpt, "--num-samples", "40",
                "--outprefix", prefix, "--seed", "2", "--csv-max-persons",
                "5", "--reject-all-home"], capsys)
    assert out.endswith(f"Sampled 40 individuals to {prefix}.npz\n")

    crfdir = str(tmp_path / "crf")
    _run(["prepare-crf-data", "--vae_ckpt", ckpt, "--splits",
          grid.replace(".npz", "_splits.npz"), "--outdir", crfdir,
          "--batch_size", "32"], capsys)
    crf_cfg = tmp_path / "crf.json"
    crf_cfg.write_text(json.dumps({"crf": {
        "train_npz": os.path.join(crfdir, "crf_train.npz"),
        "val_npz": os.path.join(crfdir, "crf_val.npz"),
        "save_path": os.path.join(crfdir, "crf_linear.ckpt"),
        "meta_json": os.path.join(crfdir, "crf_meta.json"),
        "num_epochs": 1, "batch_size": 16, "lr": 1e-2,
        "weight_decay": 1e-4, "log_every": 1}}))
    _run(["train-crf", "--cfg", str(crf_cfg)], capsys)
    prefix2 = str(tmp_path / "samples" / "c")
    _run(["sample-population", "--ckpt", ckpt, "--num-samples", "40",
          "--outprefix", prefix2, "--decode-mode", "crf", "--crf-path",
          os.path.join(crfdir, "crf_linear.ckpt"), "--enforce-nonhome"],
         capsys)

    report = str(tmp_path / "report.json")
    out = _run(["eval-population", "--samples", prefix + ".npz",
                "--samples-meta", prefix + "_meta.json", "--reference", grid,
                "--out-json", report], capsys)
    assert out == f"Evaluation complete. Report saved to {report}.\n"
    with open(report) as f:
        assert json.load(f)["all_home_rate"] == 0.0

    _run(["viz-population", "--samples", prefix + ".npz", "--samples-meta",
          prefix + "_meta.json", "--outdir", str(tmp_path / "viz"),
          "--not-use-logits"], capsys)
    assert sorted(os.listdir(tmp_path / "viz")) == ["minutes_share.png",
                                                    "tod_marginals.png"]

    cmp_dir = str(tmp_path / "cmp")
    _run(["compare-samples", "--sample", f"argmax={prefix}", "--sample",
          f"crf={prefix2}", "--reference", grid, "--outdir", cmp_dir,
          "--no-plots"], capsys)
    with open(os.path.join(cmp_dir, "comparison_aggregate.csv")) as f:
        assert [r.split(",")[0] for r in f.read().splitlines()] == [
            "model", "argmax", "crf"]

    cdir = tmp_path / "models"
    cdir.mkdir()
    for name, pfx in (("argmax", prefix), ("crf", prefix2)):
        with np.load(pfx + ".npz") as d:
            np.savez(str(cdir / f"{name}.npz"), Y_generated=d["Y_generated"])
        (cdir / f"{name}_meta.json").write_text(
            Path(pfx + "_meta.json").read_text())
    tables = tmp_path / "tables"
    ref = ["--ref-npz", grid, "--ref-meta",
           grid.replace(".npz", "_meta.json"), "--compare-dir", str(cdir)]
    out = _run(["metric-tables", *ref, "--outdir", str(tables)], capsys)
    assert out.startswith("Ran metrics: tod_jsd_ngram, duration_jsd_ngram")
    assert len(os.listdir(tables)) == 24
    _run(["plot-overview", *ref, "--outdir", str(tmp_path / "overview")],
         capsys)
    assert (tmp_path / "overview" / "lorenz_gini_overview.png").exists()


def test_data_parallel_exits_non_zero_naming_item_11(acts, tmp_path,
                                                     capsys, monkeypatch):
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    grid = str(tmp_path / "grid.npz")
    _run(["prepare", "--activities", acts, "--grid", "60", "--out", grid],
         capsys)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"data": {"npz": grid}, "train": {},
                               "model": {}}))
    proc = subprocess.run(
        [sys.executable, "-m", "ananke_abm_tpu_torch.cli.rgen_schedule",
         "fit", "--config", str(cfg), "--output-dir", str(tmp_path / "r"),
         "--data-parallel"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, ANANKE_PLATFORM="cpu"))
    assert proc.returncode != 0
    assert "item 11" in proc.stderr
    # the sampler's and the CRF trainer's flags refuse the same way
    for argv in (["sample-population", "--ckpt", grid, "--outprefix",
                  str(tmp_path / "s"), "--data-parallel"],
                 ["train-crf", "--cfg", str(cfg), "--data-parallel"]):
        with pytest.raises(NotImplementedError, match="item 11"):
            tcli.main(argv)
