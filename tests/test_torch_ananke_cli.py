"""The port's ``ananke`` command line (``ananke_abm_tpu_torch/cli/main.py``)
against the JAX package's click group ``ananke_abm_tpu.cli.main.main``:
the same seven commands, option strings, defaults and flags; make-purposes
equal to the JAX CLI's output and file; traj-embed -> gval-traj,
visualize-combined-traj, gatode-train -> gatode-serve and info on the CPU
(``ANANKE_PLATFORM=cpu``) at tiny widths; ``--data-parallel`` under
``torchrun``; the refusals (matplotlib absent, no card)."""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import click
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from _torch_parallel_worker import torchrun
from ananke_abm_tpu.cli.main import main as jmain
from ananke_abm_tpu.data_generator.population import (
    generate_population_activities,
)
from ananke_abm_tpu_torch.cli import _existing
from ananke_abm_tpu_torch.cli import main as tcli
from ananke_abm_tpu_torch.models.gnn_embed.train import serve

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = ["traj-embed", "gval-traj", "visualize-combined-traj",
            "make-purposes", "gatode-train", "gatode-serve", "info"]


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
    flag = bool(param.is_flag)
    return (tuple(param.opts) + tuple(param.secondary_opts), param.name,
            default, param.required, flag, kind)


def _argparse_spec(action):
    flag = isinstance(action, (argparse._StoreTrueAction,
                               argparse.BooleanOptionalAction))
    kind = (None if flag else "existing path" if action.type is _existing
            else tuple(action.choices) if action.choices else action.type)
    return (tuple(action.option_strings), action.dest, action.default,
            action.required, flag, kind)


def test_commands_options_and_defaults_equal_the_click_group():
    subs = _subparsers()
    assert list(subs) == list(jmain.commands) == COMMANDS
    for name, cmd in jmain.commands.items():
        want = [_click_spec(p) for p in cmd.params]
        got = [_argparse_spec(a) for a in subs[name]._actions
               if not isinstance(a, argparse._HelpAction)]
        assert got == want, name


def test_help_lists_the_seven_commands_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "ananke_abm_tpu_torch.cli.main", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    for name in COMMANDS:
        assert name in out.stdout


@pytest.fixture(scope="module")
def acts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ananke_cli")
    p = str(d / "acts.csv")
    generate_population_activities(40, seed=4).to_csv(p, index=False)
    return p


def _run(argv, capsys):
    tcli.main(argv)
    return capsys.readouterr().out


def test_make_purposes_equals_the_jax_cli(acts, tmp_path, capsys):
    ov = tmp_path / "ov.yaml"
    ov.write_text("Home:\n  notes: anchor\nWork:\n  is_primary: no\n")
    args = ["make-purposes", "--activities-csv", acts, "--override-yaml",
            str(ov), "--day-horizon-minutes", "1800"]
    jout, tout = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    r = CliRunner().invoke(jmain, args + ["--out-csv", jout])
    assert r.exit_code == 0, r.output
    out = _run(args + ["--out-csv", tout], capsys)
    assert out == r.output.replace(jout, tout)
    assert Path(tout).read_bytes() == Path(jout).read_bytes()


def test_traj_embed_then_gval_traj_on_the_cpu(acts, tmp_path, capsys,
                                              monkeypatch):
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    run = str(tmp_path / "run")
    out = _run(["traj-embed", "--activities-csv", acts, "--crf-mode", "semi",
                "--epochs", "1", "--batch", "16", "--outdir", run,
                "--semi-dmax-minutes", "15"], capsys)
    ckpt = os.path.join(run, "ckpt_best.ckpt")
    assert out.startswith("traj_embed training completed in ")
    assert out.endswith(f"; ckpt {ckpt}\n") and "Best val loss " in out
    gen = str(tmp_path / "gen.csv")
    summary = str(tmp_path / "summary.json")
    out = _run(["gval-traj", "--ckpt", ckpt, "--num-gen", "24", "--gen-csv",
                gen, "--val-csv", acts, "--eval-step-minutes", "15",
                "--summary-json", summary, "--no-use-samples"], capsys)
    printed = json.loads(out)
    with open(summary) as f:
        assert json.load(f) == printed
    assert printed["num_gen"] == 24 and printed["use_samples"] is False
    assert printed["validation"]["L"] == 1800 // 15
    # no latent noise: every generated person is the prior mean's decode
    with open(gen) as f:
        rows = f.read().splitlines()
    assert rows[0] == "persid,stopno,purpose,starttime,total_duration"
    per_person = {}
    for r in rows[1:]:
        pid, *rest = r.split(",")
        per_person.setdefault(pid, []).append(rest)
    assert len(per_person) == 24
    assert len({json.dumps(v) for v in per_person.values()}) == 1


def test_traj_embed_data_parallel_exits_naming_item_11(acts, tmp_path,
                                                       capsys, monkeypatch):
    """``traj-embed --data-parallel`` under ``torchrun`` on 2 gloo ranks
    prints the single-device run's best validation loss."""
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    args = ["traj-embed", "--activities-csv", acts, "--epochs", "1",
            "--batch", "16"]
    proc = torchrun("ananke_abm_tpu_torch.cli.main",
                    [*args, "--outdir", str(tmp_path / "dp"),
                     "--data-parallel"], 2, ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    single = _run([*args, "--outdir", str(tmp_path / "one")], capsys)
    best = lambda out: [float(l.split(";")[0].rsplit(" ", 1)[1])  # noqa
                        for l in out.splitlines()
                        if l.startswith("Best val loss ")]
    got, (want,) = best(proc.stdout), best(single)
    assert len(got) == 2  # every rank prints it
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (tmp_path / "dp" / "ckpt_best.ckpt").exists()


def test_gatode_train_data_parallel_under_torchrun(tmp_path, capsys,
                                                   monkeypatch):
    """``gatode-train --data-parallel`` on 2 gloo ranks: the sharded
    per-batch step gives the single-device run's loss and accuracy."""
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    args = ["gatode-train", "--n-agents", "64", "--num-times", "6",
            "--epochs", "1", "--batch", "32", "--seed", "2"]
    proc = torchrun("ananke_abm_tpu_torch.cli.main",
                    [*args, "--outdir", str(tmp_path / "dp"),
                     "--data-parallel"], 2, ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    single = _run([*args, "--outdir", str(tmp_path / "one")], capsys)
    want = single.split(" in ")[0]
    assert want.startswith("Final loss ")
    assert proc.stdout.count(want) == 2
    assert (tmp_path / "dp" / "gatode_best.ckpt").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_traj_embed_without_a_card_fails_and_never_runs_on_the_cpu(
        acts, tmp_path, monkeypatch):
    monkeypatch.delenv("ANANKE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["traj-embed", "--activities-csv", acts, "--epochs", "1",
                   "--outdir", str(tmp_path / "r")])
    assert not (tmp_path / "r" / "ckpt_best.ckpt").exists()
    assert not (tmp_path / "r" / "training_log.csv").exists()


def test_visualize_combined_traj_draws_its_figures(acts, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    outdir = str(tmp_path / "figs")
    out = _run(["visualize-combined-traj", "--trajectory-csv", acts,
                "--outdir", outdir, "--grid-min", "10"], capsys)
    assert out == f"Figures written to {outdir}\n"
    pngs = sorted(os.listdir(outdir))
    assert "stacked_traj.png" in pngs and len(pngs) >= 3
    assert all(os.path.getsize(os.path.join(outdir, p)) > 0 for p in pngs)


def test_visualize_combined_traj_without_matplotlib_exits_naming_it(
        acts, tmp_path, monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else real(name, *a))
    with pytest.raises(SystemExit) as e:
        tcli.main(["visualize-combined-traj", "--trajectory-csv", acts,
                   "--outdir", str(tmp_path / "f")])
    assert e.value.code != 0 and "matplotlib" in str(e.value.code)


def test_gatode_train_then_serve_on_the_cpu(tmp_path, capsys, monkeypatch):
    """gatode-train at a tiny population, then gatode-serve with the
    kernel route on (its plain version on the CPU, bf16 products) and off
    (the float32 body): each equal to serve() in-process on the same
    checkpoint, seed and route."""
    monkeypatch.setenv("ANANKE_PLATFORM", "cpu")
    outdir = str(tmp_path / "g")
    out = _run(["gatode-train", "--outdir", outdir, "--n-agents", "64",
                "--num-times", "6", "--epochs", "1", "--batch", "32",
                "--seed", "2"], capsys)
    assert out.startswith("Final loss ") and "; ckpt " in out
    ckpt = out.strip().rsplit("; ckpt ", 1)[1]
    assert os.path.exists(ckpt)
    ids = {}
    for use in ("on", "off"):
        npz = str(tmp_path / f"{use}.npz")
        out = _run(["gatode-serve", "--ckpt", ckpt, "--out-npz", npz,
                    "--n-agents", "48", "--seed", "3", "--use-pallas", use],
                   capsys)
        assert out.startswith("Served 48 agents x 6 times in ")
        with np.load(npz) as d:
            ids[use] = d["zone_ids"]
    for use, kernel in (("on", True), ("off", False)):
        serve(ckpt, str(tmp_path / "in.npz"), n_agents=48, seed=3,
              use_kernel=kernel, device="cpu")
        with np.load(tmp_path / "in.npz") as d:
            np.testing.assert_array_equal(ids[use], d["zone_ids"])
    assert ids["on"].shape == (48, 6)


def test_info_prints_the_versions_and_devices(capsys):
    import ananke_abm_tpu_torch

    out = _run(["info"], capsys).splitlines()
    assert out[0] == f"ananke_abm_tpu_torch {ananke_abm_tpu_torch.__version__}"
    assert out[1].startswith(f"torch {torch.__version__}, CUDA ")
    assert f"{torch.cuda.device_count()} device(s)" in out[1]
