"""The host-side helpers of ``chip_smoke.py`` that need no card: the
parser that turns ``nvcc -Xptxas -v`` output into one line per kernel (the
registers and spills the smoke and ``--ab-dopri5`` report), the profiler
summary's refusal to report a device share where the profiler saw no
device time, ``--ab-train``'s probe variants of a checkout's kernel
sources, and the script's module-level names, each defined once."""
import ast
import inspect
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

LOG = """\
ptxas info    : 0 bytes gmem, 1120 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122dopri5_backward_kernelINS_8Bf16BodyILi6EEEEEvNT_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113step_vjp_bf16ILi6EEEvPf
    96 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_122dopri5_backward_kernelINS_8Bf16BodyILi6EEEEEvNT_6ParamsE
    0 bytes stack frame, 40 bytes spill stores, 108 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 752 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN6ananke12reduce_slabsEPKfPfli' for 'sm_90a'
ptxas info    : Function properties for _ZN6ananke12reduce_slabsEPKfPfli
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 384 bytes cmem[0]
"""


def test_ptxas_lines_give_registers_and_spills_per_kernel():
    lines = chip_smoke.ptxas_lines(LOG)
    assert len(lines) == 3
    assert "dopri5_backward_kernel" in lines[0]
    assert lines[0].endswith(
        "255 registers, 40 B spill stores, 108 B spill loads")
    assert "reduce_slabs" in lines[1]
    assert lines[1].endswith("32 registers, 0 B spill stores, 0 B spill loads")
    # a device function the kernel calls: its own spills
    assert "step_vjp_bf16" in lines[2]
    assert lines[2].endswith("called: 12 B spill stores, 12 B spill loads")


def test_ptxas_lines_of_a_cached_build_are_empty():
    assert chip_smoke.ptxas_lines("") == []


def test_device_busy_reports_not_measured_without_device_time(capsys,
                                                              monkeypatch):
    torch = pytest.importorskip("torch")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    chip_smoke.device_busy("a host-only step", lambda: torch.ones(4) + 1,
                           "no card")
    out = capsys.readouterr().out
    assert "not measured" in out and "busy" in out


def test_module_level_names_are_defined_once():
    """A second ``def`` of a name replaces the first for every caller: the
    ``--readings`` witness step once lost its 6-argument function so."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted({n for n in names if names.count(n) > 1}) == []
    assert list(inspect.signature(chip_smoke.witness_readings).parameters) \
        == ["dev", "n", "z", "nb", "num_times", "seed"]


def test_ab_checkout_builds_a_probe_variant_and_refuses_a_stale_one(
        tmp_path, monkeypatch):
    """``DIR+noslab``: a copy of DIR's kernel sources under OUT/variants/
    with every substitution of the probe made, DIR itself untouched; a
    plain DIR is itself; an unknown probe, or one whose pattern no longer
    matches the sources, fails rather than time an unchanged kernel."""
    monkeypatch.setattr(chip_smoke, "OUT", tmp_path / "out")
    csrc = tmp_path / "co" / "ananke_abm_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    slab = "  *p = first ? v : *p + v;\n"
    sm90 = ("      const float2 lo = va ? *reinterpret_cast<const float2*>"
            "(out + ma * N + c) : z2;\n"
            "      if (vb)\n        *reinterpret_cast<float2*>(out + mb * N"
            " + c) =\n")
    (csrc / "drift_stage.cuh").write_text(slab)
    (csrc / "stage_sm90.cuh").write_text(sm90)
    name, root = chip_smoke.ab_checkout(f"{tmp_path / 'co'}+noslab")
    assert name.endswith("co+noslab")
    assert root == tmp_path / "out" / "variants" / "co+noslab"
    out = root / "ananke_abm_tpu_torch" / "csrc"
    assert (out / "drift_stage.cuh").read_text() == (
        "  if (v == 1.2345e-30f) *p = v;\n")
    text = (out / "stage_sm90.cuh").read_text()
    assert "const float2 lo = z2;" in text
    assert "if (vb && acc[j][0] == 1.2345e-30f)" in text
    assert (csrc / "drift_stage.cuh").read_text() == slab
    assert chip_smoke.ab_checkout(tmp_path / "co") == (
        str(tmp_path / "co"), tmp_path / "co")
    with pytest.raises(SystemExit, match="unknown probe"):
        chip_smoke.ab_checkout(f"{tmp_path / 'co'}+nothing")
    (csrc / "drift_stage.cuh").write_text("  *p += v;\n")
    with pytest.raises(SystemExit, match="no match"):
        chip_smoke.ab_checkout(f"{tmp_path / 'co'}+noslab")


@pytest.mark.parametrize("probe", sorted(chip_smoke.PROBES))
def test_probes_match_this_checkouts_sources(tmp_path, monkeypatch, probe):
    """``.+PROBE`` (for ``--ab-k8``: ``constb``, ``noslab``, ``nomath``,
    ``noproducts`` on K8's and K8a's sources) is this checkout's kernel
    sources with every substitution of the probe made: each pattern still
    matches them (a stale one would be refused), and the variant differs
    from them only in the files the probe names. A probe of code this
    checkout no longer has (PROBES_BEFORE: the FFMA float32 bodies) is
    refused here for want of a match."""
    monkeypatch.setattr(chip_smoke, "OUT", tmp_path / "out")
    csrc = ROOT / "ananke_abm_tpu_torch" / "csrc"
    if probe in chip_smoke.PROBES_BEFORE:
        with pytest.raises(SystemExit, match="no match"):
            chip_smoke.ab_checkout(f"{ROOT}+{probe}")
        return
    name, root = chip_smoke.ab_checkout(f"{ROOT}+{probe}")
    assert name == f"{ROOT}+{probe}"
    out = root / "ananke_abm_tpu_torch" / "csrc"
    changed = {p.name for p in csrc.iterdir()
               if p.read_text() != (out / p.name).read_text()}
    assert changed == {f for f, _, _ in chip_smoke.PROBES[probe]}
    assert {"fused_rhs.cu", "fused_step.cu"} <= {p.name
                                                 for p in out.iterdir()}


def test_schedule_config_replaces_only_the_listed_cuts():
    cfg = chip_smoke.schedule_config("phase2", data__npz="g.npz",
                                     model__pds_path="p.npz",
                                     train__epochs=1)
    assert cfg["data"]["npz"] == "g.npz" and cfg["train"]["epochs"] == 1
    assert cfg["model"]["pds_path"] == "p.npz"
    assert chip_smoke.SCHEDULE_CONFIGS["phase2"]["train"]["epochs"] == 500
    with pytest.raises(KeyError, match="train.lr"):
        chip_smoke.schedule_config("phase1", train__lr=1.0)


def test_read_log_max_rel_and_cosine(tmp_path):
    torch = pytest.importorskip("torch")
    path = tmp_path / "training_log.csv"
    path.write_text("epoch,beta,train_loss\n1,0.5,2.25\n2,1.0,2.0\n")
    rows = chip_smoke.read_log(str(path))
    assert rows == [{"epoch": 1.0, "beta": 0.5, "train_loss": 2.25},
                    {"epoch": 2.0, "beta": 1.0, "train_loss": 2.0}]
    assert chip_smoke.max_rel([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    a = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    assert chip_smoke.cosine(a, 3 * a) == pytest.approx(1.0)
    assert chip_smoke.cosine(a, -a) == pytest.approx(-1.0)
    assert chip_smoke.cosine(torch.zeros(3), torch.zeros(3)) == 1.0
