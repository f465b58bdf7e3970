"""The host-side helpers of ``chip_smoke.py`` that need no card: the
parser that turns ``nvcc -Xptxas -v`` output into one line per kernel (the
registers and spills the smoke and ``--ab-dopri5`` report), the profiler
summary's refusal to report a device share where the profiler saw no
device time, and ``--ab-train``'s probe variants of a checkout's kernel
sources."""
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
