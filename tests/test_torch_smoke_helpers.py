"""The host-side helpers of ``chip_smoke.py`` that need no card: the
parser that turns ``nvcc -Xptxas -v`` output into one line per kernel (the
registers and spills the smoke and ``--ab-dopri5`` report), and the
profiler summary's refusal to report a device share where the profiler
saw no device time."""
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
