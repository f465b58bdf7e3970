"""The port's ``compare_samples``, ``plot_overview`` and ``visualize``
(``ananke_abm_tpu_torch/models/gen_schedule/{pipeline,compare,viz}``)
against the JAX package's on the same seeded sample sets, on the CPU: the
same report JSONs and aggregate CSV text, the same set of PNG names (each
a non-empty PNG; the bytes are not compared)."""
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import ananke_abm_tpu_torch.models.gen_schedule.compare.plot_viz as tpv
from ananke_abm_tpu.models.gen_schedule.compare.plot_viz import (
    plot_overview as jplot_overview,
)
from ananke_abm_tpu.models.gen_schedule.pipeline.comparisons import (
    compare_samples as jcompare,
)
from ananke_abm_tpu.models.gen_schedule.pipeline.viz import (
    visualize as jvisualize,
)
from ananke_abm_tpu_torch.models.gen_schedule.pipeline.comparisons import (
    compare_samples as tcompare,
)
from ananke_abm_tpu_torch.models.gen_schedule.pipeline.viz import (
    visualize as tvisualize,
)

PNG = b"\x89PNG\r\n\x1a\n"
ROOT = Path(__file__).resolve().parents[1]


def _world(tmp_path, N=40, T=24, P=4, tod=True):
    pm = {"Home": 0, "Work": 1, "Shop": 2, "Edu": 3}
    meta = {"purpose_map": pm, "grid_min": 60, "L": T}

    def grid(seed):
        Y = np.random.default_rng(seed).integers(0, P, size=(N, T))
        Y[:, 0] = 0
        Y[:, -1] = 0
        return Y

    ref_npz = tmp_path / "ref.npz"
    np.savez(ref_npz, Y=grid(1))
    if tod:
        np.save(tmp_path / "ref_tod.npy",
                np.random.default_rng(9).dirichlet(np.ones(P), size=T))
    ref_meta = tmp_path / "ref_meta.json"
    ref_meta.write_text(json.dumps(meta))
    specs = []
    for name, seed in (("modelA", 2), ("modelB", 3)):
        npz = tmp_path / f"{name}.npz"
        r = np.random.default_rng(seed + 10)
        np.savez(npz, Y_generated=grid(seed),
                 U_mean_logits=r.standard_normal((T, P)).astype(np.float32),
                 U_std_logits=r.random((T, P)).astype(np.float32))
        mj = tmp_path / f"{name}_meta.json"
        mj.write_text(json.dumps(dict(meta, purpose_names_ordered=list(pm))))
        specs.append((name, str(npz), str(mj)))
    return str(ref_npz), str(ref_meta), specs


def _pngs(outdir):
    out = {}
    for root, _, files in os.walk(outdir):
        for f in files:
            if f.endswith(".png"):
                with open(os.path.join(root, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(root, f), outdir)] = \
                        fh.read()
    return out


def _assert_same_pngs(got_dir, want_dir):
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert got and sorted(got) == sorted(want)
    for name, data in got.items():
        assert data.startswith(PNG) and len(data) > len(PNG), name


@pytest.mark.parametrize("tod", [True, False], ids=["ref-tod", "no-tod"])
def test_compare_samples_equals_jax(tod, tmp_path):
    ref_npz, _, specs = _world(tmp_path, tod=tod)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jcompare(specs, ref_npz, jout, make_plots=True)
    got = tcompare(specs, ref_npz, tout, make_plots=True)
    assert got == want
    assert [r["model"] for r in got] == ["modelA", "modelB"]
    for name in ("report_modelA.json", "report_modelB.json",
                 "comparison_aggregate.csv"):
        with open(os.path.join(tout, name)) as f, \
                open(os.path.join(jout, name)) as g:
            assert f.read() == g.read(), name
    _assert_same_pngs(tout, jout)


def test_compare_samples_without_plots_needs_no_matplotlib(tmp_path,
                                                           monkeypatch):
    for name in [k for k in sys.modules if k.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ref_npz, _, specs = _world(tmp_path)
    tcompare(specs, ref_npz, str(tmp_path / "cmp"), make_plots=False)
    assert not _pngs(str(tmp_path / "cmp"))
    with pytest.raises(ImportError):
        tcompare(specs, ref_npz, str(tmp_path / "cmp2"), make_plots=True)


def test_plot_overview_writes_the_jax_pngs(tmp_path):
    ref_npz, ref_meta, _ = _world(tmp_path)
    jplot_overview(ref_npz, ref_meta, str(tmp_path), str(tmp_path / "jax"))
    tpv.plot_overview(ref_npz, ref_meta, str(tmp_path),
                      str(tmp_path / "port"))
    _assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert "lorenz_gini_overview.png" in _pngs(str(tmp_path / "port"))


def test_plot_overview_threads_grid_min(tmp_path, monkeypatch):
    """The ToD time axis follows the reference grid: at grid_min=60 a
    24-bin day spans 24 h, not the 5-min default's 2 h."""
    seen = {}

    def fake_tod(ref, models, outdir, time_grid=5, **kw):
        seen["time_grid"] = time_grid

    monkeypatch.setattr(tpv, "plot_tod_curves", fake_tod)
    ref_npz, ref_meta, _ = _world(tmp_path)
    tpv.plot_overview(ref_npz, ref_meta, str(tmp_path),
                      str(tmp_path / "viz"))
    assert seen["time_grid"] == 60


@pytest.mark.parametrize("reference,use_logits", [(True, True),
                                                  (False, False)])
def test_visualize_writes_the_jax_pngs(reference, use_logits, tmp_path):
    ref_npz, _, specs = _world(tmp_path)
    _, npz, meta = specs[0]
    ref = ref_npz if reference else ""
    jvisualize(npz, meta, str(tmp_path / "jax"), ref, use_logits=use_logits)
    tvisualize(npz, meta, str(tmp_path / "port"), ref, use_logits=use_logits)
    _assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"))
    names = set(_pngs(str(tmp_path / "port")))
    assert ("bigram_delta.png" in names) == reference
    assert ("unaries_mean_std.png" in names) == use_logits


def test_port_imports_matplotlib_only_inside_functions_and_never_click():
    """The card's machine may lack matplotlib and click: the port imports
    matplotlib only where a plot is drawn, and never click."""
    files = sorted((ROOT / "ananke_abm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    top = re.compile(r"^(import|from)\s+matplotlib\b", re.M)
    click = re.compile(r"^\s*(import|from)\s+click\b", re.M)
    for f in files:
        src = f.read_text()
        assert not top.search(src), f
        assert not click.search(src), f
