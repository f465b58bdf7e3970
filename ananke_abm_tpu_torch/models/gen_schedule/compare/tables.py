"""metric-tables runner (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/tables.py``; reference
compare/compare.py:11-63): load the reference + comparison models, enforce
the temporal grid, run every registered metric into an output directory of
CSVs."""
from __future__ import annotations

from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics import (
    METRIC_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    assert_labels_fit_purpose_map,
    assert_same_temporal_grid,
    ensure_dir,
    load_comparison_models,
    load_reference,
)


def metric_tables(
    ref_npz: str, ref_meta: str, compare_dir: str, outdir: str,
    only: list[str] | None = None,
) -> list[str]:
    """Run the metric registry; returns the list of metric names run."""
    ref = load_reference(ref_npz, ref_meta)
    models = load_comparison_models(compare_dir)
    assert_same_temporal_grid(ref, models)
    assert_labels_fit_purpose_map(ref, models)
    ensure_dir(outdir)
    ran = []
    for name, fn in METRIC_FUNCS.items():
        if only and name not in only:
            continue
        fn(ref, models, outdir)
        ran.append(name)
    return ran
