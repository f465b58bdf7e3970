"""plot-overview entry (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/plot_viz.py``; reference
compare/plot_viz.py:21-51): Lorenz+Gini overview plus ToD curves and
duration boxplots, with a predefined color map for the canonical model
lineup."""
from __future__ import annotations

from ananke_abm_tpu_torch.models.gen_schedule.compare.utils import (
    assert_same_temporal_grid,
    ensure_dir,
    load_comparison_models,
    load_reference,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.viz_metrics.duration import (
    plot_duration_boxplots,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.viz_metrics.lorenz import (
    plot_lorenz_gini,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.viz_metrics.tod import (
    plot_tod_curves,
)

# canonical model lineup colors (reference plot_viz.py:43-51)
MODEL_COLORS = {
    "ref": "#222222",
    "VAE_CNN": "#1f77b4",
    "VAE_CNN_CRF": "#ff7f0e",
    "VAE_CNN_CRF_rejection": "#2ca02c",
    "VAE_CNN_CRF_constrained": "#d62728",
    "ContRNN": "#9467bd",
}


def plot_overview(ref_npz: str, ref_meta: str, compare_dir: str, outdir: str):
    ref = load_reference(ref_npz, ref_meta)
    models = load_comparison_models(compare_dir)
    assert_same_temporal_grid(ref, models)
    ensure_dir(outdir)
    plot_lorenz_gini(ref, models, outdir, color_map=MODEL_COLORS)
    # thread the reference grid: a 30-min grid plotted at the 5-min
    # default would compress the time axis 6x (duration boxplots read
    # grid_min from ref themselves)
    plot_tod_curves(ref, models, outdir,
                    time_grid=ref.get("grid_min") or 5)
    plot_duration_boxplots(ref, models, outdir)
    return outdir
