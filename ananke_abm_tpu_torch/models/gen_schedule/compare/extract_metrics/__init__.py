"""Metric registry (the port's copy of
``ananke_abm_tpu/models/gen_schedule/compare/extract_metrics/__init__.py``;
reference extract_metrics/metrics.py:8-15): METRIC_FUNCS = ToD ∪ duration ∪
general ∪ raw_counts ∪ SRMSE ∪ diversity."""
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.diversity import (
    DIVERSITY_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.duration_jsd import (
    DURATION_JSD_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.general import (
    GENERAL_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.raw_counts import (
    RAW_COUNTS_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.srmse import (
    SRMSE_FUNCS,
)
from ananke_abm_tpu_torch.models.gen_schedule.compare.extract_metrics.tod_jsd import (
    TOD_JSD_FUNCS,
)

METRIC_FUNCS = {
    **TOD_JSD_FUNCS,
    **DURATION_JSD_FUNCS,
    **GENERAL_FUNCS,
    **RAW_COUNTS_FUNCS,
    **SRMSE_FUNCS,
    **DIVERSITY_FUNCS,
}

__all__ = ["METRIC_FUNCS"]
