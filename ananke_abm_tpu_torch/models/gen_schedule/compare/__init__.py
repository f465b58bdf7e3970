"""Multi-model comparison harness (metric tables + overview plots): the
port's copy of ``ananke_abm_tpu/models/gen_schedule/compare``."""
