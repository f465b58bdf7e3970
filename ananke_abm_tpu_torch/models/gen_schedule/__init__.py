"""gen_schedule: the discrete daily-schedule VAE (+ CRF) population
synthesis (port of ``ananke_abm_tpu/models/gen_schedule``)."""
