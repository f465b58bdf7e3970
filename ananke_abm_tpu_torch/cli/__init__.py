"""Command-line entry points of the port, run as modules
(``python -m ananke_abm_tpu_torch.cli.rgen_schedule``)."""
