"""The schedule VAE's pipelines: fit, sample, evaluate."""
