"""latent_ode: the generative latent SDE/ODE trajectory family (location,
purpose and mode; port of ``ananke_abm_tpu/models/latent_ode``)."""
