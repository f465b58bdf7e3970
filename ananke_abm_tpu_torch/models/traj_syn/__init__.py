"""traj_syn (TrajEmbed): a purpose-catalog-conditioned trajectory VAE with
linear-CRF or semi-CRF structured decoding (port of
``ananke_abm_tpu/models/traj_syn``)."""
