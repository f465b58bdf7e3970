"""Transition CRF refinement over VAE unaries."""
