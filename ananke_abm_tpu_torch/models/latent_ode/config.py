"""GenerativeODE configuration (port of
``ananke_abm_tpu/models/latent_ode/config.py``: the same knobs and
defaults)."""
from __future__ import annotations

import dataclasses

from ananke_abm_tpu_torch.data_generator.features import (
    NUM_MODES,
    PURPOSE_NAMES,
    get_feature_dimensions,
)

MODE_FEAT_DIM, PURPOSE_FEAT_DIM = get_feature_dimensions()


@dataclasses.dataclass
class GenerativeODEConfig:
    hidden_dim: int = 32
    encoder_hidden_dim: int = 64
    ode_hidden_dim: int = 128
    zone_embed_dim: int = 8

    purpose_feature_dim: int = PURPOSE_FEAT_DIM
    mode_feature_dim: int = MODE_FEAT_DIM

    num_residual_blocks: int = 2

    # physics-constraint correction inside the RHS
    correction_strength: float = 1.0
    use_second_order_sde: bool = True

    # training
    learning_rate: float = 1e-3
    kl_weight: float = 0.5
    num_iterations: int = 25000

    # composite loss weights
    loss_weight_classification: float = 1.0
    loss_weight_embedding: float = 0.5
    loss_weight_distance: float = 2.0
    loss_weight_purpose_class: float = 0.75
    loss_weight_mode_class: float = 1.0
    loss_weight_purpose_mse: float = 0.5
    loss_weight_mode_mse: float = 0.5

    anchor_loss_weight: float = 15.0
    train_on_interpolated_points: bool = False

    # solver
    ode_method: str = "dopri5"
    rtol: float = 1e-5
    atol: float = 1e-5
    rk4_substeps: int = 4

    # SDE — fixed internal grid (reference: torchsde euler dt=0.01 over
    # the day span, latent_ode/architecture/model.py:194). The internal
    # grid makes the discretization AND the noise path independent of
    # the requested output times, so training on event grids and
    # evaluating on dense grids decode the SAME trajectory (round 3:
    # per-interval substeps broke this — train acc 1.0, dense-grid
    # inference acc ~0).
    enable_sde: bool = True
    sde_noise_strength: float = 0.1
    sde_dt: float = 0.01  # hours, reference default
    sde_span_hours: float = 24.0  # internal grid length (static steps)
    sde_substeps: int = 25  # legacy per-interval mode (sde_dt = None)

    num_modes: int = NUM_MODES
    purpose_groups: tuple = tuple(PURPOSE_NAMES)

    @property
    def position_dim(self) -> int:
        return self.zone_embed_dim + self.purpose_feature_dim + self.mode_feature_dim

    @property
    def state_dim(self) -> int:
        return self.position_dim * 2 if self.use_second_order_sde else self.position_dim
