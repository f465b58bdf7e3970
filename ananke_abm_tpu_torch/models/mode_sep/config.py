"""mode_sep configuration (port of
``ananke_abm_tpu/models/mode_sep/config.py``: the same knobs and
defaults; the device is an argument of the entry points)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModeSepConfig:
    seed: int = 42

    # embedding & context dims
    emb_dim: int = 64  # E: location embedding
    context_dim: int = 32  # H: static person context
    zone_emb_dim: int = 8  # home/work zone id embeddings

    # drift network
    hidden_dim: int = 128
    num_res_blocks: int = 2

    # time grid & solver
    K_internal: int = 8  # internal points between adjacent snaps
    ode_method: str = "rk4"  # {"rk4", "dopri5"}
    rk4_substeps: int = 4  # fixed substeps per output interval (rk4)
    rtol: float = 1e-5
    atol: float = 1e-5
    time_match_tol: float = 1e-6

    # SDE (sde_noise_strength=0 recovers deterministic behavior).
    # sde_dt: fixed internal grid (reference torchsde euler dt=0.01) —
    # makes the noise path independent of the union-grid choice, so
    # train/inference grids decode the same trajectory; None falls back
    # to per-interval substeps.
    enable_sde: bool = False
    sde_noise_strength: float = 0.01
    sde_dt: float = 0.01
    sde_span_hours: float = 24.0
    sde_substeps: int = 8  # legacy per-interval mode (sde_dt = None)

    # loss weights
    softmax_tau: float = 0.2
    w_ce: float = 1.0
    w_mse: float = 0.5
    w_dist: float = 0.5
    w_stay_aux: float = 0.9
    w_stay_vel_core: float = 5.0
    w_move_vel_hinge: float = 1.0
    v_min_move: float = 0.2
    v_max_move: float = 1.0
    w_travel_margin: float = 1.0
    w_travel_mono: float = 0.5
    m_travel: float = 0.10
    epsilon_mono: float = 0.01
    tau_stay_embed: float = 0.10

    # training
    max_epochs: int = 2000
    batch_size: int = 2
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    # evaluation / plots
    dense_resolution: int = 500
    transition_window_h: float = 0.25

    # IO
    checkpoints_dir: str = "saved_models/mode_sep/checkpoints"
    figures_dir: str = "saved_models/mode_sep/figures"
    runs_dir: str = "saved_models/mode_sep/runs"
