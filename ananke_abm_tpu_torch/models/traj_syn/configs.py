"""traj_syn configuration (the port's copy of
``ananke_abm_tpu/models/traj_syn/configs.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CRFConfig:
    crf_mode: str = "linear"  # {"linear", "semi"}
    semi_Dmax_minutes: int = 300  # max segment duration for semi-CRF
    grid_min: int = 5
    enforce_nonhome: bool = False
    # semi mode: the exact likelihood of gold grids with runs > Dmax via
    # the self-transition marginal (ops/semi_crf.py::
    # semicrf_gold_log_marginal); False: the clip-scored bound with
    # no-self-transition decoding
    exact_long: bool = True

    @property
    def Dmax_bins(self) -> int:
        return max(1, self.semi_Dmax_minutes // self.grid_min)


@dataclasses.dataclass
class TrajEmbedConfig:
    grid_min: int = 5
    horizon_min: int = 1800  # 30 h allocation horizon
    z_dim: int = 16
    emb_dim: int = 128
    cnn_channels: tuple = (64, 64)
    cnn_kernel: int = 5
    cnn_dropout: float = 0.1
    purpose_feat_dim: int = 8  # catalog features per purpose (FiLM input)

    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    beta_target: float = 1.0
    beta_warm_frac: float = 0.3
    lambda_crf: float = 1.0

    @property
    def L(self) -> int:
        return self.horizon_min // self.grid_min
