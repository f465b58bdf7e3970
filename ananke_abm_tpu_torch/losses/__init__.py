"""Pure loss functions shared across model families (the port's
``ananke_abm_tpu.losses``)."""
from ananke_abm_tpu_torch.losses.jsd import jsd
from ananke_abm_tpu_torch.losses.schedule import (
    cross_entropy_masked,
    kl_gaussian,
    minutes_share_loss,
    presence_rate_loss,
    start_end_home_loss,
    time_of_day_marginal_loss,
    time_total_variation,
)

__all__ = [
    "kl_gaussian",
    "time_total_variation",
    "start_end_home_loss",
    "time_of_day_marginal_loss",
    "presence_rate_loss",
    "minutes_share_loss",
    "cross_entropy_masked",
    "jsd",
]
