"""Cross-cutting utilities: config, seeding, checkpointing, logging."""
from ananke_abm_tpu_torch.utils.cfg import ensure_dir, load_config
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from ananke_abm_tpu_torch.utils.seed import set_seed

__all__ = [
    "load_config",
    "ensure_dir",
    "save_checkpoint",
    "load_checkpoint",
    "set_seed",
]
