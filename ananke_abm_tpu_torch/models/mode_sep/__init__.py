"""mode_sep: the 2nd-order ODE location-only trajectory model (port of
``ananke_abm_tpu/models/mode_sep``)."""
from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig


def train_from_yaml(data_paths_yaml: str, outdir: str, config=None, *,
                    device="cuda", **kw):
    """Train from a data-paths YAML (``load_data_paths_yaml``'s keys)."""
    from ananke_abm_tpu_torch.models.mode_sep.data import (
        load_data_paths_yaml,
    )
    from ananke_abm_tpu_torch.models.mode_sep.train import train

    paths = load_data_paths_yaml(data_paths_yaml)
    return train(
        paths["periods_csv"],
        paths["snaps_csv"],
        outdir,
        config=config,
        zones_csv=paths.get("zones_csv"),
        persons_csv=paths.get("persons_csv"),
        dist_mat_csv=paths.get("dist_mat_csv"),
        device=device,
        **kw,
    )


__all__ = ["ModeSepConfig", "train_from_yaml"]
