"""Model factory: cfg + dataset meta -> ScheduleVAE (+ PDS features)
(port of ``ananke_abm_tpu/models/gen_schedule/factory.py``).

``cfg["model"]["method"]`` in {"baseline_cnn", "baseline_rnn",
"auto_pds"}; auto_pds loads ``pds_path`` and stacks (m_tod, start_rate)
into a fixed (P, T, 2) feature tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gen_schedule.vae import ScheduleVAE


def build_model(cfg: dict, meta: dict, *, device="cuda"):
    """Returns (model on ``device``, pds_features tensor or None). The
    weights are PyTorch's defaults: initialise them with
    ``vae.init_params`` or load them with ``params.load_flax_params``."""
    device = resolve_device(device)
    m = cfg["model"]
    method = m["method"]
    common = dict(L=meta["L"], P=len(meta["purpose_map"]), z_dim=m["z_dim"],
                  emb_dim=m["emb_dim"])
    cnn = dict(cnn_channels=tuple(m.get("cnn_channels", [64, 64])),
               cnn_kernel=m.get("cnn_kernel", 5),
               cnn_dropout=m.get("cnn_dropout", 0.1),
               cnn_norm=m.get("cnn_norm", "group"))
    pds_features = None
    if method == "baseline_cnn":
        model = ScheduleVAE(**common, encoder_kind="cnn", **cnn)
    elif method == "baseline_rnn":
        model = ScheduleVAE(
            **common, encoder_kind="rnn",
            rnn_hidden_dim=m.get("rnn_hidden_dim", 64),
            use_emb_layernorm=m.get("use_emb_layernorm", False),
            rnn_cell=m.get("rnn_cell", "gru"))
    elif method == "auto_pds":
        with np.load(m["pds_path"]) as pds:
            feats = np.stack([pds["m_tod"].astype(np.float32),
                              pds["start_rate"].astype(np.float32)], axis=-1)
        pds_features = torch.as_tensor(feats).to(device)  # (P, T, 2)
        model = ScheduleVAE(**common, encoder_kind="cnn", use_pds=True, **cnn)
    else:
        raise ValueError(f"Unknown model.method {method!r}")
    return model.to(device), pds_features
