"""TransitionCRF in functional form: a full transition matrix ``A`` and a
per-state bias over the VAE's unaries (port of
``ananke_abm_tpu/models/gen_schedule/crf/model.py``). The bias takes part
in the NLL and in decoding, as in the JAX package."""
from __future__ import annotations

import torch

from ananke_abm_tpu_torch.ops.crf import (
    crf_nll,
    viterbi_decode,
    viterbi_decode_no_all_home,
)


def init_crf_params(generator: torch.Generator, num_purposes: int,
                    init_scale: float = 0.01) -> dict:
    """{"A": U(-init_scale, init_scale) (P, P), "bias": zeros (P,)} on the
    generator's device."""
    dev = generator.device
    A = torch.rand((num_purposes, num_purposes), generator=generator,
                   device=dev)
    return {"A": (2.0 * A - 1.0) * init_scale,
            "bias": torch.zeros(num_purposes, device=dev)}


def crf_nll_loss(params, unaries_btp, labels_bt, group=None):
    u = unaries_btp + params["bias"][None, None, :]
    return crf_nll(u, labels_bt, params["A"], group=group)


def crf_decode(params, unaries_btp, home_idx=None, enforce_nonhome=False):
    u = unaries_btp + params["bias"][None, None, :]
    if enforce_nonhome:
        if home_idx is None:
            raise ValueError("home_idx required for enforce_nonhome decoding")
        return viterbi_decode_no_all_home(u, params["A"], home_idx)
    return viterbi_decode(u, params["A"])

