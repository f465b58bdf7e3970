"""Evaluate a generated population npz against a reference grid (a copy of
``ananke_abm_tpu/models/gen_schedule/pipeline/eval.py``)."""
from __future__ import annotations

import json

import numpy as np

from ananke_abm_tpu_torch.models.gen_schedule.evals.report import (
    make_report,
    save_report,
)


def evaluate(samples_npz, samples_meta_json, reference_grid_npz, out_json):
    with open(samples_meta_json, "r", encoding="utf-8") as f:
        meta = json.load(f)
    purpose_map = meta["purpose_map"]

    Y_synth = np.load(samples_npz)["Y_generated"].astype(np.int64)
    Y_ref = np.load(reference_grid_npz)["Y"].astype(np.int64)

    ref_tod = None
    tod_path = reference_grid_npz.replace(".npz", "_tod.npy")
    try:
        ref_tod = np.load(tod_path)
    except FileNotFoundError:
        pass

    report = make_report(Y_synth, Y_ref, purpose_map, ref_tod=ref_tod)
    save_report(report, out_json)
    return report
