"""Batched inference for the GenerativeODE (port of
``ananke_abm_tpu/models/latent_ode/inference.py``):

- load a checkpoint of either package and the personas' batch;
- ``predict_trajectories(num_samples)``: stochastic rollouts stacked into
  (people, samples, times) argmax ids of zone, purpose and mode;
- ``benchmark_performance``: people/s at several batch sizes and the
  projected hours for one million people, each timing synced on a value
  read from the device.

The reference vmaps its samples inside one program; here the samples run
one after another, sample ``s`` drawing from ``utils.seed.generator(
device, seed, s)``.

Under a mesh the person axis of every batch array (``PERSON_AXIS_KEYS``)
splits over the ``agents`` axis: each rank runs its people, drawing the
whole batch's noise and keeping its rows (``utils.seed.RowDraws``, whose
group also carries a dopri5 solve's one controller), and the ids are
gathered, so every rank returns the single-device arrays.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.latent_ode.config import GenerativeODEConfig
from ananke_abm_tpu_torch.models.latent_ode.data import (
    get_person_sample,
    unify_and_interpolate_batch,
)
from ananke_abm_tpu_torch.models.latent_ode.model import (
    GenerativeODE,
    load_flax_params,
)
from ananke_abm_tpu_torch.models.latent_ode.train import (
    batch_to_device,
    make_forward,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
from ananke_abm_tpu_torch.utils.seed import generator

# batch arrays whose leading axis is the person axis
PERSON_AXIS_KEYS = (
    "person_features", "home_zone_ids", "work_zone_ids",
    "initial_purpose_features", "initial_mode_features",
    "y_loc_dense", "y_purp_dense", "y_mode_dense",
    "y_purp_feat_dense", "y_mode_feat_dense", "loss_mask",
    "prev_real_indices", "next_real_indices",
)


def _cfg_from_dict(d: dict) -> GenerativeODEConfig:
    fields = {f.name for f in dataclasses.fields(GenerativeODEConfig)}
    d = {k: v for k, v in d.items() if k in fields}
    if "purpose_groups" in d:
        d["purpose_groups"] = tuple(d["purpose_groups"])
    return GenerativeODEConfig(**d)


class BatchedInferenceEngine:
    def __init__(self, ckpt_path: str, person_ids=(1, 2), mesh=None, *,
                 device="cuda"):
        """``mesh``: an (agents, zones) ``parallel.make_mesh`` mesh over
        which the person axis shards (the module's notes). ``device``: the
        card unless the caller asks for the CPU (no fallback)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        obj = load_checkpoint(ckpt_path)
        self.config = _cfg_from_dict(obj["config"])
        self.person_ids = list(person_ids)
        samples = [get_person_sample(p, self.config)
                   for p in self.person_ids]
        host = unify_and_interpolate_batch(samples, self.config)
        self.times = host["t_unified"].astype(np.float32)
        self.batch = batch_to_device(host, self.device)
        self.model = GenerativeODE(host["person_features"].shape[-1],
                                   host["all_zone_features"].shape[-1],
                                   self.config).to(self.device)
        load_flax_params(self.model, obj["params"])
        self.model.eval()
        self._forward = make_forward(self.model)

    def _times(self, times):
        return self.times if times is None else np.asarray(times, np.float32)

    def _run(self, b, gen, eps=None, noise=None, times=None):
        """The forward's outputs (0, 2, 3) (zone, purpose and mode logits)
        of batch ``b``, the argmax ids; under the mesh on this rank's
        people (``eps`` (B, ...) and ``noise`` (steps, B, ...) whole-batch
        draws), the ids gathered."""
        if self.mesh is None:
            o = self._forward(b, gen, eps, noise, times)
            return [torch.argmax(o[k], -1) for k in (0, 2, 3)]
        from ananke_abm_tpu_torch.parallel.collectives import gather_rows
        from ananke_abm_tpu_torch.parallel.mesh import (
            AGENT_AXIS,
            row_slice,
        )
        from ananke_abm_tpu_torch.utils.seed import RowDraws

        n = b["person_features"].shape[0]
        rows, agents = row_slice(n, self.mesh), self.mesh.get_group(AGENT_AXIS)
        local = {k: v[rows] if k in PERSON_AXIS_KEYS else v
                 for k, v in b.items()}
        o = self._forward(
            local, RowDraws(gen, rows, n, agents),
            None if eps is None else eps[rows],
            None if noise is None else noise[:, rows], times)
        return [gather_rows(torch.argmax(o[k], -1), n, agents)
                for k in (0, 2, 3)]

    def predict_trajectories(self, num_samples: int = 3, times=None,
                             seed: int = 0, draws=None):
        """Returns a dict of (people, samples, times) int32 argmax ids
        (``zones``, ``purposes``, ``modes``) and ``times``. ``draws``: one
        ``(eps, noise)`` pair per sample replacing its draws."""
        times = self._times(times)
        out = []
        with torch.inference_mode():
            for s in range(num_samples):
                eps, noise = (None, None) if draws is None else draws[s]
                out.append(torch.stack(self._run(
                    self.batch, generator(self.device, seed, s), eps, noise,
                    times)))
        ids = torch.stack(out, dim=2).to(torch.int32).cpu().numpy()
        return {"zones": ids[0], "purposes": ids[1], "modes": ids[2],
                "times": times}

    def benchmark_performance(self, batch_sizes=(1, 10, 50, 100),
                              times=None):
        """people/s per batch size + projected 1M-person wall time. Each
        batch size: one warm call, then 5 timed calls, the clock stopped
        after a value read from the device (which waits for all 5)."""
        times = self._times(times)
        results = {}
        b0 = self.batch
        n0 = b0["person_features"].shape[0]

        def run(b, gen):
            with torch.inference_mode():
                return self._run(b, gen, times=times)[0]

        for bs in batch_sizes:
            reps = int(np.ceil(bs / n0))
            b = dict(b0)
            for k in PERSON_AXIS_KEYS:
                b[k] = torch.cat([b0[k]] * reps, dim=0)[:bs]
            float(run(b, generator(self.device, 0)).sum())  # warm
            t0 = time.time()
            n_iter = 5
            for i in range(n_iter):
                v = run(b, generator(self.device, 0, i))
            float(v.sum())  # in order: waits for all n_iter calls
            dt = (time.time() - t0) / n_iter
            results[bs] = {
                "people_per_s": bs / dt,
                "ms_per_person": 1e3 * dt / bs,
                "s_per_batch": dt,
            }
        best = max(r["people_per_s"] for r in results.values())
        results["projected_1M_people_hours"] = 1e6 / best / 3600.0
        return results
