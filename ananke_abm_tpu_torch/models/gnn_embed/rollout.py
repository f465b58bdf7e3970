"""Fused integrate-and-decode rollout for population-scale inference
(port of ``ananke_abm_tpu/models/gnn_embed/rollout.py``).

The carry is the (N, Da) agent state and each output interval emits only
the (N,) zone ids, so memory stays O(N * Da + N * T) whatever the zone
count: the (N, T, Z) logits of ``GATODE.forward`` are never built.

Three bodies, as in the reference:

- the float32 body: ``GATODE.rhs`` under RK4 and ``GATODE.decode`` +
  argmax after every interval; a sparse edge-list zone graph always takes
  it;
- the kernel body: bf16 weights packed once per call, a bf16 decode at
  t=0, then one :func:`rk4_interval_decode_fused` per output interval
  (all substeps plus the decode and argmax);
- the per-step body (:func:`make_pallas_rollout` with
  ``fuse_decode=False``): the same set-up, then ``substeps``
  :func:`rk4_step_fused` launches per interval and the bf16 decode
  :func:`decode_ids_bf16` after each.
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.ode.rk4 import rk4_step
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    BF16,
    decode_ids_bf16,
    interval_stage_times,
    pack_weights_bf16,
    rk4_interval_decode_fused,
    rk4_step_fused,
    stage_kernels_fit,
    time_feature_table,
)


def _kernel_eligible(config, device) -> bool:
    """The kernel body serves when the tensors are on a CUDA device and the
    kernel is compiled for the configuration's widths and residual blocks
    (:func:`stage_kernels_fit`); anything else takes the float32 body, as
    the reference's ``_pallas_eligible`` sends it to its XLA body. The
    route is chosen here, before anything launches: the wrapper itself
    still raises on what the kernel does not take."""
    return torch.device(device).type == "cuda" and stage_kernels_fit(
        config.agent_dim, config.zone_dim, config.context_dim,
        config.hidden_dim, config.num_blocks)


def make_decoded_rollout(model, config, zone_feats, adj, times,
                         use_kernel: str | bool = "auto", edge_index=None,
                         edge_chunks=None):
    """Returns ``rollout(person_feats, home_zone_ids) -> (N, T) int32``
    zone ids, with the decode fused into the integration.

    ``use_kernel``: ``"auto"`` takes the kernel body where
    :func:`_kernel_eligible` holds, else the float32 body; ``True`` forces
    the kernel body (on CPU tensors the interval runs through its plain
    version, as the reference runs Pallas in interpret mode off-TPU);
    ``False`` forces the float32 body.

    Every call reads the module's current parameters, so updated weights
    take effect without a new rollout. ``zone_feats``, ``adj`` and
    ``times`` are tensors on the model's device.

    ``edge_index``: serve with the sparse edge-list zone encoder (``adj``
    may then be None; on CUDA the encoder runs the CSR kernels). As in the
    reference it forces the float32 body, whatever ``use_kernel`` says: the
    kernel body's zone-encode is dense. ``edge_chunks`` is accepted for the
    reference's signature and ignored (the CSR kernels need no chunks).
    """
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got "
                         f"{use_kernel!r}")
    del edge_chunks
    if edge_index is not None:
        use_kernel = False
    if use_kernel == "auto":
        use_kernel = _kernel_eligible(config, zone_feats.device)
    substeps = config.substeps
    if use_kernel:
        body = _kernel_body(model, substeps, rk4_interval_decode_fused)
    else:
        body = _f32_body(model, substeps, edge_index)

    def rollout(person_feats, home_zone_ids):
        with torch.inference_mode():
            return body(zone_feats, adj, times, person_feats,
                        home_zone_ids)

    return rollout


def _f32_body(model, substeps, edge_index=None):
    def body(zone_feats, adj, times, person_feats, home_zone_ids):
        zone_emb = model.encode_zones(zone_feats, adj, edge_index)
        x, h = model.initial_state(person_feats, home_zone_ids, zone_emb)

        def rhs(t, y, args):
            return model.rhs(t, y, h, zone_emb)

        def decode_ids(x):
            logits = model.decode(x, zone_emb)
            return torch.argmax(logits, dim=-1).to(torch.int32)

        ids = [decode_ids(x)]
        for i in range(times.shape[0] - 1):
            t0, t1 = times[i], times[i + 1]
            dt = (t1 - t0) / substeps
            for s in range(substeps):
                x = rk4_step(rhs, t0 + s * dt, dt, x, None)
            ids.append(decode_ids(x))
        return torch.stack(ids, dim=1)

    return body


def make_pallas_rollout(model, zone_feats, adj, times, substeps=2,
                        mesh=None, fuse_decode=False):
    """The reference's kernel rollout: returns ``rollout(person_feats,
    home_zone_ids) -> (N, T) int32`` zone ids.

    ``fuse_decode=False`` (the reference's default) serves through the step
    kernel: ``substeps`` launches of :func:`rk4_step_fused` per output
    interval, then the bf16 decode :func:`decode_ids_bf16` (a plain
    product, as the reference's ``jnp.dot`` outside its kernels);
    ``fuse_decode=True`` through the interval kernel
    :func:`rk4_interval_decode_fused`, as :func:`make_decoded_rollout`'s
    kernel body. Both round the same bf16 decode, so on the plain versions
    they give the same ids. CPU tensors run the kernels' plain versions.

    Every call reads the module's current parameters. ``mesh`` (the
    reference's multi-chip rollout) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_pallas_rollout(mesh=...) over several cards is not ported "
            "yet: ROADMAP.md queue 1 item 11")
    body = (_kernel_body(model, substeps, rk4_interval_decode_fused)
            if fuse_decode else _per_step_body(model, substeps))

    def rollout(person_feats, home_zone_ids):
        with torch.inference_mode():
            return body(zone_feats, adj, times, person_feats,
                        home_zone_ids)

    return rollout


def _kernel_setup(model, substeps, zone_feats, adj, times, person_feats,
                  home_zone_ids):
    """What the kernel bodies share: ``(ze_bf16, weights, wd_bf16, x, h,
    dts, tf_all)``, the bf16 zones, packed weights and decode projection,
    the initial state and context, the substep size of every interval
    (float32 values) and its (4 substeps, H) stage rows."""
    zone_emb = model.encode_zones(zone_feats, adj)
    ze_bf16 = zone_emb.to(BF16)
    weights = pack_weights_bf16(model)
    wd_bf16 = model.decode_proj.weight.T.to(BF16)  # (Da, Dz)
    x, h = model.initial_state(person_feats, home_zone_ids, zone_emb)

    # interval starts and substep sizes in the reference's float32
    # arithmetic, on the host: the kernels take dt as a scalar argument and
    # the per-stage time table is built for all intervals at once
    t_host = times.detach().cpu().numpy().astype(np.float32)
    dts = (t_host[1:] - t_host[:-1]) / np.float32(substeps)
    stage_t = np.asarray([
        interval_stage_times(t0, dt, substeps)
        for t0, dt in zip(t_host[:-1], dts)
    ], np.float32).reshape(-1)
    tf_all = time_feature_table(
        torch.from_numpy(stage_t).to(x.device), weights[3], weights[4],
    ).reshape(len(dts), 4 * substeps, -1)
    return ze_bf16, weights, wd_bf16, x, h, dts, tf_all


def _kernel_body(model, substeps, interval):
    """The kernel body with ``interval`` as its per-interval step:
    :func:`rk4_interval_decode_fused`, or its plain version
    ``rk4_interval_decode_reference`` to check and time the kernel
    against. Callers run it under ``torch.inference_mode()``."""
    def body(zone_feats, adj, times, person_feats, home_zone_ids):
        ze_bf16, weights, wd_bf16, x, h, dts, tf_all = _kernel_setup(
            model, substeps, zone_feats, adj, times, person_feats,
            home_zone_ids)
        # the t=0 ids: the kernel's own bf16 decode, as the reference does
        ids = [decode_ids_bf16(x, wd_bf16, ze_bf16)]
        for i in range(len(dts)):
            x, ids_i = interval(x, h, ze_bf16, weights, wd_bf16, tf_all[i],
                                float(dts[i]))
            ids.append(ids_i)
        return torch.stack(ids, dim=1)

    return body


def _per_step_body(model, substeps, step=rk4_step_fused):
    """The per-step body with ``step`` as its RK4 step:
    :func:`rk4_step_fused`, or its plain version ``rk4_step_reference``.
    Substep ``s`` of an interval takes rows ``4 s .. 4 s + 3`` of its stage
    table: the stage times ``t0 + s dt + (0, dt/2, dt/2, dt)``, the
    reference's per-step ``t0 + i dt`` and ``t + dt/2`` in float32. Callers
    run it under ``torch.inference_mode()``."""
    def body(zone_feats, adj, times, person_feats, home_zone_ids):
        ze_bf16, weights, wd_bf16, x, h, dts, tf_all = _kernel_setup(
            model, substeps, zone_feats, adj, times, person_feats,
            home_zone_ids)
        ids = [decode_ids_bf16(x, wd_bf16, ze_bf16)]
        for i in range(len(dts)):
            for s in range(substeps):
                x = step(x, h, ze_bf16, weights, tf_all[i, 4 * s: 4 * s + 4],
                         float(dts[i]))
            ids.append(decode_ids_bf16(x, wd_bf16, ze_bf16))
        return torch.stack(ids, dim=1)

    return body
