"""Sharded GAT-ODE training and rollout over the (agents x zones) mesh
(port of ``ananke_abm_tpu/parallel/sharded.py``).

Layout, as the reference's annotations lay it out:

- agent arrays (person features, home ids, targets, agent states): each
  rank holds its rows of the batch (``mesh.local_rows``: a DTensor
  sharded over ``agents`` gives its local tensor, a plain tensor holding
  the whole batch gives this rank's rows); the ranks of one zone group
  hold the same rows;
- parameters: replicated; each rank's gradients are its share, summed
  over the ranks that split the work before the optimizer step (so
  ``ClippedAdamW`` clips the reduced gradient, as the reference clips
  after GSPMD's psum);
- the plain step's (N, Z) decode logits tile over ``zones``: the
  log-softmax's maximum and sum of exponentials, and the target's logit,
  are reduced over the zone group.

Every step and rollout computes the single-device value: losses and
accuracies are global-batch means, and a rollout returns the whole (N, T)
grid on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ananke_abm_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_values,
    gather_rows,
    sum_to_replicated,
)
from ananke_abm_tpu_torch.parallel.mesh import (
    AGENT_AXIS,
    ZONE_AXIS,
    axis_size,
    local_rows,
    row_slice,
)


def _optimizer_params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def _local_batch(mesh, *batch):
    """Each batch tensor's local rows, and the global row count."""
    rows = [local_rows(x, mesh) for x in batch]
    n = rows[0][1]
    if n < axis_size(mesh, AGENT_AXIS):
        raise ValueError(f"a batch of {n} rows is smaller than the agent "
                         f"axis ({axis_size(mesh, AGENT_AXIS)} ranks)")
    return [r[0] for r in rows], n


def make_sharded_fused_train_step(model, optimizer, config, mesh, static):
    """The fused train step (``build_fused_loss_fn``: the encoder kernels
    K4f/K4b where they fit, the day kernels K2f/K2b, the cross-entropy
    kernels K3f/K3b) on each rank's agent rows.

    Each rank's loss and accuracy are its sums over the GLOBAL row count;
    the gradients, loss and accuracy are summed over the ``agents`` group,
    and the replicated optimizer steps once per rank. So the step is the
    single-device fused step on the whole batch. ``static`` is the dense
    ``(zone_feats, adj, times)``.

    Returns ``train_step(pf, hz, targets) -> (loss, acc)`` (the global
    means, the same on every rank); it updates the model in place.
    """
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        _unpack_static,
        build_fused_loss_fn,
    )

    zone_feats, adj, times, edge_index, _ = _unpack_static(static)
    if edge_index is not None:
        raise ValueError("the fused train step is dense-only; train a "
                         "sparse zone graph with make_sharded_train_step")
    agents = mesh.get_group(AGENT_AXIS)
    params = _optimizer_params(optimizer)
    T = int(times.shape[0])

    def train_step(pf, hz, targets):
        (pf, hz, tg), n = _local_batch(mesh, pf, hz, targets)
        loss_fn = build_fused_loss_fn(model, config, zone_feats, adj, times,
                                      global_rows=n * T)
        optimizer.zero_grad()
        loss, acc = loss_fn(pf, hz, tg)
        loss.backward()
        all_reduce_grads(params, agents)
        optimizer.step()
        loss, acc = all_reduce_values([loss.detach(), acc.detach()], agents)
        return loss, acc

    return train_step


def _tiled_cross_entropy(logits, targets, zone_rows, zones):
    """Per-row NLL and predicted ids of (n, T, Zb) logits, this rank's
    columns ``zone_rows`` of the (n, T, Z) logits tiled over ``zones``:
    ``logsumexp`` from the zone group's maximum (no gradient: it cancels)
    and summed exponentials, the target's logit summed from the rank that
    holds it; the argmax is the first column of the largest logit, as
    ``torch.argmax`` takes it."""
    zb = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=zones)
    s = sum_to_replicated(torch.exp(logits - m[..., None]).sum(dim=-1), zones)
    inside = (targets >= zone_rows.start) & (targets < zone_rows.stop)
    col = (targets - zone_rows.start).clamp(0, zb - 1)
    t_local = torch.gather(logits, -1, col[..., None])[..., 0]
    t = sum_to_replicated(torch.where(inside, t_local,
                                      torch.zeros_like(t_local)), zones)
    nll = m + torch.log(s) - t
    with torch.no_grad():
        val, idx = logits.max(dim=-1)
        both = torch.stack([val, (idx + zone_rows.start).to(val.dtype)])
        every = all_gather_rows(both[None], zones)  # (mp, 2, n, T)
        best = every[:, 0].argmax(dim=0, keepdim=True)
        pred = torch.gather(every[:, 1], 0, best)[0].long()
    return nll, pred


def make_sharded_train_step(model, optimizer, config, mesh, static,
                            zone_ring: bool = False):
    """The plain training step (autograd through the solver at
    ``config.method``) on each rank's agent rows, the decode's logits
    tiled over ``zones``.

    ``static`` is ``(zone_feats, adj, times)`` or the 4-element sparse
    form ``(zone_feats, adj_or_None, times, edge_index)`` (the encoder over
    the edge list on every rank; on the card the CSR kernels). The zone
    embeddings are whole on every rank for the drift.
    ``config.method="dopri5"`` trains through the discrete adjoint, its
    controller reading the error norms of the whole batch (one step
    sequence on every rank, the single-device solve's).

    ``zone_ring=True`` encodes the zones with the ring halo exchange
    (``halo.ring_encoder``): each zone rank encodes its block, the key
    blocks rotating around the zone group, and the blocks are gathered.
    Dense adjacency only.

    Returns ``train_step(pf, hz, targets) -> (loss, acc)`` (global means);
    ``train_step.stats`` holds the last dopri5 solve's step counts
    (``stats["forward"]``).
    """
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        _unpack_static,
        functional_rhs,
    )
    from ananke_abm_tpu_torch.ode import odeint, odeint_discrete_adjoint

    zone_feats, adj, times, edge_index, edge_chunks = _unpack_static(static)
    Z = int(zone_feats.shape[0])
    ring_enc = None
    if zone_ring:
        from ananke_abm_tpu_torch.parallel.halo import ring_encoder

        if adj is None:
            raise ValueError(
                "zone_ring=True needs the dense adjacency (the ring "
                "streams (Z, Z) mask columns); got adj=None")
        ring_enc = ring_encoder(mesh, Z, heads=config.gat_heads,
                                num_layers=config.gat_layers)
    if Z < axis_size(mesh, ZONE_AXIS):
        raise ValueError(f"Z={Z} zones cannot tile over "
                         f"{axis_size(mesh, ZONE_AXIS)} zone ranks")
    agents, zones = mesh.get_group(AGENT_AXIS), mesh.get_group(ZONE_AXIS)
    zone_rows = row_slice(Z, mesh, ZONE_AXIS)
    params = _optimizer_params(optimizer)
    T = int(times.shape[0])
    stats: dict = {}
    leaves = fn_rhs = None
    if config.method == "dopri5":
        leaves, fn_rhs = functional_rhs(model)

    def loss_fn(pf, hz, tg, n):
        if ring_enc is not None:
            zone_emb = all_gather_rows(
                ring_enc(model.zone_gat, zone_feats, adj), zones)
        else:
            zone_emb = model.encode_zones(zone_feats, adj, edge_index,
                                          edge_chunks)
        x0, h = model.initial_state(pf, hz, zone_emb)
        if config.method == "dopri5":
            # the adaptive solve trains through the discrete adjoint, the
            # weights threaded as solver args
            xs = odeint_discrete_adjoint(
                fn_rhs, x0, times,
                (tuple(p for _, p in leaves), h, zone_emb),
                rtol=config.rtol, atol=config.atol, stats=stats,
                group=agents)
        else:
            xs = odeint(lambda t, x, _a: model.rhs(t, x, h, zone_emb), x0,
                        times, method=config.method,
                        substeps=config.substeps, rtol=config.rtol,
                        atol=config.atol, adjoint=False)
        logits = model.decode(xs.transpose(0, 1), zone_emb[zone_rows])
        nll, pred = _tiled_cross_entropy(logits, tg, zone_rows, zones)
        loss = sum_to_replicated(nll.sum(), agents) / (n * T)
        return loss, (pred == tg).float().sum()

    def train_step(pf, hz, targets):
        (pf, hz, tg), n = _local_batch(mesh, pf, hz, targets)
        optimizer.zero_grad()
        loss, correct = loss_fn(pf, hz, tg, n)
        loss.backward()
        # each rank's gradient is the share of its rows and its zone tile
        all_reduce_grads(params, dist.group.WORLD)
        optimizer.step()
        acc = all_reduce_values([correct], agents)[0] / (n * T)
        return loss.detach(), acc

    train_step.stats = stats
    return train_step


def make_sharded_rollout(model, config, mesh, static):
    """Forward-only integrate-then-decode on each rank's agent rows
    (``GATODE.forward`` at ``config.method``; a dopri5 solve's controller
    reads the whole batch's error norms). ``static``: the 3- or 4-element
    form of :func:`make_sharded_train_step`.

    Returns ``rollout(pf, hz) -> (N, T) int32`` zone ids, the whole grid on
    every rank (gathered over ``agents``); any N works."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import _unpack_static
    from ananke_abm_tpu_torch.ode import odeint

    zone_feats, adj, times, edge_index, edge_chunks = _unpack_static(static)
    agents = mesh.get_group(AGENT_AXIS)

    def rollout(pf, hz):
        (pf, n), (hz, _) = local_rows(pf, mesh), local_rows(hz, mesh)
        with torch.inference_mode():
            zone_emb = model.encode_zones(zone_feats, adj, edge_index,
                                          edge_chunks)
            x0, h = model.initial_state(pf, hz, zone_emb)
            xs = odeint(lambda t, x, _a: model.rhs(t, x, h, zone_emb), x0,
                        times, method=config.method,
                        substeps=config.substeps, rtol=config.rtol,
                        atol=config.atol, adjoint=False, group=agents)
            logits = model.decode(xs.transpose(0, 1), zone_emb)
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            return gather_rows(ids, n, agents)

    return rollout


__all__ = ["make_sharded_train_step", "make_sharded_fused_train_step",
           "make_sharded_rollout"]
