"""Ring halo exchange for the zone-sharded GAT encoder (port of
``ananke_abm_tpu/parallel/halo.py``).

The (Z, Z) zone-graph attention shards its rows over the ``zones`` mesh
axis; each shard's queries still attend over every zone. Instead of
gathering the whole key table, the key blocks ``(Wh, e_dst)`` rotate
around the ``zones`` group (:func:`collectives.ring_shift`, one neighbour
hop a step, ``batch_isend_irecv``) with online-softmax accumulation:
O(Z / mp) peak zone-table memory a rank. The backward shifts the other
way.

The accumulation subtracts the running maximum with the ``NEG = -1e30``
mask, so the ring reproduces ``ZoneGAT``'s max-subtracted softmax (not the
encoder kernels' max-free one): :func:`encode_zones_ring` equals
``GATODE.encode_zones`` from the same parameters.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ananke_abm_tpu_torch.parallel.collectives import (
    all_gather_rows,
    ring_shift,
)
from ananke_abm_tpu_torch.parallel.mesh import (
    ZONE_AXIS,
    axis_size,
)

NEG = -1e30  # the mask value of gat.py


def ring_gat_attention(Wh, e_src, e_dst, adj_rows, group, n_shards,
                       col_block, me):
    """One GAT attention layer with the key blocks streamed around the
    ring of ``group`` (``n_shards`` ranks, this one ``me``).

    ``Wh``: (Zl, H, d) this shard's zone projections (its queries and its
    key block); ``e_src`` / ``e_dst``: (Zl, H) the attention logits'
    halves; ``adj_rows``: (Zl, Z) this shard's adjacency rows. Returns
    (Zl, H, d), the masked softmax attention over all Z zones."""
    Zl, H, d = Wh.shape
    m = torch.full((Zl, H), -torch.inf, dtype=Wh.dtype, device=Wh.device)
    l = torch.zeros((Zl, H), dtype=Wh.dtype, device=Wh.device)
    acc = torch.zeros((Zl, H, d), dtype=Wh.dtype, device=Wh.device)
    blk_wh, blk_ed = Wh, e_dst
    for r in range(n_shards):
        # after r hops this rank holds the block of shard me - r
        owner = (me - r) % n_shards
        a = adj_rows[:, owner * col_block:(owner + 1) * col_block]
        scores = F.leaky_relu(e_src[:, None, :] + blk_ed[None, :, :],
                              negative_slope=0.2)  # (Zl, Zb, H)
        scores = torch.where(a[:, :, None] > 0, scores,
                             scores.new_tensor(NEG))
        m_new = torch.maximum(m, scores.amax(dim=1))
        corr = torch.exp(m - m_new)  # exp(-inf - finite) == 0 at r == 0
        p = torch.exp(scores - m_new[:, None, :])
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[..., None] + torch.einsum("ibh,bhd->ihd", p, blk_wh)
        m = m_new
        if r < n_shards - 1:
            blk_wh = ring_shift(blk_wh, group)
            blk_ed = ring_shift(blk_ed, group)
    return acc / l[..., None]


def _zone_gat_local(zone_gat, zone_feats_local, adj_rows_local, *, group,
                    n_shards, col_block, me, heads, num_layers):
    """One shard's ZoneGAT forward (``gnn_embed/gat.py::ZoneGAT``'s
    parameters, its modules' weights), the attention ring-exchanged."""
    h = zone_gat.inp(zone_feats_local)
    for li in range(num_layers):
        layer = zone_gat.layers[li]
        Wh = layer.proj(h)  # no bias
        Zl, Fd = Wh.shape
        Wh = Wh.reshape(Zl, heads, Fd // heads)
        e_src = torch.einsum("zhd,hd->zh", Wh, layer.a_src)
        e_dst = torch.einsum("zhd,hd->zh", Wh, layer.a_dst)
        out = ring_gat_attention(Wh, e_src, e_dst, adj_rows_local, group,
                                 n_shards, col_block, me)
        h = h + F.elu(out.reshape(Zl, Fd))
        h = zone_gat.norms[li](h)
    return h


def ring_encoder(mesh, Z, *, heads, num_layers, axis_name: str = ZONE_AXIS):
    """The ring zone encoder ``(zone_gat, zone_feats, adj) -> this rank's
    (Z / mp, Dz) block of zone embeddings``, ``zone_feats`` and ``adj``
    whole on every rank (each shard reads its rows). The one place the
    ring's contract (divisibility, column block, group) is wired: used by
    :func:`encode_zones_ring` and inside
    ``sharded.make_sharded_train_step(zone_ring=True)``."""
    n_shards = axis_size(mesh, axis_name)
    if Z % n_shards:
        raise ValueError(f"Z={Z} not divisible by {axis_name}={n_shards}")
    col_block = Z // n_shards
    me = mesh.get_local_rank(axis_name)
    rows = slice(me * col_block, (me + 1) * col_block)
    local = functools.partial(
        _zone_gat_local, group=mesh.get_group(axis_name),
        n_shards=n_shards, col_block=col_block, me=me, heads=heads,
        num_layers=num_layers)

    def encode(zone_gat, zone_feats, adj):
        return local(zone_gat, zone_feats[rows], adj[rows])

    return encode


def encode_zones_ring(model, zone_feats, adj, mesh, *, heads, num_layers,
                      axis_name: str = ZONE_AXIS):
    """Zone-sharded ``GATODE.encode_zones`` with the ring halo exchange.

    ``model``: the GATODE (its ``zone_gat`` is read). Returns the (Z, Dz)
    zone embeddings on every rank, the shards gathered over
    ``axis_name`` (the reference's global value)."""
    encode = ring_encoder(mesh, zone_feats.shape[0], heads=heads,
                          num_layers=num_layers, axis_name=axis_name)
    return all_gather_rows(encode(model.zone_gat, zone_feats, adj),
                           mesh.get_group(axis_name))


__all__ = ["NEG", "ring_gat_attention", "ring_encoder", "encode_zones_ring"]
