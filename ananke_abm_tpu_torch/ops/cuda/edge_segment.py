"""Sparse edge-list GAT aggregation over a CSR layout: one forward kernel and
one backward kernel.

Port of the edge kernels of ``ananke_abm_tpu/ops/pallas/edge_segment.py``
and ``edge_gather.py``. One kernel pair (CUDA C++ in
``csrc/edge_segment.cu``) replaces four Pallas kernels, each wrapper with its
plain PyTorch version beside it:

- :func:`gat_edge_csr_forward` and :func:`gat_edge_csr_forward_reference`
  replace ``gat_edge_aggregate_pallas`` (K9a, one head),
  ``gat_edge_aggregate_multihead_pallas`` (K9b, all heads) and
  ``gat_edge_aggregate_gather_pallas`` (K9d, the large-Z block-pair form):
  the three compute one function;
- :func:`gat_edge_csr_backward` and :func:`gat_edge_csr_backward_reference`
  replace ``gat_edge_backward_multihead_pallas`` (K9c) and K9d's VJP.

A third kernel of the same source, :func:`segment_sum` with
:func:`segment_sum_reference`, replaces ``segment_sum_pallas`` (K9e): the
sum of bf16-rounded rows by segment id, float32 sums, ids outside
``[0, num_segments)`` dropped.

The function: for every destination row ``i`` and head ``h``, over the edges
``j -> i``, the scores ``s = leaky_relu(e_recv[i, h] + e_send[j, h], 0.2)``,
a softmax with the exact per-destination max subtracted, and ``out[i, h] =
sum_j alpha_ij Wh[j, h]``; the denominator floored at 1e-12, a destination
with no edge 0, a duplicate edge counted twice, everything float32. The
TPU kernels' bf16 features, hi/lo bf16 score pairs, one-hot-matmul gathers
and Cuthill-McKee chunks (``EdgeChunks``, ``build_edge_chunks``) are Mosaic
workarounds (Mosaic cannot gather rows) and have no counterpart: the kernels
gather rows directly from the layout that :func:`build_csr` makes.

Each wrapper takes its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises (a type or width it is not compiled
for, operands on other devices, a refused launch); there is no fallback.
``.launches`` counts the kernel launches. :func:`gat_edge_csr` is the
differentiable entry point; it looks its (forward, backward) pair up in
:data:`KERNELS` at each call, so a caller that holds a whole path against
the plain versions puts :data:`PLAIN` there for the while. What bounds the kernels on the card and what
their design does about it: the note at the top of ``csrc/edge_segment.cu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ananke_abm_tpu_torch.ops.cuda.fused_train import _raise_on
from ananke_abm_tpu_torch.utils.profiling import check_nan

SLOPE = 0.2
DEN_FLOOR = 1e-12
# the widths the CUDA kernels are compiled for: H * d features per row, at
# most MAX_KERNEL_FEATURES (eight 32-lane slots a row), heads of any width
MAX_KERNEL_FEATURES = 256
# the segment sum's widest row: one zone's row per warp in shared memory
# (ananke_segment_sum_max_features in csrc/edge_segment.cu)
MAX_SEGMENT_FEATURES = 3072
# the segment sum's row chunks (each CTA sums one, then the chunks are summed
# in order): one per SEGMENT_CHUNK_ROWS rows, at most SEGMENT_MAX_CHUNKS (two
# CTAs per SM of an H100; the kernel takes up to 384, the chunk sum's tiles
# in shared memory), and at most SEGMENT_PARTIAL_FLOATS / (Z D) so the
# partial sums stay small. Constants: the order of every sum depends on E, Z
# and D alone, and a repeat gives the same bits.
SEGMENT_CHUNK_ROWS = 2048
SEGMENT_MAX_CHUNKS = 264
SEGMENT_PARTIAL_FLOATS = 1 << 22


class CSRLayout(NamedTuple):
    """The kept edges (``dst < num_nodes``) of an edge list in two orders.

    Destination-major: ``row_ptr`` (num_nodes + 1,), and ``src`` / ``dst``
    (E,) in the order of a stable sort by destination. Source-major:
    ``col_ptr`` (num_src + 1,) and ``dst_by_src`` (E,), the same edges
    stably sorted by source. Every index is int32 on the edges' device.
    """

    row_ptr: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    col_ptr: torch.Tensor
    dst_by_src: torch.Tensor
    num_nodes: int
    num_src: int
    num_recv: int


def _offsets(ids, n):
    """(n + 1,) int32 CSR offsets of the sorted int64 ``ids`` in [0, n)."""
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    if ids.numel():
        ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    return ptr


def kept_edges(edge_src, edge_dst, num_nodes, num_src, num_recv=None):
    """``(src, dst)``, int64 on the edges' device: the edges ``edge_src ->
    edge_dst`` whose destination is below ``num_nodes``, in their order (the
    others are dropped: the ``segment_sum`` contract).

    A negative id, a source outside ``[0, num_src)`` or a kept destination
    outside ``[0, num_recv)`` (default ``num_src``: the receiving logits'
    rows) raises ``IndexError``. The range check is one host read; picking
    the kept edges costs a second one only when some are dropped.
    """
    num_nodes, num_src = int(num_nodes), int(num_src)
    num_recv = num_src if num_recv is None else int(num_recv)
    src = torch.as_tensor(edge_src).reshape(-1).long()
    dst = torch.as_tensor(edge_dst).reshape(-1).long().to(src.device)
    if src.shape != dst.shape:
        raise ValueError(f"{src.numel()} sources and {dst.numel()} "
                         f"destinations")
    if not src.numel():
        return src, dst
    kept = dst < num_nodes
    lo_s, hi_s, lo_d, n_kept, hi_kept = torch.stack([
        src.min(), src.max(), dst.min(), kept.sum(),
        torch.where(kept, dst, -1).max()]).tolist()
    if lo_s < 0 or hi_s >= num_src:
        raise IndexError(f"source ids span [{lo_s}, {hi_s}], outside "
                         f"[0, {num_src})")
    if lo_d < 0:
        raise IndexError(f"negative destination id {lo_d}")
    if hi_kept >= num_recv:
        raise IndexError(f"destination id {hi_kept} has no receiving logit "
                         f"(num_recv={num_recv})")
    if n_kept == src.numel():
        return src, dst
    return src[kept], dst[kept]


def build_csr(edge_src, edge_dst, num_nodes, num_src, num_recv=None):
    """The :class:`CSRLayout` of the edges ``edge_src -> edge_dst`` for
    ``num_nodes`` destination rows, sources in ``[0, num_src)`` and
    receiving logits with ``num_recv`` rows (default ``num_src``), built on
    the edges' device. :func:`kept_edges` keeps, drops and refuses them.
    """
    num_nodes, num_src = int(num_nodes), int(num_src)
    num_recv = num_src if num_recv is None else int(num_recv)
    src, dst = kept_edges(edge_src, edge_dst, num_nodes, num_src, num_recv)
    order = torch.argsort(dst, stable=True)
    src_c, dst_c = src[order], dst[order]
    by_src = torch.argsort(src_c, stable=True)
    return CSRLayout(
        row_ptr=_offsets(dst_c, num_nodes), src=src_c.int(), dst=dst_c.int(),
        col_ptr=_offsets(src_c[by_src], num_src),
        dst_by_src=dst_c[by_src].int(), num_nodes=num_nodes,
        num_src=num_src, num_recv=num_recv)


def _lrelu(s):
    return torch.where(s >= 0, s, SLOPE * s)


def gat_edge_csr_forward_reference(wh, e_recv, e_send, layout):
    """Plain PyTorch version of the forward, in float32.

    wh: (Zs, H, d); e_recv: (num_recv, H); e_send: (Zs, H); layout: from
    :func:`build_csr`. Returns ``(out (num_nodes, H, d), lse (num_nodes,
    H))``: ``lse = m + log(sum_j exp(s - m))`` per destination and head
    (what the backward recomputes alpha from), 0 for a row with no edge.
    """
    Zd = layout.num_nodes
    H, d = wh.shape[1:]
    src, dst = layout.src.long(), layout.dst.long()
    s = _lrelu(e_recv[dst] + e_send[src])  # (E, H)
    m = s.new_full((Zd, H), -torch.inf).scatter_reduce_(
        0, dst[:, None].expand(-1, H), s, "amax")
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(s - m[dst])
    den = s.new_zeros((Zd, H)).index_add_(0, dst, ex)
    alpha = ex / torch.clamp_min(den[dst], DEN_FLOOR)
    out = wh.new_zeros((Zd, H, d)).index_add_(0, dst,
                                              wh[src] * alpha[..., None])
    lse = torch.where(den > 0, m + torch.log(den), 0.0)
    return out, lse


def gat_edge_csr_backward_reference(g, wh, e_recv, e_send, lse, corr,
                                    layout):
    """Plain PyTorch version of the backward, in float32.

    g: (num_nodes, H, d) the output's cotangent; lse from the forward; corr:
    (num_nodes, H) ``<g_i, out_i>`` per head. Per edge ``alpha = exp(s -
    lse[i])`` and ``ds = alpha (<g_i, Wh_j> - corr_i) leaky_relu'(s)``.
    Returns ``(d_wh (Zs, H, d), d_recv (num_recv, H), d_send (Zs, H))``.
    """
    src, dst = layout.src.long(), layout.dst.long()
    pre = e_recv[dst] + e_send[src]
    alpha = torch.exp(_lrelu(pre) - lse[dst])
    gd = g[dst]  # (E, H, d)
    t = torch.sum(gd * wh[src], dim=-1)
    ds = alpha * (t - corr[dst]) * torch.where(pre >= 0, 1.0, SLOPE)
    d_wh = torch.zeros_like(wh).index_add_(0, src, alpha[..., None] * gd)
    d_recv = torch.zeros_like(e_recv).index_add_(0, dst, ds)
    d_send = torch.zeros_like(e_send).index_add_(0, src, ds)
    return d_wh, d_recv, d_send


def kernels_fit(heads, d) -> bool:
    """Whether the kernels take ``heads`` heads of ``d`` features: the rule
    their wrappers enforce on CUDA tensors, for callers to choose a route
    before anything launches."""
    return heads >= 1 and d >= 1 and heads * d <= MAX_KERNEL_FEATURES


def _check(name, wh, e_recv, e_send, layout, more=()):
    """Validate the operands; returns (Zs, H, d). ``more``: (name, tensor,
    shape) float32 operands besides the three node tables."""
    if wh.dim() != 3:
        raise ValueError(f"{name}: wh must be (Zs, H, d), got "
                         f"{tuple(wh.shape)}")
    Zs, H, d = wh.shape
    want = [("wh", wh, (layout.num_src, H, d)),
            ("e_recv", e_recv, (layout.num_recv, H)),
            ("e_send", e_send, (Zs, H)), *more]
    for key, t, shape in want:
        if t.device != wh.device:
            raise ValueError(f"{name}: {key} is on {t.device}, wh on "
                             f"{wh.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if layout.row_ptr.device != wh.device:
        raise ValueError(f"{name}: the layout is on {layout.row_ptr.device}, "
                         f"wh on {wh.device}")
    return Zs, H, d


def _kernel_device(name, wh, H, d):
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    if wh.device.type == "cpu":
        return False
    if wh.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {wh.device}")
    if not kernels_fit(H, d):
        raise ValueError(
            f"{name}: the CUDA kernel is compiled for at most "
            f"{MAX_KERNEL_FEATURES} features a row; got {H} heads of {d}")
    return True


def _lib():
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    return load_library("edge_segment")


def gat_edge_csr_forward(wh, e_recv, e_send, layout):
    """The forward. Arguments and result as
    :func:`gat_edge_csr_forward_reference`; on CUDA the forward kernel: a
    group of lanes owns a destination row, loads its edge indices in
    batches and walks them twice, for the exact max and then for the
    sums in edge order. No atomics: the same operands give the same
    bits."""
    Zs, H, d = _check("gat_edge_csr_forward", wh, e_recv, e_send, layout)
    if not _kernel_device("gat_edge_csr_forward", wh, H, d):
        return gat_edge_csr_forward_reference(wh, e_recv, e_send, layout)
    Zd, dev = layout.num_nodes, wh.device
    out = torch.empty((Zd, H, d), dtype=torch.float32, device=dev)
    lse = torch.empty((Zd, H), dtype=torch.float32, device=dev)
    if Zd == 0:
        return out, lse
    lib = _lib()
    ops = [wh.contiguous(), e_recv.contiguous(), e_send.contiguous(),
           layout.row_ptr, layout.src, out, lse]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_edge_csr_forward(*[t.data_ptr() for t in ops], Zd,
                                          H, d, stream)
    _raise_on(lib, err, "gat_edge_csr_forward")
    gat_edge_csr_forward.launches += 1
    check_nan("gat_edge_csr_forward", out, lse)
    return out, lse


gat_edge_csr_forward.launches = 0


def gat_edge_csr_backward(g, wh, e_recv, e_send, lse, corr, layout):
    """The backward. Arguments and result as
    :func:`gat_edge_csr_backward_reference`; on CUDA the backward kernel,
    one launch whose first blocks sum ``d_recv`` over destinations and the
    rest ``d_wh`` and ``d_send`` over sources. No atomics: the same operands
    give the same bits."""
    Zd = layout.num_nodes
    Zs, H, d = _check("gat_edge_csr_backward", wh, e_recv, e_send, layout, (
        ("g", g, (Zd, wh.shape[1], wh.shape[2])),
        ("lse", lse, (Zd, wh.shape[1])), ("corr", corr, (Zd, wh.shape[1]))))
    if not _kernel_device("gat_edge_csr_backward", wh, H, d):
        return gat_edge_csr_backward_reference(g, wh, e_recv, e_send, lse,
                                               corr, layout)
    dev, Zr = wh.device, layout.num_recv
    d_wh = torch.empty_like(wh, memory_format=torch.contiguous_format)
    d_recv = torch.empty((Zr, H), dtype=torch.float32, device=dev)
    d_send = torch.empty((Zs, H), dtype=torch.float32, device=dev)
    if Zr + Zs == 0:
        return d_wh, d_recv, d_send
    lib = _lib()
    ops = [g.contiguous(), wh.contiguous(), e_recv.contiguous(),
           e_send.contiguous(), lse.contiguous(), corr.contiguous(),
           layout.row_ptr, layout.src, layout.col_ptr, layout.dst_by_src,
           d_wh, d_recv, d_send]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_edge_csr_backward(*[t.data_ptr() for t in ops], Zd,
                                           Zr, Zs, H, d, stream)
    _raise_on(lib, err, "gat_edge_csr_backward")
    gat_edge_csr_backward.launches += 1
    check_nan("gat_edge_csr_backward", d_wh, d_recv, d_send)
    return d_wh, d_recv, d_send


gat_edge_csr_backward.launches = 0


def segment_sum_reference(values, segment_ids, num_segments):
    """Plain PyTorch version of the segment-sum kernel: ``values`` (E, D)
    float32 rounded to bf16, summed in float32 into (num_segments, D) by
    ``segment_ids`` (E,) (any integer type, unsorted); ids outside
    ``[0, num_segments)``, negative ones included, are dropped (as
    ``jax.ops.segment_sum`` drops them) and an empty segment is 0."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, ids[keep],
                          values[keep].to(torch.bfloat16).float())


def segment_sum_fits(d) -> bool:
    """Whether the segment-sum kernel takes rows of ``d`` values: the rule
    its wrapper enforces on CUDA tensors (any row and segment count)."""
    return 1 <= d <= MAX_SEGMENT_FEATURES


def segment_chunks(e, z, d) -> int:
    """Row chunks of the segment sum of ``e`` rows of ``d`` values into ``z``
    segments (the constants above)."""
    cap = max(1, SEGMENT_PARTIAL_FLOATS // (z * d))
    return max(1, min(-(-e // SEGMENT_CHUNK_ROWS), SEGMENT_MAX_CHUNKS, cap,
                      e))


def segment_sum(values, segment_ids, num_segments):
    """The segment sum: port of ``segment_sum_pallas``. Arguments and result
    as :func:`segment_sum_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/edge_segment.cu`` (float32 values, rows of at most
    MAX_SEGMENT_FEATURES, any ``num_segments``), or raise; there is no
    fallback. Ids are handed to the kernel as int32, those outside
    ``[0, num_segments)`` sent to -1 first (the kernel drops every id
    outside the range). Each warp streams its rows in batches whose value
    loads do not wait for the ids and overlap the previous batch's adds;
    the chunks' partial sums are summed in order by a second grid. No
    atomics: the same operands give the same bits. ``.launches`` counts
    the kernel launches (both grids of a call count once)."""
    name = "segment_sum"
    if values.dim() != 2 or segment_ids.dim() != 1:
        raise ValueError(f"{name}: values must be (E, D) and segment_ids "
                         f"(E,), got {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    E, D = values.shape
    Z = int(num_segments)
    if segment_ids.shape[0] != E:
        raise ValueError(f"{name}: {segment_ids.shape[0]} ids for {E} rows")
    if segment_ids.device != values.device:
        raise ValueError(f"{name}: segment_ids is on {segment_ids.device}, "
                         f"values on {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, got "
                        f"{values.dtype}")
    if segment_ids.dtype.is_floating_point or segment_ids.dtype.is_complex \
            or segment_ids.dtype == torch.bool:
        raise TypeError(f"{name}: segment_ids must be integers, got "
                        f"{segment_ids.dtype}")
    if Z < 1:
        raise ValueError(f"{name}: num_segments must be >= 1, got {Z}")
    if values.device.type == "cpu":
        return segment_sum_reference(values, segment_ids, Z)
    if values.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {values.device}")
    if not segment_sum_fits(D):
        raise ValueError(f"{name}: the CUDA kernel takes rows of 1 to "
                         f"{MAX_SEGMENT_FEATURES} values, got {D}")
    dev = values.device
    out = torch.empty((Z, D), dtype=torch.float32, device=dev)
    if E == 0:
        return out.zero_()
    ids = segment_ids
    if ids.dtype != torch.int32:
        ids = torch.where((ids >= 0) & (ids < Z), ids, -1).to(torch.int32)
    chunks = segment_chunks(E, Z, D)
    partial = torch.empty((chunks if chunks > 1 else 0, Z, D),
                          dtype=torch.float32, device=dev)
    lib = _lib()
    ops = [values.contiguous(), ids.contiguous(), partial, out]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_segment_sum(*[t.data_ptr() for t in ops], E, D, Z,
                                     chunks, stream)
    _raise_on(lib, err, name)
    segment_sum.launches += 1
    check_nan("segment_sum", out)
    return out


segment_sum.launches = 0


KERNELS = (gat_edge_csr_forward, gat_edge_csr_backward)
# the plain versions in the same places (to hold the kernels' route against)
PLAIN = (gat_edge_csr_forward_reference, gat_edge_csr_backward_reference)


class _EdgeCSR(torch.autograd.Function):
    """``out``; backward: the gradients of ``wh``, ``e_recv`` and ``e_send``
    through the backward kernel, fed ``corr = <g_i, out_i>`` per head (the
    telescoped softmax correction, computed here as the reference computes
    it outside its kernel)."""

    @staticmethod
    def forward(ctx, layout, wh, e_recv, e_send):
        impl = KERNELS
        out, lse = impl[0](wh, e_recv, e_send, layout)
        ctx.impl, ctx.layout = impl, layout
        ctx.save_for_backward(wh, e_recv, e_send, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        wh, e_recv, e_send, out, lse = ctx.saved_tensors
        g = g.contiguous()
        corr = torch.sum(g * out, dim=-1)
        d_wh, d_recv, d_send = ctx.impl[1](g, wh, e_recv, e_send, lse, corr,
                                           ctx.layout)
        return None, d_wh, d_recv, d_send


def gat_edge_csr(wh, e_recv, e_send, layout):
    """``out (num_nodes, H, d)`` of the edge aggregation over ``layout``,
    differentiable with respect to ``wh`` (Zs, H, d), ``e_recv`` and
    ``e_send``, through the pair that :data:`KERNELS` holds at the call (the
    kernel wrappers: on CUDA they launch the kernels or raise); the backward
    runs the same pair's backward."""
    return _EdgeCSR.apply(layout, wh, e_recv, e_send)


__all__ = [
    "CSRLayout", "kept_edges", "build_csr", "kernels_fit",
    "gat_edge_csr_forward_reference", "gat_edge_csr_forward",
    "gat_edge_csr_backward_reference", "gat_edge_csr_backward",
    "gat_edge_csr", "KERNELS", "PLAIN", "segment_sum_reference",
    "segment_sum_fits", "segment_sum",
]
