"""The collectives that carry a gradient, as ``torch.autograd.Function``s
over ``torch.distributed``, and the host-side reductions of a mesh step.

Each rank backpropagates from the loss it holds. Two kinds of sum follow:

- :func:`sum_to_replicated`: the sum becomes a value every rank holds and
  differentiates whole (the global loss, a softmax normaliser whose users
  are the same on every rank). Its backward hands each rank's gradient to
  the rank's own summand unchanged.
- :func:`all_reduce_sum`: the sum feeds computations that differ by rank
  (batch-norm statistics of each rank's rows), so each rank's gradient of
  it is only that rank's share. Its backward sums the shares, as JAX's
  ``psum`` transposes to a ``psum``.

:func:`all_gather_rows` (backward: the shares summed, each rank keeping
its own block) and :func:`ring_shift` (backward: the shift the other way,
as ``ppermute`` transposes) follow the second rule. A rank's parameter
gradients are then its share, summed over the ranks that split the work
(:func:`all_reduce_grads`) before the optimizer step.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _SumToReplicated(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_to_replicated(x, group):
    """Sum of ``x`` over ``group``, a value each rank then differentiates
    whole; ``x`` itself when ``group`` is None."""
    return x if group is None else _SumToReplicated.apply(x, group)


def all_reduce_sum(x, group):
    """Sum of ``x`` over ``group`` whose gradient is the ranks' summed
    gradients; ``x`` itself when ``group`` is None."""
    return x if group is None else _AllReduceSum.apply(x, group)


def _gather(x, group):
    """The ranks' equal-shaped ``x`` concatenated along dim 0."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


def all_gather_rows(x, group):
    """The ranks' equal-sized blocks of rows, concatenated in group-rank
    order."""
    return _AllGatherRows.apply(x, group)


def _shift(x, group, step):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x, group):
    """``x`` of the previous rank of ``group`` (rank ``i`` sends to ``i +
    1``); the gradient travels back the other way."""
    return _RingShift.apply(x, group)


@torch.no_grad()
def gather_rows(x, n: int, group):
    """The whole ``n``-row tensor on every rank of ``group`` from each
    rank's ``Shard(0)`` block ``x`` (``ceil(n / size)`` rows a rank, the
    last ranks short): each block padded to the full size, gathered,
    the padding cut."""
    per = -(-n // dist.get_world_size(group))
    pad = x.new_zeros((per,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    return _gather(pad, group)[:n]


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum the ``.grad`` of every parameter over ``group`` in one
    collective (a missing gradient counts as zeros)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


@torch.no_grad()
def all_reduce_values(values, group, op=dist.ReduceOp.SUM):
    """``values`` (tensors on one device) reduced over ``group`` in one
    collective; returns new tensors."""
    flat = torch.stack([torch.as_tensor(v).reshape(()).float()
                        for v in values])
    dist.all_reduce(flat, op=op, group=group)
    return list(flat.unbind())


__all__ = ["sum_to_replicated", "all_reduce_sum", "all_gather_rows",
           "ring_shift", "gather_rows", "all_reduce_grads", "all_reduce_values"]
