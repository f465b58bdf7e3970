"""The bounds the training kernels (K8, K2f, K2b, K3f, K3b) are held to
against their plain versions on the card, and the random operands of those
checks: one copy, for ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Every bound is per output: mean |d| / mean |ref|, max |d| / max |ref| and
1 - cosine, kernel against plain version. Kernel and plain version round at
the same bf16 points and sum in other orders, so now and then a value
rounds the other way, and the flips compound through the residual blocks
(and, in the day kernels, over the substeps). Each bound is set from H100
readings beside a control whose products round to bf16 (a kernel that lost
the float32 accumulation), which must fail it: ``chip_smoke.py
--readings`` prints them; ``PERF.md`` keeps them.
"""
from __future__ import annotations

import torch

# K8 (the adjoint RHS), for 2 residual blocks, scaled by (2 + blocks) / 4:
# readings grow about linearly with depth (1-8 blocks, 2-3 weight seeds
# each). At 2 blocks a sound kernel read worst mean <= 1.04e-3, worst max
# <= 3.95e-3, worst 1 - cosine <= 5.3e-7; the control read worst mean >=
# 6.9e-3 and worst 1 - cosine >= 2.5e-5. The mean and the cosine separate a
# lower-precision kernel; the max catches a few rows gone wrong.
K8_REL_MEAN = 3e-3
K8_REL_MAX = 1e-2
K8_ONE_MINUS_COS = 1e-5

# The day kernels' readings grow with depth, not with the substeps (6 and
# 22 read alike), so each bound is given for 2 blocks with the power of
# s = (2 + blocks) / 4 it scales by (readings over chip_smoke.py's
# DAY_SHAPES and DEPTH_SHAPES x 3 seeds):
# - K2f: sound mean <= 7.2e-4 and 1 - cos <= 1.2e-6 at 2 blocks, <= 3.9e-3
#   and 3.3e-5 at 8; control >= 2.9e-3 and 8.7e-6 at 2, >= 1.0e-2 and
#   1.5e-4 at 8. The max does not separate the two (a few rows diverge
#   over the day: sound <= 0.15, control >= 2.8e-2): it only catches rows
#   gone wrong.
# - K2b (the time table's gradient, a sum over agents, reads worst): sound
#   mean <= 5.4e-3 and 1 - cos <= 1.8e-5 at 2 blocks, <= 1.3e-2 and 1.0e-4
#   at 8 with 4,096 agents; control >= 9.4e-3 and 3.9e-5 at 2, >= 2.2e-2
#   and 2.3e-4 at 8. With few agents and deep drifts the two read farther
#   apart: see WITNESS_BWD_BOUNDS.
# - K3f / K3b (nothing compounds): sound mean <= 2.6e-5, max <= 1.1e-2
#   (gx), 1 - cos <= 2.2e-8; control mean >= 1.4e-3, 1 - cos >= 1.3e-6.
DAY_FWD_BOUNDS = ((1.5e-3, 2), (1e-1, 2), (3e-6, 4))
DAY_BWD_BOUNDS = ((7e-3, 1), (1.1e-2, 1), (2.8e-5, 2))
CE_BOUNDS = (1e-4, 3e-2, 1e-7)
CE_CORRECT_MIN = 0.999
# K2b at 200 agents, 8 blocks, 3 output times, against a float64 witness
# (the plain version with its products and all after them in float64: the
# same bf16 rounding points, sums all but exact). There kernel and plain
# version read up to 2.0e-2 mean and 2.3e-4 1 - cos apart, outside
# DAY_BWD_BOUNDS, because each lies about as far from the witness: over 6
# seeds the kernel <= 2.33e-2 mean, 7.9e-2 max, 3.8e-4 1 - cos; the plain
# version <= 2.67e-2, 5.6e-2, 2.9e-4; the control >= 3.36e-2 mean and
# 1.24e-3 1 - cos (its max, >= 3.5e-2, does not separate).
WITNESS_BWD_BOUNDS = (3e-2, 1.2e-1, 6e-4)


def bf16_product_dot(a16, b16):
    """The control's product: bf16 x bf16 rounded to bf16 (PyTorch's
    ``a16 @ b16``)."""
    return (a16.to(torch.bfloat16) @ b16.to(torch.bfloat16)).float()


def bf16_product_nt_dot(a16, b16):
    """The control's agent contraction: bf16 products rounded to bf16."""
    return (a16.to(torch.bfloat16).T @ b16.to(torch.bfloat16)).float()


def _with_products(dot, nt_dot, fn, *args):
    """``fn(*args)``, a plain version, with the products of the plain
    versions' modules replaced by ``dot`` and ``nt_dot``."""
    from ananke_abm_tpu_torch.ops.cuda import (
        fused_rhs,
        fused_step,
        fused_train,
    )

    mods = (fused_step, fused_rhs, fused_train)
    saved = [(m._dot, m._nt_dot) for m in mods]
    for m in mods:
        m._dot, m._nt_dot = dot, nt_dot
    try:
        return fn(*args)
    finally:
        for m, (d, nt) in zip(mods, saved):
            m._dot, m._nt_dot = d, nt


def bf16_control(fn, *args):
    """``fn(*args)`` with every product rounded to bf16: a kernel that lost
    the float32 accumulation."""
    return _with_products(bf16_product_dot, bf16_product_nt_dot, fn, *args)


def float64_witness(fn, *args):
    """``fn(*args)`` with every product, and so all the arithmetic after
    it, in float64: the same bf16 rounding points, sums all but exact. A
    third party for kernel and plain version where they read far apart."""
    return _with_products(lambda a, b: a.double() @ b.double(),
                          lambda a, b: a.double().T @ b.double(), fn, *args)


def k8_bounds(num_blocks):
    """(mean, max, 1 - cosine) bounds of the K8 check at a depth."""
    s = (2 + num_blocks) / 4
    return K8_REL_MEAN * s, K8_REL_MAX * s, K8_ONE_MINUS_COS * s


def day_bounds(bounds, num_blocks):
    """The day kernels' (mean, max, 1 - cosine) bounds at a depth, from
    (bound at 2 blocks, power of (2 + blocks) / 4) pairs."""
    s = (2 + num_blocks) / 4
    return tuple(b * s ** p for b, p in bounds)


def k8_operands(model, n, z, dev, seed):
    """The operands of ``drift_rhs_and_vjp`` for a model: random states,
    context, cotangent and zones from ``seed``, the stage time 7.3."""
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        flax_leaf_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
        split_drift_params,
        time_row,
    )

    with torch.no_grad():
        (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = (
            split_drift_params(dict(flax_leaf_params(model))))
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = lambda d: torch.randn(n, d, device=dev, generator=g)
        x, h, a = rows(Wq.shape[0]), rows(W1h.shape[0]), rows(Wq.shape[0])
        ze = torch.randn(z, Wq.shape[1], device=dev, generator=g)
        d = lambda w: w.detach()
        return (x, h, ze, time_row(7.3, d(W1t), d(b1)), d(Wq), d(W1xc),
                d(W1h), tuple(tuple(d(w) for w in b) for b in blocks),
                d(W3), d(b3), a)


def day_operands(model, n, z, num_times, substeps, dev, seed):
    """(x0, h, ze16, tf_pre, dts, weights16) of the day kernels for a
    model: random states and zones from ``seed`` and a day grid of
    ``num_times`` output times."""
    from ananke_abm_tpu_torch.ops.cuda.fused_train import (
        split_w1,
        stage_times_table,
    )

    dense = model.drift.dense
    nb = (len(dense) - 2) // 2
    with torch.no_grad():
        W1xc, W1h, W1t = split_w1(dense[0].weight.T, model.agent_dim,
                                  model.zone_dim)
        blocks = tuple(tuple(w.bfloat16() for w in (
            dense[1 + 2 * i].weight.T, dense[1 + 2 * i].bias,
            dense[2 + 2 * i].weight.T, dense[2 + 2 * i].bias))
            for i in range(nb))
        w16 = (model.query_proj.weight.T.bfloat16(), W1xc.bfloat16(),
               W1h.bfloat16(), blocks, dense[-1].weight.T.bfloat16(),
               dense[-1].bias.bfloat16())
        g = torch.Generator(device=dev).manual_seed(seed)
        x0 = torch.randn(n, model.agent_dim, device=dev, generator=g)
        h = torch.randn(n, W1h.shape[0], device=dev, generator=g)
        ze = torch.randn(z, model.zone_dim, device=dev,
                         generator=g).bfloat16()
        times = torch.linspace(0.0, 24.0 * (num_times - 1) / num_times,
                               num_times, device=dev)
        dts, tf = stage_times_table(times, substeps, W1t, dense[0].bias)
    return x0, h, ze, tf, dts, w16
