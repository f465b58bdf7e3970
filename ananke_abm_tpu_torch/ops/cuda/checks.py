"""The bounds the kernels (K8, K8a, K2f, K2b, K3f, K3b, K4f, K4b, K5 at both
precisions, K7, K6, the CSR edge pair and K9e) are held to against their
plain versions on the card, and the random operands of those checks: one
copy, for ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

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

import numpy as np
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
# K4f / K4b (the zone encoder, float32 throughout: kernel and plain version
# differ only in the order of their float32 sums), per ZoneGAT parameter
# (gat_grad_outputs). The control is the plain version with every matrix
# product's operands rounded to TF32, forward and backward: the precision
# PyTorch's TF32 switch would give it on this card. Readings (chip_smoke.py
# --readings encoder, GAT_SHAPES and GAT_READING_SHAPES but Z = 1 x 3 seeds,
# H100 80GB HBM3):
# - K4f: sound mean <= 2.0e-7, max <= 6.9e-7, 1 - cos <= 2.2e-14; control
#   >= 2.9e-4, >= 3.5e-4, >= 4.4e-8;
# - K4b, the plain version on the kernel's side of each leaky-relu's kink
#   (on_kernel_sides): sound mean <= 2.6e-6, max <= 5.3e-6, 1 - cos <=
#   4.4e-12; control >= 7.2e-4, >= 6.1e-4, >= 2.3e-7. On its own sides the
#   plain version read up to 5.4e-4, 1.6e-3, 5.7e-7 from the kernel at a
#   draw with a score within rounding of the kink, as far as the control;
#   the kernel then lies as near a float64 run on its sides (4.2e-7) as
#   the plain version (4.2e-7). At Z = 1 a_src's gradient is exactly 0 (one
#   score per row): the relative readings are 0 / 0 there.
GAT_FWD_BOUNDS = (1e-5, 1e-4, 1e-9)
GAT_BWD_BOUNDS = (1e-4, 1e-4, 1e-9)
# K5 / K7 (the DOPRI5 step and its VJP, float32 throughout: kernel and plain
# version differ only in the order of their float32 sums and in fused
# multiply-adds), per output (dopri5_step_outputs, dopri5_vjp_outputs). The
# control is the plain version with every product's operands rounded to
# TF32 (tf32_products). Readings (chip_smoke.py --readings dopri5:
# DOPRI5_SHAPES and DOPRI5_READING_SHAPES, N 333-98,304, Z 7-2,048, 1-8
# blocks, seeds 0-2; H100 80GB HBM3, 700 W):
# - K5: sound mean <= 1.7e-5, max <= 1.8e-5, 1 - cos <= 1.4e-10, all on the
#   embedded error, a difference of nearly equal sums (the plain version
#   lies as far from a float64 run: 1.7e-5); control >= 2.0e-3, >= 2.0e-3,
#   >= 2.1e-6;
# - K7: sound mean <= 5.7e-6, max <= 8.3e-6, 1 - cos <= 1.6e-11 (the plain
#   version lies as far from float64: <= 5.3e-6); control >= 1.7e-3, >=
#   1.8e-3, >= 1.5e-6.
# Against the float64 witness (float64_operands) kernel and plain version
# lie as far as from each other, so the same bounds hold there, and the
# control fails them.
DOPRI5_STEP_BOUNDS = (1e-4, 1e-4, 1e-9)
DOPRI5_VJP_BOUNDS = (5e-5, 5e-5, 1e-9)
# K7 at bf16 and K6 (the whole backward) at both precisions, per output
# (dopri5_vjp_outputs). The controls: bf16 products (bf16_control) for the
# bf16 kernels, TF32 products for K6 at float32. The bf16 bounds grow with
# depth as the day kernels' do: (bound at 2 blocks, power of s = (2 +
# blocks) / 4), through day_bounds; the powers are those that best part the
# sound readings from the control's. Readings (chip_smoke.py --readings
# dopri5: DOPRI5_SHAPES and DOPRI5_READING_SHAPES, N 333-98,304, Z 7-2,048,
# 1-8 blocks, seeds 0-2, K6 over 6 of 8 recorded steps and 12 output rows,
# checkpoints bf16 and float32; H100 80GB HBM3, 700 W), at 2 blocks' scale:
# - K7-bf16: sound mean <= 8.9e-3 (s^1.25), max <= 1.9e-2 (s^1), 1 - cos
#   <= 3.9e-5 (s^2.5); control >= 1.8e-2, >= 2.4e-2, >= 1.6e-4;
# - K6-bf16: sound mean <= 1.4e-2 (s^1.5), max <= 3.6e-2 (s^1), 1 - cos
#   <= 9.5e-5 (s^3); control >= 2.5e-2, >= 4.2e-2, >= 3.5e-4. At the CUDA
#   tests' small shapes (33 and 333 agents, 5 blocks, records (7, 5, 6)
#   and (8, 6, 12), seed 0) a sound K6 read up to 1.8e-2 mean and 1.6e-4
#   1 - cos at 2 blocks' scale (333 agents, record (7, 5, 6): a bias
#   gradient summed over few agents), the control >= 3.0e-2 and 5.0e-4.
#   Only the mean and the cosine part the two, by thin margins (mean bound
#   1.2x the sound readings and 0.88x the control's, 1 - cos 1.5x and
#   0.69x); the max bounds of both bf16 kernels lie above their controls'
#   readings: the max does not separate a control, it only catches rows
#   gone wrong;
# - K6-f32 (float32, sums in other orders): sound <= 1.8e-5, 2.6e-5,
#   1.5e-10 at any depth; control >= 2.2e-3, >= 2.7e-3, >= 2.5e-6.
# Against the float64 witness (float64_witness for the bf16 kernels,
# float64_operands for K6-f32) kernel and plain version lie about as far
# as from each other, within these bounds (<= 0.87 of each), and every
# control outside them.
DOPRI5_VJP_BF16_BOUNDS = ((1.2e-2, 1.25), (3e-2, 1), (8e-5, 2.5))
# (max_acc, n_acc, output rows) of the K6 checks' recordings
# (dopri5_backward_operands): steps past n_acc recorded too, one output row
# at the end of the last accepted step; rung 3's 12 output times
K6_RECORD = (8, 6, 12)
DOPRI5_BWD_BOUNDS = (5e-5, 5e-5, 1e-9)
DOPRI5_BWD_BF16_BOUNDS = ((2.2e-2, 1.5), (6e-2, 1), (2.4e-4, 3))
# K5 at bf16 (the bf16 stage math of drift_stage.cuh, the tableau and the
# error in float32), per output: y1, f1, r5 and the error sum of
# err_stats, through day_bounds: (bound at 2 blocks, power of s = (2 +
# blocks) / 4). The control is K5's float32 kernel on the same operands
# (it rounds no stage). Readings (chip_smoke.py --readings dopri5: its
# DOPRI5_SHAPES, DOPRI5_READING_SHAPES and K5_BF16_READING_SHAPES x seeds
# 0-2; H100 80GB HBM3, 700 W), r5 the worst output throughout (h
# sum d_j k_j, whose large coefficients cancel): sound mean <= 3.2e-3 and
# 1 - cos <= 3.0e-5 at 2 blocks, <= 1.12e-2 and 2.2e-4 at 8; control >=
# 2.0e-2 and 2.0e-4 at 2, >= 4.0e-2 and 8.2e-4 at 8. The max does not part
# them (sound <= 5.5e-2, control >= 5.4e-2 at 8 blocks): it catches rows
# gone wrong. Against the float64 witness kernel and plain version lie as
# far as from each other (kernel <= 9.9e-3 mean at 8 blocks), the control
# outside.
DOPRI5_STEP_BF16_BOUNDS = ((7e-3, 1.25), (6e-2, 1), (8e-5, 2))
# K9e (the segment sum: values rounded to bf16, float32 sums in another
# order), its one output: (mean, max, 1 - cosine). The control sums the
# values unrounded. Readings (chip_smoke.py --readings segment:
# SEGMENT_SHAPES x seeds 0-2; H100 80GB HBM3, 700 W): sound mean <= 8.6e-8,
# max <= 4.7e-7, 1 - cos <= 9.5e-15 (rung 1: ~16,000 rows a segment;
# 5e-11, 4e-8, 2e-16 with ~65 or fewer); control >= 1.64e-3, >= 1.55e-3,
# >= 1.33e-6.
SEGMENT_BOUNDS = (1e-5, 2e-5, 1e-10)
# (agents, zones, residual blocks) where the serving kernels K1 and K0
# reach the edges of their tiles: agents not a multiple of a CTA's rows
# (and CTAs with warps past the last row), one 16-zone chunk (Z = 8), a
# part-filled last zone box (Z = 500), 1 and 8 residual blocks
SERVING_EDGE_SHAPES = ((1_000, 500, 1), (200, 8, 8), (129, 8, 1),
                       (4_133, 500, 8), (70_001, 64, 2))
# K1 and K0 past the depths X_MEAN_ATOL was read at (chip_smoke.py; 1-2
# blocks): at 8 residual blocks even the plain version sits ~1.3e-4 (mean
# |d|) from the float64 witness, so kernel and plain version are each held
# to the witness instead: the kernel's mean |d| to it at most this many
# times the plain version's. Readings (chip_smoke.py --readings serving:
# SERVING_EDGE_SHAPES and 4,096 / 65,536 agents x 64 zones, the cases past
# 2 blocks, 3 seeds; H100 80GB HBM3, 700 W): sound <= 1.19 (K1), <= 1.35
# (K0); the bf16-product control >= 5.32 (K1), >= 10.6 (K0).
SERVING_WITNESS_RATIO = 2.0
# (kind, rows, features, segments) of the K9e checks (segment_operands):
# rung 1's population by zone, rung 2's by BASELINE config 4's 500 zones,
# and a random case of 2,048 segments with dropped ids (at or past Z, and
# negative) and empty segments
SEGMENT_SHAPES = (("rung1", 1_048_576, 32, 64), ("rung2", 32_768, 32, 500),
                  ("random", 200_000, 32, 2_048))


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


def tf32_products(fn, *args):
    """``fn(*args)``, a plain version of the float32 DOPRI5 step kernels,
    with every product's operands rounded to TF32 and float32 sums: a
    kernel that took the card's TF32 path."""
    return _with_products(lambda a, b: round_tf32(a) @ round_tf32(b),
                          lambda a, b: round_tf32(a).T @ round_tf32(b), fn,
                          *args)


def float64_operands(args):
    """Every float32 tensor of ``args`` (and of the tuples in it) cast to
    float64: the plain versions run on them are a witness with sums all but
    exact."""
    up = lambda a: (a.double() if torch.is_tensor(a) else
                    tuple(up(w) for w in a) if isinstance(a, tuple) else a)
    return tuple(up(a) for a in args)


def float64_witness(fn, *args):
    """``fn(*args)`` with every product, and so all the arithmetic after
    it, in float64: the same bf16 rounding points, sums all but exact. A
    third party for kernel and plain version where they read far apart."""
    return _with_products(lambda a, b: a.double() @ b.double(),
                          lambda a, b: a.double().T @ b.double(), fn, *args)


def round_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (as the card's ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """float32 ``x`` -> (hi, lo), the two TF32 parts K5's 3xTF32 products
    take of each operand (``k5::split`` in csrc/fused_dopri5.cu): hi is x
    with its 13 low mantissa bits cleared, lo the TF32 value the tensor
    core reads of x - hi (its 13 low bits cleared too). hi + lo rebuilds x
    within 2^-21 of |x|."""
    bits = x.float().contiguous().view(torch.int32)
    hi = (bits & -0x2000).view(torch.float32)
    lo = ((x.float() - hi).contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)
    return hi, lo


def tf32x3_dot(a, b):
    """``a @ b`` as K5 computes it: lo hi + hi lo + hi hi of the operands'
    split_tf32 parts, float32 sums (the lo lo term dropped)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def tf32x3_products(fn, *args):
    """``fn(*args)``, a plain version of the float32 DOPRI5 step, with every
    product in K5's 3xTF32 arithmetic (tf32x3_dot): the kernel's rounding
    class without its order of sums."""
    return _with_products(tf32x3_dot, lambda a, b: tf32x3_dot(a.T, b), fn,
                          *args)


class _Tf32MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32 and float32 sums; its
    backward's two products likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def tf32_control(fn, *args):
    """``fn(*args)``, a plain version of the encoder kernels, with every
    matrix product in TF32: a kernel that took the card's TF32 path."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat

    saved = fused_gat._mm
    fused_gat._mm = _Tf32MatMul.apply
    try:
        return fn(*args)
    finally:
        fused_gat._mm = saved


def kernel_kink_sides(res, num_layers, heads):
    """K4f's side of the leaky-relu's kink for every score, one (Z, Z) bool
    per layer and head: e_src_i + e_dst_j >= 0 from the kernel's own saved
    e_src and e_dst (``gat_forward_fused``'s residuals), rounded as the
    kernel adds them. None for the plain version's residuals (None)."""
    if res is None:
        return None
    st = res[3]  # (4, layers, Z, heads): e_src, e_dst, row max, row sum
    return [st[0, k][:, h, None] + st[1, k][None, :, h] >= 0
            for k in range(num_layers) for h in range(heads)]


def on_kernel_sides(sides, fn, *args):
    """``fn(*args)``, a plain version of the encoder kernels, with every
    leaky-relu on the kernel's side of its kink (``kernel_kink_sides``).
    The gradient jumps by 0.8 alpha (g_alpha - D) where a score crosses 0,
    and scores within float32 rounding of 0 occur (~one a call at Z = 2048,
    2 layers): held to its own sides, the plain version would differ from
    the kernel there by a step, not by rounding."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat

    if sides is None:
        return fn(*args)
    it = iter(sides)
    saved = fused_gat._kink_side
    fused_gat._kink_side = lambda s: next(it).to(s.device)
    try:
        return fn(*args)
    finally:
        fused_gat._kink_side = saved


def float64_encoder(fn, *args):
    """``fn(*args)``, a plain version of the encoder kernels, on every
    tensor operand (and tuple of them) cast to float64: a witness for
    kernel and plain version alike."""
    up = lambda a: (a.double() if torch.is_tensor(a) else
                    tuple(w.double() for w in a) if isinstance(a, tuple)
                    else a)
    return fn(*(up(a) for a in args))


def gat_operands(z, f, num_layers, dev, seed, isolated=None, graph=None):
    """``(zf, adj, flat, heads, num_layers)`` and a cotangent ``g`` of the
    encoder kernels' checks at the shipping widths (64 features, 4 heads):
    a model's encoder initialised as :func:`init_params` does, its
    LayerNorm scale and bias moved off 1 and 0, random zone features and a
    random graph with self loops (the row ``isolated`` zeroed), all from
    ``seed``; ``graph``: (zf, adj) to use instead of the random ones."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_gat import flatten_gat_params

    model = build_model(GATODEConfig(gat_layers=num_layers), f, 8,
                        device=dev)
    init_params(model, torch.Generator().manual_seed(seed))
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for norm in model.zone_gat.norms:
            norm.weight.add_(0.1 * torch.randn(norm.weight.shape, device=dev,
                                               generator=g))
            norm.bias.add_(0.1 * torch.randn(norm.bias.shape, device=dev,
                                             generator=g))
        zf = torch.randn(z, f, device=dev, generator=g)
        adj = (torch.rand(z, z, device=dev, generator=g) < 0.1).float()
        adj.fill_diagonal_(1.0)
        if graph is not None:
            zf, adj = (t.to(dev, torch.float32) for t in graph)
        if isolated is not None:
            adj[isolated] = 0.0
        flat = tuple(w.detach().clone()
                     for w in flatten_gat_params(model.zone_gat))
        cot = torch.randn(z, model.zone_dim, device=dev, generator=g)
    return (zf, adj, flat, model.zone_gat.heads, num_layers), cot


def gat_grad_outputs(grads, num_layers, heads=4):
    """(name, tensor) per ``ZoneGAT`` parameter of gradients in
    ``flatten_gat_params``' order: the per-head rows of ``a_src`` and
    ``a_dst`` joined into the module's (heads, d) parameters. A check holds
    whole parameters: a head whose scores all lie on one side of the
    leaky-relu's kink has a zero ``a_src`` gradient, where kernel and plain
    version are both rounding noise."""
    out = [("Win", grads[0]), ("bin", grads[1])]
    per = 3 + 2 * heads
    for k in range(num_layers):
        lg = grads[2 + per * k: 2 + per * (k + 1)]
        out += [(f"W[{k}]", lg[0]),
                (f"a_src[{k}]", torch.cat(lg[1:1 + heads])),
                (f"a_dst[{k}]", torch.cat(lg[1 + heads:1 + 2 * heads])),
                (f"scale[{k}]", lg[1 + 2 * heads]),
                (f"bias[{k}]", lg[2 + 2 * heads])]
    return out


def dopri5_operands(model, n, z, dev, seed, t0=6.1, h_step=0.37):
    """The operands of ``dopri5_step_fused`` for a model (random states,
    FSAL evals, context and zones from ``seed``, the time rows of a step of
    ``h_step`` at ``t0``) and the five folded cotangents of
    ``dopri5_step_vjp_fused``."""
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        flax_leaf_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_dopri5 import stage_time_rows
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import split_drift_params

    with torch.no_grad():
        (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = (
            split_drift_params(dict(flax_leaf_params(model))))
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = lambda d: torch.randn(n, d, device=dev, generator=g)
        da, dc = Wq.shape[0], W1h.shape[0]
        x, f0, h = rows(da), 0.3 * rows(da), rows(dc)
        ze = torch.randn(z, Wq.shape[1], device=dev, generator=g)
        d = lambda w: w.detach().contiguous()
        args = (x, f0, h, ze, stage_time_rows(t0, h_step, d(W1t), d(b1)),
                d(Wq), d(W1xc), d(W1h),
                tuple(tuple(d(w) for w in b) for b in blocks), d(W3), d(b3),
                h_step)
        cot = tuple(rows(da) for _ in range(5))
    return args, cot


def dopri5_backward_operands(model, n, z, dev, seed, max_acc, n_acc,
                             num_times, ckpt_dtype=torch.float32):
    """The operands of ``dopri5_backward_fused`` for a model: a recording of
    ``n_acc`` of ``max_acc`` steps (sizes in [0.2, 2), random checkpoints
    and FSAL evals in ``ckpt_dtype``, past n_acc too), ``num_times`` output
    rows (row 0 filled by no step, the rest inside random accepted steps,
    the last at the end of the last step), their random cotangents, random
    context and zones, all from ``seed``; the time rows of every recorded
    step; the weights split from the model. Without the precision."""
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        flax_leaf_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_dopri5 import stage_time_table
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import split_drift_params

    rng = np.random.default_rng(seed)
    rec_h = np.zeros(max_acc, np.float32)
    rec_t0 = np.zeros(max_acc, np.float32)
    rec_h[:n_acc] = rng.uniform(0.2, 2.0, n_acc).astype(np.float32)
    rec_t0[1:n_acc] = np.cumsum(rec_h[:n_acc - 1], dtype=np.float32)
    steps = rng.integers(0, n_acc, num_times - 2)
    theta = rng.uniform(0.05, 1.0, num_times - 2).astype(np.float32)
    order = np.argsort(steps + theta)  # increasing output times
    steps, theta = steps[order], theta[order]
    out_step = np.concatenate([[-1], steps, [n_acc - 1]])
    ts = np.concatenate([[0.0], rec_t0[steps] + theta * rec_h[steps],
                         [rec_t0[n_acc - 1] + rec_h[n_acc - 1]]]).astype(
        np.float32)
    with torch.no_grad():
        (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = (
            split_drift_params(dict(flax_leaf_params(model))))
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
        da, dc = Wq.shape[0], W1h.shape[0]
        d = lambda w: w.detach().contiguous()
        ckpts = rnd(max_acc, n, da).to(ckpt_dtype)
        ckpt_f = (0.3 * rnd(max_acc, n, da)).to(ckpt_dtype)
        hc, ze = rnd(n, dc), rnd(z, Wq.shape[1])
        cot = 0.1 * rnd(num_times, n, da)
        tf_all = stage_time_table(rec_t0, rec_h, d(W1t), d(b1))
        return (ckpts, ckpt_f, hc, ze, tf_all, rec_t0, rec_h, n_acc, cot,
                out_step, ts, d(Wq), d(W1xc), d(W1h),
                tuple(tuple(d(w) for w in b) for b in blocks), d(W3), d(b3))


def dopri5_step_outputs(out):
    return list(zip(("y1", "f1", "err", "r5"), out))


def dopri5_vjp_outputs(out):
    names = ["gy0", "gf0", "gh", "gze", "gtf", "gWq", "gW1xc", "gW1h"]
    items = list(zip(names, out[:8]))
    for i, blk in enumerate(out[8]):
        items += list(zip([f"gWr1[{i}]", f"gbr1[{i}]", f"gWr2[{i}]",
                           f"gbr2[{i}]"], blk))
    return items + [("gW3", out[9]), ("gb3", out[10])]


def segment_operands(kind, e, d, z, dev, seed):
    """``(values, ids, num_segments)`` of a K9e check: standard normal
    values and uniform int64 ids in [0, z) from ``seed``; for ``random``,
    every fifth id moved past z, every seventh made negative, and the ids
    of every fourth segment moved away (those segments are empty)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(e, d, device=dev, generator=g)
    ids = torch.randint(0, z, (e,), device=dev, generator=g)
    if kind == "random":
        ids = torch.where(ids % 4 == 3, ids - 1, ids)  # empty segments
        pos = torch.arange(e, device=dev)
        ids = torch.where(pos % 5 == 0, ids + z, ids)
        ids = torch.where(pos % 7 == 0, -1 - ids, ids)
    return vals, ids, z


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


# The CSR edge kernels (``edge_segment.py``, float32 throughout: kernel and
# plain version differ only in the order of their float32 sums and in fused
# multiply-adds), per output: the forward's ``out``; the backward's
# ``d_wh``, ``d_recv`` and ``d_send``. The control is the plain version with
# ``wh`` rounded to bf16 (bf16_features), the TPU kernels' own feature
# precision; it leaves ``d_wh`` (which does not read ``wh``) as it is and
# fails through the other outputs. Readings (chip_smoke.py --readings edge:
# EDGE_SHAPES x seeds 0-2; H100 80GB HBM3, 700 W):
# - forward: sound mean <= 8.2e-8, max <= 3.1e-7, 1 - cos <= 5.0e-15;
#   control >= 5.3e-4, >= 1.5e-3, >= 1.9e-7;
# - backward: sound mean <= 4.7e-7, max <= 5.6e-7, 1 - cos <= 8.4e-14
#   (d_recv at one head of 64, a sum of alpha (<g, Wh> - corr) whose terms
#   nearly cancel); control >= 7.6e-3, >= 5.6e-3, >= 2.0e-5 (d_recv).
EDGE_FWD_BOUNDS = (1e-6, 1e-5, 1e-12)
EDGE_BWD_BOUNDS = (5e-6, 1e-5, 1e-11)
# (kind, source rows, heads, features per head) of the edge kernels' checks
# (edge_operands): the sparse world of the main path, rung 2's dense world
# as an edge list, a random graph with isolated destinations, duplicate
# edges and edges past num_nodes (also in heads of 48, which straddle lanes:
# the backward's shared-memory head sums), and one head of 64
# (gat_edge_layer)
EDGE_SHAPES = (("world", 32_768, 4, 16), ("rung2", 500, 4, 16),
               ("random", 3_000, 2, 32), ("random", 3_000, 3, 48),
               ("single", 4_096, 1, 64))


def edge_operands(kind, z, heads, d, dev, seed):
    """``(wh, e_recv, e_send, layout)`` and a cotangent ``g`` of the edge
    kernels' checks (``kind`` as in EDGE_SHAPES). On the two zone worlds
    the operands are a model's first GAT layer at the worlds' zone features
    (initialised as :func:`init_params` does from ``seed``); on the random
    graphs they are standard normal draws from ``seed``."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.data_generator.agent_trajectories import (
        sparse_zone_world,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.edge_segment import build_csr
    from ananke_abm_tpu_torch.ops.segment import edges_from_adj

    g = torch.Generator(device=dev).manual_seed(seed)
    num_nodes = z
    with torch.no_grad():
        if kind in ("world", "rung2"):
            if kind == "world":
                zf, (src, dst) = sparse_zone_world(z, seed=0)
            else:
                w = generate_agent_population(1, num_times=12, seed=1,
                                              num_zones=z)
                zf, (src, dst) = w["zone_features"], edges_from_adj(w["adj"])
            model = build_model(GATODEConfig(gat_heads=heads,
                                             zone_dim=heads * d),
                                zf.shape[1], 8, device=dev)
            init_params(model, torch.Generator().manual_seed(seed))
            layer = model.zone_gat.layers[0]
            wh = layer.proj(model.zone_gat.inp(
                torch.as_tensor(zf, device=dev))).reshape(z, heads, d)
            e_recv = torch.einsum("zhd,hd->zh", wh, layer.a_src)
            e_send = torch.einsum("zhd,hd->zh", wh, layer.a_dst)
            src, dst = (torch.as_tensor(a, device=dev) for a in (src, dst))
        else:
            rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
            ids = lambda hi, n: torch.randint(0, hi, (n,), device=dev,
                                              generator=g)
            wh, e_recv, e_send = rnd(z, heads, d), rnd(z, heads), rnd(z,
                                                                      heads)
            src = ids(z, 8 * z)
            if kind == "random":
                num_nodes = z - z // 6
                dst = ids(num_nodes + z // 12, 8 * z)  # some dropped
                dst = torch.where(dst % 7 == 0, dst + 1, dst)  # isolated
                dst = torch.clamp(dst, max=z - 1)
                src = torch.cat([src, src[: z]])  # duplicate edges
                dst = torch.cat([dst, dst[: z]])
            else:
                dst = ids(z, 8 * z)
        layout = build_csr(src, dst, num_nodes, z)
        cot = torch.randn(num_nodes, heads, d, device=dev, generator=g)
    return (wh, e_recv, e_send, layout), cot


def bf16_features(wh):
    """``wh`` rounded to bf16 (and back to float32): the feature precision
    of the TPU edge kernels, the edge checks' control."""
    return wh.bfloat16().float()
