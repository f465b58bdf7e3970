"""The fixed-step training day of the GAT-ODE: the whole-day RK4 rollout
and its VJP, and the decode head's cross-entropy and its VJP.

Port of ``ananke_abm_tpu/ops/pallas/fused_train.py``. Four kernels (CUDA
C++: K2b, K3f and K3b in ``csrc/fused_train.cu``, K2f in
``csrc/fused_step.cu`` beside the serving kernels whose template it
shares) replace the four Pallas kernels of that file, each with its plain
PyTorch version beside it:

- :func:`day_forward_fused` (K2f, ``_day_fwd_impl``) and
  :func:`day_forward_reference`;
- :func:`day_backward_fused` (K2b, ``_day_bwd_impl``) and
  :func:`day_backward_reference`;
- :func:`ce_forward_fused` (K3f, ``_ce_fwd_impl``) and
  :func:`ce_forward_reference`;
- :func:`ce_backward_fused` (K3b, ``_ce_bwd_impl``) and
  :func:`ce_backward_reference`.

Each wrapper takes its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises (widths it is not compiled for,
too many blocks, a refused launch); there is no fallback. ``.launches``
counts the kernel launches. The plain versions are the one copy of the
stage math (:func:`~ananke_abm_tpu_torch.ops.cuda.fused_step.stage_math`,
:func:`~ananke_abm_tpu_torch.ops.cuda.fused_step.stage_vjp_math`): bf16
operands, float32 sums, the reference's rounding points.

:func:`rk4_day_rollout` and :func:`decode_ce` are the differentiable entry
points (``torch.autograd.Function``\\ s over the wrappers).
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
    NUM_SLABS,
    _scale,
    grad_layout,
    pack_stage_weights,
    pad_zones,
    split_grads,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    BF16,
    KERNEL_WIDTHS,
    MAX_KERNEL_BLOCKS,
    _dot,
    _nt_dot,
    _raise_on,
    _rk4_coefs,
    stage_kernels_fit,
    stage_math,
    stage_vjp_math,
)

# CTAs offered to the cross-entropy's backward, each summing its tiles into
# its own slab: two an SM (the C interface's count, which an A/B against a
# build of two CTAs an SM keeps); its library runs on at most NUM_SLABS of
# them. A constant, so the sums' order depends on the row count alone.
CE_SLABS = 2 * NUM_SLABS


def split_w1(W1, Da, Dz):
    """Full Dense_0 kernel (in, out) -> (x/ctx rows, h rows, time rows)."""
    Hc = W1.shape[0] - Da - Dz - 2
    return W1[: Da + Dz], W1[Da + Dz: Da + Dz + Hc], W1[Da + Dz + Hc:]


def stage_times_table(times, substeps, W1t, b1):
    """(T,) output times -> per-substep ``dts`` (S,) and the (S, 4, H)
    float32 Dense_0 time-row pre-activation table (sin/cos rows plus the
    bias), S = (T - 1) * substeps. Built with torch ops, so the gradients
    of ``W1t`` and ``b1`` flow through it."""
    dt_int = (times[1:] - times[:-1]) / substeps
    dts = torch.repeat_interleave(dt_int, substeps)
    steps = torch.arange(substeps, dtype=torch.float32, device=times.device)
    sub_starts = (times[:-1, None] + dt_int[:, None] * steps[None, :]
                  ).reshape(-1)
    offs = torch.stack([torch.zeros_like(dts), 0.5 * dts, 0.5 * dts, dts],
                       dim=-1)
    ang = (sub_starts[:, None] + offs) * (2 * np.pi / 24.0)
    tfeat = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    tf_pre = (torch.einsum("sct,th->sch", tfeat.float(), W1t.float())
              + b1.float()[None, None, :])
    return dts.float(), tf_pre


def _coefs(dt):
    """(dt, dt/2, dt/3, dt/6) of one substep, in float32 arithmetic."""
    step, half, sixth = _rk4_coefs(dt)
    return step, half, float(np.float32(dt) / np.float32(3.0)), sixth


# ---- K2f: the day forward ---------------------------------------------------

def day_forward_reference(x0, h, ze, tf_pre, dts, weights):
    """Plain PyTorch version of the day forward.

    x0: (N, Da) float32; h: (N, Hc) float32; ze: (Z, Dz) bf16; tf_pre:
    (S, 4, H) float32 and dts (S,) from :func:`stage_times_table`;
    weights: bf16 ``(Wq, W1xc, W1h, blocks, W3, b3)`` in (in, out) layout,
    ``blocks`` a tuple of (Wr1, br1, Wr2, br2). Returns ``xs_all`` (S + 1,
    N, Da) float32, every substep's carry, row 0 = x0.
    """
    Wq, W1xc, W1h, blocks, W3, b3 = weights
    scale = _scale(ze.shape[1])
    hpre = _dot(h.to(BF16), W1h)
    xs = [x0]
    x = x0
    for s, dt in enumerate(dts.tolist()):
        step, half, _, sixth = _coefs(dt)

        def rhs(xc, r):
            k, _ = stage_math(xc.to(BF16), hpre, tf_pre[s, r][None, :], ze,
                              scale, Wq, W1xc, blocks, W3, b3)
            return k

        k1 = rhs(x, 0)
        k2 = rhs(x + half * k1, 1)
        k3 = rhs(x + half * k2, 2)
        k4 = rhs(x + step * k3, 3)
        x = x + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        xs.append(x)
    return torch.stack(xs)


def _check_stage_operands(name, x, ze, tf_pre, dts, weights, rows):
    """Validate the day's operands against ``x`` (N, Da); ``rows``: more
    (name, tensor, shape) float32 per-row operands. Returns (N, Da, Z, Dz,
    Dc, H, S)."""
    Wq, W1xc, W1h, blocks, W3, b3 = weights
    N, Da = x.shape[-2:]
    Z, Dz = ze.shape
    Dc, H = W1h.shape
    S = dts.shape[0]
    want = {"ze": (ze, BF16, (Z, Dz)),
            "tf_pre": (tf_pre, torch.float32, (S, 4, H)),
            "dts": (dts, torch.float32, (S,)),
            "Wq": (Wq, BF16, (Da, Dz)), "W1xc": (W1xc, BF16, (Da + Dz, H)),
            "W1h": (W1h, BF16, (Dc, H)), "W3": (W3, BF16, (H, Da)),
            "b3": (b3, BF16, (Da,))}
    for i, (wr1, br1, wr2, br2) in enumerate(blocks):
        want[f"Wr1[{i}]"] = (wr1, BF16, (H, H))
        want[f"br1[{i}]"] = (br1, BF16, (H,))
        want[f"Wr2[{i}]"] = (wr2, BF16, (H, H))
        want[f"br2[{i}]"] = (br2, BF16, (H,))
    for rname, t, shape in rows:
        want[rname] = (t, torch.float32, shape)
    for key, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, the state on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if len(blocks) < 1:
        raise ValueError(f"{name}: the day kernels need >= 1 residual block")
    if Z < 1 or S < 1:
        raise ValueError(f"{name}: needs >= 1 zone and >= 1 substep")
    return N, Da, Z, Dz, Dc, H, S


# the (agent, zone) widths the cross-entropy kernels are compiled for: the
# decode uses only those two of KERNEL_WIDTHS
CE_WIDTHS = tuple(w[:2] for w in KERNEL_WIDTHS)


# whether the day kernels (K2f / K2b) take (agent, zone, context, hidden)
# widths and residual blocks
day_kernels_fit = stage_kernels_fit


def ce_kernels_fit(da, dz) -> bool:
    """Whether the cross-entropy kernels (K3f / K3b) take these (agent,
    zone) widths."""
    return (da, dz) in CE_WIDTHS


def _kernel_device(name, x, fits, widths, compiled, num_blocks=None):
    """True for a CUDA tensor the kernel takes (``fits``, its predicate's
    answer), False for a CPU tensor; raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not fits:
        if widths not in compiled:
            raise ValueError(
                f"{name}: the CUDA kernel is compiled for widths {compiled}, "
                f"got {widths}")
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{MAX_KERNEL_BLOCKS} residual blocks, got "
                         f"{num_blocks}")
    return True


def _lib(name="fused_train"):
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    return load_library(name)


def day_forward_fused(x0, h, ze, tf_pre, dts, weights):
    """The day forward. Arguments and result as
    :func:`day_forward_reference`; on CUDA the kernel K2f, the serving
    kernels' template in ``csrc/fused_step.cu`` with a carry stored after
    each substep."""
    N, Da, Z, Dz, Dc, H, S = _check_stage_operands(
        "day_forward_fused", x0, ze, tf_pre, dts, weights,
        [("x0", x0, x0.shape), ("h", h, (x0.shape[0], weights[2].shape[0]))])
    blocks = weights[3]
    if not _kernel_device("day_forward_fused", x0,
                          day_kernels_fit(Da, Dz, Dc, H, len(blocks)),
                          (Da, Dz, Dc, H), KERNEL_WIDTHS, len(blocks)):
        return day_forward_reference(x0, h, ze, tf_pre, dts, weights)
    xs = torch.empty((S + 1, N, Da), dtype=torch.float32, device=x0.device)
    if N == 0:
        return xs
    lib = _lib("fused_step")
    ze_p, zeT = pad_zones(ze)
    ops = [x0.contiguous(), h.contiguous(), ze_p, zeT, tf_pre.contiguous(),
           dts.contiguous(), *pack_stage_weights(*weights), xs]
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        err = lib.ananke_day_forward(
            *[t.data_ptr() for t in ops], N, Z, ze_p.shape[0], len(blocks),
            S, Da, Dz, Dc, H, stream)
    _raise_on(lib, err, "day_forward_fused")
    day_forward_fused.launches += 1
    return xs


day_forward_fused.launches = 0


# ---- K2b: the day backward --------------------------------------------------

def day_backward_reference(xs_all, g_xs, h, ze, tf_pre, dts, weights):
    """Plain PyTorch version of the day's reverse sweep.

    xs_all: from :func:`day_forward_reference`; g_xs: its cotangent, same
    shape; the rest as :func:`day_forward_reference`. Per substep, in
    reverse, the four stages are recomputed and their VJPs chained stage 4
    -> 1 with the RK4 coefficients. Returns ``(gx0, gh, gze, gWq, gW1xc,
    gW1h, gtfp, gblocks, gW3, gb3)`` float32: gx0 (N, Da) (g_xs[0]
    included), gh (N, Hc), and summed over agents gze (Z, Dz), gtfp (S, 4,
    H) and the weights' gradients shaped like the weights.
    """
    Wq, W1xc, W1h, blocks, W3, b3 = weights
    S = dts.shape[0]
    N, Da = xs_all.shape[1:]
    Z, Dz = ze.shape
    H = W1xc.shape[1]
    scale = _scale(Dz)
    hb = h.to(BF16)
    hpre = _dot(hb, W1h)
    tw = (ze, ze.T, Wq.T, W1xc.T, tuple((b[0].T, b[2].T) for b in blocks),
          W3.T)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=xs_all.device)
    acc = (z(Z, Dz), z(Da, Dz), z(Da + Dz, H), z(N, H),
           tuple((z(H, H), z(1, H), z(H, H), z(1, H)) for _ in blocks),
           z(H, Da), z(1, Da))
    gtfp = z(S, 4, H)
    g = z(N, Da)
    dt_all = dts.tolist()
    for s in range(S - 1, -1, -1):
        step, half, third, sixth = _coefs(dt_all[s])
        x = xs_all[s]
        g = g + g_xs[s + 1]

        def rhs(xc, r):
            return stage_math(xc.to(BF16), hpre, tf_pre[s, r][None, :], ze,
                              scale, Wq, W1xc, blocks, W3, b3)

        k1, i1 = rhs(x, 0)
        k2, i2 = rhs(x + half * k1, 1)
        k3, i3 = rhs(x + half * k2, 2)
        _, i4 = rhs(x + step * k3, 3)
        vjp = lambda gk, inter, acc: stage_vjp_math(gk, inter, acc, tw,
                                                    scale, Da)
        gx4, gtf3, acc = vjp(sixth * g, i4, acc)
        gx3, gtf2, acc = vjp(third * g + step * gx4, i3, acc)
        gx2, gtf1, acc = vjp(third * g + half * gx3, i2, acc)
        gx1, gtf0, acc = vjp(sixth * g + half * gx2, i1, acc)
        gtfp[s] = torch.cat([gtf0, gtf1, gtf2, gtf3])
        g = g + gx1 + gx2 + gx3 + gx4
    (gze, gWq, gW1xc, ghp, gblk, gW3, gb3) = acc
    # hpre = hb @ W1h: gh per agent, gW1h summed over agents
    ghp16 = ghp.to(BF16)
    gh = _dot(ghp16, W1h.T)
    gW1h = _nt_dot(hb, ghp16)
    gblocks = tuple((g1, gb1[0], g2, gb2[0]) for (g1, gb1, g2, gb2) in gblk)
    return (g + g_xs[0], gh, gze, gWq, gW1xc, gW1h, gtfp, gblocks, gW3,
            gb3[0])


def day_backward_fused(xs_all, g_xs, h, ze, tf_pre, dts, weights):
    """The day's reverse sweep. Arguments and result as
    :func:`day_backward_reference`; on CUDA the kernel K2b. The summed
    gradients are deterministic: the same operands give the same bits."""
    _, N, Da = xs_all.shape
    N, Da, Z, Dz, Dc, H, S = _check_stage_operands(
        "day_backward_fused", xs_all, ze, tf_pre, dts, weights,
        [("xs_all", xs_all, (dts.shape[0] + 1, N, Da)),
         ("g_xs", g_xs, (dts.shape[0] + 1, N, Da)),
         ("h", h, (N, weights[2].shape[0]))])
    blocks = weights[3]
    nb = len(blocks)
    if not _kernel_device("day_backward_fused", xs_all,
                          day_kernels_fit(Da, Dz, Dc, H, nb),
                          (Da, Dz, Dc, H), KERNEL_WIDTHS, nb):
        return day_backward_reference(xs_all, g_xs, h, ze, tf_pre, dts,
                                      weights)
    dev = xs_all.device
    layout = grad_layout(Z, Dz, Da, Dc, H, nb, time_shape=(S, 4, H))
    size = sum(int(np.prod(s)) for _, s in layout)
    gsum = torch.zeros((size,), dtype=torch.float32, device=dev)
    gx0 = torch.empty((N, Da), dtype=torch.float32, device=dev)
    gh = torch.empty((N, Dc), dtype=torch.float32, device=dev)
    if N > 0:
        lib = _lib()
        if lib.ananke_day_bwd_slab_size(Z, nb, S) != size:
            raise RuntimeError("day_backward_fused: the kernel's slab "
                               "layout differs from grad_layout")
        rows = lib.ananke_day_bwd_tile_rows(nb)
        num_ctas = min(NUM_SLABS, -(-N // rows))
        # the slabs (every stage's partial sums are added into them: zeroed
        # here), then each CTA's row state: x, g, three k and the h-row
        # cotangent's sum per row of its tile
        slabs = torch.empty((num_ctas * (size + rows * (5 * Da + H)),),
                            dtype=torch.float32, device=dev)
        slabs[: num_ctas * size].zero_()
        ze_p, zeT = pad_zones(ze)
        ops = [xs_all.contiguous(), g_xs.contiguous(), h.contiguous(), ze_p,
               zeT, tf_pre.contiguous(), dts.contiguous(),
               *pack_stage_weights(*weights), gx0, gh, slabs, gsum]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ananke_day_backward(
                *[t.data_ptr() for t in ops], N, Z, ze_p.shape[0], nb, S,
                num_ctas, Da, Dz, Dc, H, stream)
        _raise_on(lib, err, "day_backward_fused")
        day_backward_fused.launches += 1
    gze, gtfp, gWq, gW1xc, gW1h, gblocks, gW3, gb3 = split_grads(
        gsum, layout, nb)
    return (gx0 + g_xs[0], gh, gze, gWq, gW1xc, gW1h, gtfp, gblocks, gW3,
            gb3)


day_backward_fused.launches = 0


# ---- K3f / K3b: the decode head's cross-entropy -----------------------------

def _ce_logits(rows, wd, ze):
    xb = rows.to(BF16)
    d16 = _dot(xb, wd).to(BF16)
    return xb, d16, _dot(d16, ze.T)


def ce_forward_reference(rows, targets, wd, ze):
    """Plain PyTorch version of the cross-entropy forward.

    rows: (M, Da) float32; targets: (M,) int32; wd: (Da, Dz) bf16 decode
    projection; ze: (Z, Dz) bf16. Per row, logits = bf16(bf16(rows) @ wd)
    @ ze.T (float32 sums), a max-subtracted log-sum-exp, the NLL of the
    target and whether the FIRST index of the largest logit is the target.
    Returns (nll (M,) float32, correct (M,) int32).
    """
    _, _, logits = _ce_logits(rows, wd, ze)
    mx = torch.max(logits, dim=-1, keepdim=True).values
    logz = torch.log(torch.sum(torch.exp(logits - mx), dim=-1)) + mx[:, 0]
    tgt = targets.long()
    l_tgt = torch.gather(logits, 1, tgt[:, None])[:, 0]
    ids = torch.argmax(logits, dim=-1)
    return logz - l_tgt, (ids == tgt).to(torch.int32)


def ce_backward_reference(rows, targets, wd, ze, g_nll):
    """Plain PyTorch version of the cross-entropy backward at the NLL's
    cotangent ``g_nll`` (M,) float32. Returns (gx (M, Da), gWd (Da, Dz),
    gze (Z, Dz)) float32, gWd and gze summed over rows."""
    xb, d16, logits = _ce_logits(rows, wd, ze)
    mx = torch.max(logits, dim=-1, keepdim=True).values
    ex = torch.exp(logits - mx)
    p = ex / torch.sum(ex, dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(targets.long(), ze.shape[0]).float()
    grow16 = ((p - onehot) * g_nll[:, None]).to(BF16)
    # logits = d @ ze.T
    gd16 = _dot(grow16, ze).to(BF16)
    gze = _nt_dot(grow16, d16)
    # d = xb @ wd
    return _dot(gd16, wd.T), _nt_dot(xb, gd16), gze


def _check_ce(name, rows, targets, wd, ze, g_nll=None):
    M, Da = rows.shape
    Z, Dz = ze.shape
    want = {"rows": (rows, torch.float32, (M, Da)),
            "targets": (targets, torch.int32, (M,)),
            "wd": (wd, BF16, (Da, Dz)), "ze": (ze, BF16, (Z, Dz))}
    if g_nll is not None:
        want["g_nll"] = (g_nll, torch.float32, (M,))
    for key, (t, dtype, shape) in want.items():
        if t.device != rows.device:
            raise ValueError(f"{name}: {key} is on {t.device}, rows on "
                             f"{rows.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if Z < 1:
        raise ValueError(f"{name}: ze must hold at least one zone")
    return M, Da, Z, Dz


def ce_forward_fused(rows, targets, wd, ze):
    """The cross-entropy forward. Arguments and result as
    :func:`ce_forward_reference`; on CUDA the kernel K3f."""
    M, Da, Z, Dz = _check_ce("ce_forward_fused", rows, targets, wd, ze)
    if not _kernel_device("ce_forward_fused", rows, ce_kernels_fit(Da, Dz),
                          (Da, Dz), CE_WIDTHS):
        return ce_forward_reference(rows, targets, wd, ze)
    nll = torch.empty((M,), dtype=torch.float32, device=rows.device)
    correct = torch.empty((M,), dtype=torch.int32, device=rows.device)
    if M == 0:
        return nll, correct
    lib = _lib()
    ze_p, _ = pad_zones(ze)
    ops = [rows.contiguous(), targets.contiguous(),
           wd.T.contiguous(), ze_p, nll, correct]
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        err = lib.ananke_ce_forward(*[t.data_ptr() for t in ops], M, Z,
                                    ze_p.shape[0], Da, Dz, stream)
    _raise_on(lib, err, "ce_forward_fused")
    ce_forward_fused.launches += 1
    return nll, correct


ce_forward_fused.launches = 0


def ce_backward_fused(rows, targets, wd, ze, g_nll):
    """The cross-entropy backward. Arguments and result as
    :func:`ce_backward_reference`; on CUDA the kernel K3b. The summed
    gradients are deterministic: the same operands give the same bits."""
    M, Da, Z, Dz = _check_ce("ce_backward_fused", rows, targets, wd, ze,
                             g_nll)
    if not _kernel_device("ce_backward_fused", rows, ce_kernels_fit(Da, Dz),
                          (Da, Dz), CE_WIDTHS):
        return ce_backward_reference(rows, targets, wd, ze, g_nll)
    dev = rows.device
    gx = torch.zeros((M, Da), dtype=torch.float32, device=dev)
    gsum = torch.zeros(((Z + Da) * Dz,), dtype=torch.float32, device=dev)
    if M > 0:
        lib = _lib()
        num_ctas = min(CE_SLABS, -(-M // lib.ananke_ce_bwd_tile_rows()))
        slabs = torch.empty((num_ctas, gsum.numel()), dtype=torch.float32,
                            device=dev)
        ze_p, zeT = pad_zones(ze)
        ops = [rows.contiguous(), targets.contiguous(), g_nll.contiguous(),
               wd.T.contiguous(), wd.contiguous(), ze_p, zeT, gx, slabs,
               gsum]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ananke_ce_backward(*[t.data_ptr() for t in ops], M, Z,
                                         ze_p.shape[0], num_ctas, Da, Dz,
                                         stream)
        _raise_on(lib, err, "ce_backward_fused")
        ce_backward_fused.launches += 1
    return gx, gsum[Z * Dz:].view(Da, Dz), gsum[: Z * Dz].view(Z, Dz)


ce_backward_fused.launches = 0


# ---- autograd ---------------------------------------------------------------

KERNELS = {"day": (day_forward_fused, day_backward_fused),
           "ce": (ce_forward_fused, ce_backward_fused)}
# the plain versions in the same places: a run of the same step without the
# kernels, to hold the kernels' step against
PLAIN = {"day": (day_forward_reference, day_backward_reference),
         "ce": (ce_forward_reference, ce_backward_reference)}


class _DayCore(torch.autograd.Function):
    """xs_all of the day; residual: xs_all (as ``_day_core_fwd``)."""

    @staticmethod
    def forward(ctx, impl, nb, x0, h, ze, Wq, W1xc, W1h, tf_pre, dts, W3,
                b3, *flat_blocks):
        blocks = tuple(tuple(flat_blocks[4 * i: 4 * i + 4])
                       for i in range(nb))
        w16 = tuple(w.to(BF16) for w in (Wq, W1xc, W1h)) + (
            tuple(tuple(w.to(BF16) for w in b) for b in blocks),
            W3.to(BF16), b3.to(BF16))
        ze16 = ze.to(BF16)
        xs_all = impl[0](x0.contiguous(), h.contiguous(), ze16,
                         tf_pre.contiguous(), dts, w16)
        ctx.impl, ctx.w16, ctx.ze16 = impl, w16, ze16
        ctx.save_for_backward(xs_all, h, tf_pre, dts)
        return xs_all

    @staticmethod
    def backward(ctx, g_xs):
        xs_all, h, tf_pre, dts = ctx.saved_tensors
        (gx0, gh, gze, gWq, gW1xc, gW1h, gtfp, gblocks, gW3,
         gb3) = ctx.impl[1](xs_all, g_xs.contiguous(), h, ctx.ze16, tf_pre,
                            dts, ctx.w16)
        flat = [g for blk in gblocks for g in blk]
        return (None, None, gx0, gh, gze, gWq, gW1xc, gW1h, gtfp, None, gW3,
                gb3, *flat)


def rk4_day_rollout(x0, h, zone_emb, W1_full, b1, Wq, blocks, W3, b3, times,
                    *, substeps: int, _impl=None):
    """Differentiable full-day RK4 rollout through the day kernels.

    x0: (N, Da) float32; h: (N, Hc) float32; zone_emb: (Z, Dz) float32;
    W1_full: (Da + Dz + Hc + 2, H) Dense_0 kernel in the drift's concat row
    order [x, ctx, h, sin_t, cos_t]; ``blocks``: (Wr1, br1, Wr2, br2) per
    residual block; every matrix (in, out). Returns xs (T, N, Da) float32 at
    the output times (row 0 = x0), with gradients with respect to every
    argument but ``times``: the time grid is fixed data (the VJP kernel
    does not carry the direct dependence of the RK4 update on dt), as in
    the reference. ``_impl``: (forward, backward) pair, default the kernel
    wrappers (:data:`KERNELS`).
    """
    times = times.detach()
    Da, Dz = x0.shape[1], zone_emb.shape[1]
    W1xc, W1h, W1t = split_w1(W1_full, Da, Dz)
    dts, tf_pre = stage_times_table(times, substeps, W1t, b1)
    flat = [w for blk in blocks for w in blk]
    xs_all = _DayCore.apply(_impl or KERNELS["day"], len(blocks), x0, h,
                            zone_emb, Wq, W1xc, W1h, tf_pre, dts, W3, b3,
                            *flat)
    return xs_all[::substeps]


class _DecodeCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, rows, targets, Wd, ze):
        wd16, ze16 = Wd.to(BF16), ze.to(BF16)
        nll, correct = impl[0](rows.contiguous(), targets, wd16, ze16)
        ctx.impl, ctx.wd16, ctx.ze16 = impl, wd16, ze16
        ctx.save_for_backward(rows, targets)
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, g_nll, _g_correct):
        rows, targets = ctx.saved_tensors
        gx, gWd, gze = ctx.impl[1](rows.contiguous(), targets, ctx.wd16,
                                   ctx.ze16, g_nll.contiguous())
        return None, gx, None, gWd, gze


def decode_ce(rows, targets, Wd, ze, *, _impl=None):
    """Per-row softmax cross-entropy of the decode head through the
    cross-entropy kernels.

    rows: (M, Da) float32 flattened agent-time states; targets: (M,) int32;
    Wd: (Da, Dz) decode projection; ze: (Z, Dz) zone embeddings, both
    float32 (rounded to bf16 here). Returns (nll (M,) float32, correct (M,)
    int32), differentiable with respect to rows, Wd and ze; the logits are
    recomputed in the backward and never stored. ``_impl``: (forward,
    backward) pair, default the kernel wrappers (:data:`KERNELS`).
    """
    return _DecodeCE.apply(_impl or KERNELS["ce"], rows, targets, Wd, ze)


__all__ = [
    "split_w1", "stage_times_table", "day_kernels_fit", "ce_kernels_fit",
    "day_forward_reference", "day_forward_fused",
    "day_backward_reference", "day_backward_fused",
    "ce_forward_reference", "ce_forward_fused",
    "ce_backward_reference", "ce_backward_fused",
    "rk4_day_rollout", "decode_ce", "KERNELS", "PLAIN",
]
