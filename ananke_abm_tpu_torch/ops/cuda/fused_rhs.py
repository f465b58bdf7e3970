"""The GAT-ODE drift as the continuous adjoint's right-hand sides: one
drift evaluation and its whole VJP in one launch (the backward's augmented
right-hand side), and one drift evaluation alone (the forward's).

Port of ``ananke_abm_tpu/ops/pallas/fused_rhs.py``. Two kernels (CUDA C++
in ``csrc/fused_rhs.cu``) replace the two Pallas kernels of that file, each
with its plain PyTorch version beside it, which the wrapper takes for
tensors on the CPU:

- :func:`drift_rhs_and_vjp` (K8, ``drift_rhs_and_vjp``) and
  :func:`drift_rhs_and_vjp_reference`: one
  :func:`~ananke_abm_tpu_torch.ops.cuda.fused_step.stage_math` and one
  :func:`~ananke_abm_tpu_torch.ops.cuda.fused_step.stage_vjp_math`;
- :func:`drift_rhs_fused` (K8a, ``drift_rhs_fused``) and
  :func:`drift_rhs_reference`: the stage math alone.

Both round as the reference does: bf16 operands, float32 sums.
:func:`make_fused_adjoint_rhs` pairs them for ``ode.odeint_adjoint``; the
trainer keeps only its ``rhs_vjp``, as the reference's does, and runs its
forward through ``model.rhs`` in float32.

Weights are passed as the reference passes them: float32, in the JAX
package's layout (every matrix (in, out)), as :func:`split_drift_params`
returns them; they are rounded to bf16 here.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ananke_abm_tpu_torch.models.gnn_embed.params import flax_leaf_params
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    BF16,
    _dot,
    _kernel_device,
    _nt_dot,
    _raise_on,
    stage_kernels_fit,
    stage_math,
    stage_vjp_math,
)

# CTAs of the kernel, each summing its share of agent tiles into its own
# partial slab of the weight gradients; the slabs are then summed in a
# fixed order. A constant, so the sums' order depends on N alone and a
# launch repeated on the same operands gives the same bits. 132 = the
# H100's SM count: one CTA per SM fits its shared memory.
NUM_SLABS = 132


def split_drift_params(named):
    """Flax path -> tensor mapping (``dict(flax_leaf_params(model))``) ->
    the drift's float32 weights in the JAX package's layout:
    ``(Wq, W1xc, W1h, W1t, b1, blocks, W3, b3)``, ``blocks`` a tuple of
    (Wr1, br1, Wr2, br2) per residual block. Dense_0's kernel is split by
    the drift's concat order [x, ctx, h, sin_t, cos_t]. The results are
    views of the tensors given, so autograd sees through them.
    """
    Wq = named[("query_proj", "kernel")].T
    Da, Dz = Wq.shape
    n_dense = sum(1 for p in named if p[0] == "drift" and p[-1] == "kernel")
    num_blocks = (n_dense - 2) // 2
    if num_blocks < 1:
        raise ValueError(
            "the fused adjoint RHS requires num_blocks >= 1 residual drift "
            f"blocks (got a drift with {n_dense} Dense layers); use the "
            "plain path for block-free drifts"
        )
    dense = lambda i, leaf: named[("drift", f"Dense_{i}", leaf)]
    W1 = dense(0, "kernel").T
    Hc = W1.shape[0] - Da - Dz - 2
    blocks = tuple(
        (dense(1 + 2 * i, "kernel").T, dense(1 + 2 * i, "bias"),
         dense(2 + 2 * i, "kernel").T, dense(2 + 2 * i, "bias"))
        for i in range(num_blocks)
    )
    return (Wq, W1[: Da + Dz], W1[Da + Dz: Da + Dz + Hc],
            W1[Da + Dz + Hc:], dense(0, "bias"), blocks,
            dense(n_dense - 1, "kernel").T, dense(n_dense - 1, "bias"))


def time_features(t, device) -> torch.Tensor:
    """(2,) float32 [sin, cos] of the day angle at time ``t``."""
    ang = torch.as_tensor(t, dtype=torch.float32, device=device) * (
        2 * np.pi / 24.0)
    return torch.stack([torch.sin(ang), torch.cos(ang)])


def time_row(t, W1t, b1):
    """Scalar time -> (1, H) float32 additive Dense_0 pre-activation: the
    sin/cos rows plus the bias, from the float32 weights."""
    tfeat = time_features(t, W1t.device)
    return tfeat[None, :] @ W1t.float() + b1.float()[None, :]


def _to16(blocks):
    return tuple(tuple(w.to(BF16) for w in blk) for blk in blocks)


def _scale(dz) -> float:
    return float(np.float32(1.0 / np.sqrt(float(dz))))


def drift_rhs_reference(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3):
    """Plain PyTorch version of K8a: dx/dt of the drift, forward only. x
    (N, Da), h (N, Hc), ze (Z, Dz) float32; tf_row (1, H) from
    :func:`time_row`; float32 weights, rounded to bf16 here. Returns (N, Da)
    float32."""
    hpre = _dot(h.to(BF16), W1h.to(BF16))
    k, _ = stage_math(x.to(BF16), hpre, tf_row.float(), ze.to(BF16),
                      _scale(ze.shape[1]), Wq.to(BF16), W1xc.to(BF16),
                      _to16(blocks), W3.to(BF16), b3.to(BF16))
    return k


def drift_rhs_fused(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3):
    """dx/dt of the drift, forward only. Arguments and result as
    :func:`drift_rhs_reference`.

    CPU tensors take the plain version. CUDA tensors launch K8a of
    ``csrc/fused_rhs.cu`` or raise (widths it is not compiled for, too many
    blocks, a refused launch); there is no fallback. Not differentiable, as
    the reference's: the continuous adjoint's forward solve and its initial
    step probe, which nothing differentiates. ``.launches`` counts the
    kernel launches."""
    N, Da, Z, Dz, Dc, H = _check(x, h, ze, tf_row, Wq, W1xc, W1h, blocks,
                                 W3, b3)
    if not _kernel_device("drift_rhs_fused", x, (Da, Dz, Dc, H), blocks):
        return drift_rhs_reference(x, h, ze, tf_row, Wq, W1xc, W1h, blocks,
                                   W3, b3)
    dev = x.device
    f = torch.empty((N, Da), dtype=torch.float32, device=dev)
    if N == 0:
        return f
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    lib = load_library("fused_rhs")
    ze_p, zeT = pad_zones(ze)
    ops = [x.contiguous(), h.contiguous(), ze_p, zeT,
           tf_row.float().contiguous(),
           *pack_stage_weights(Wq, W1xc, W1h, blocks, W3, b3), f]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_drift_rhs(*[t.data_ptr() for t in ops], N, Z,
                                   ze_p.shape[0], len(blocks), Da, Dz, Dc,
                                   H, stream)
    _raise_on(lib, err, "drift_rhs_fused")
    drift_rhs_fused.launches += 1
    return f


drift_rhs_fused.launches = 0


def drift_rhs_and_vjp_reference(x, h, ze, tf_row, Wq, W1xc, W1h, blocks,
                                W3, b3, a):
    """Plain PyTorch version of the kernel. Arguments as
    :func:`drift_rhs_fused`, plus ``a`` (N, Da) float32, the cotangent of
    the output. Returns ``(f, gx, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks,
    gW3, gb3)``: f, gx (N, Da), gh (N, Hc), and, summed over agents, gze
    (Z, Dz), gtf (1, H), and the weight gradients shaped like the
    weights (``gblocks``: per block (gWr1, gbr1, gWr2, gbr2)), all
    float32."""
    N, Da = x.shape
    Z, Dz = ze.shape
    H = W1xc.shape[1]
    scale = _scale(Dz)
    hb, ze16 = h.to(BF16), ze.to(BF16)
    wq16, w1xc16, w1h16, w316 = (w.to(BF16) for w in (Wq, W1xc, W1h, W3))
    blk16 = _to16(blocks)
    hpre = _dot(hb, w1h16)
    f, inter = stage_math(x.to(BF16), hpre, tf_row.float(), ze16, scale,
                          wq16, w1xc16, blk16, w316, b3.to(BF16))
    tw = (ze16, ze16.T, wq16.T, w1xc16.T,
          tuple((b[0].T, b[2].T) for b in blk16), w316.T)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=x.device)
    acc0 = (z(Z, Dz), z(Da, Dz), z(Da + Dz, H), z(N, H),
            tuple((z(H, H), z(1, H), z(H, H), z(1, H)) for _ in blocks),
            z(H, Da), z(1, Da))
    gx, gtf, acc = stage_vjp_math(a, inter, acc0, tw, scale, Da)
    (gze, gWq, gW1xc, ghp, gblk, gW3, gb3) = acc
    # hpre = hb @ W1h: gh per agent, gW1h summed over agents
    ghp16 = ghp.to(BF16)
    gh = _dot(ghp16, w1h16.T)
    gW1h = _nt_dot(hb, ghp16)
    gblocks = tuple((g1, gb1[0], g2, gb2[0]) for (g1, gb1, g2, gb2) in gblk)
    return f, gx, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3[0]


def _check(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3, a=None):
    """Validate the operands (K8a's: no ``a``); returns (N, Da, Z, Dz, Dc,
    H)."""
    N, Da = x.shape
    Z, Dz = ze.shape
    Dc = h.shape[1]
    H = W1xc.shape[1]
    want = {
        "x": (x, (N, Da)), "h": (h, (N, Dc)),
        "ze": (ze, (Z, Dz)), "tf_row": (tf_row, (1, H)),
        "Wq": (Wq, (Da, Dz)), "W1xc": (W1xc, (Da + Dz, H)),
        "W1h": (W1h, (Dc, H)), "W3": (W3, (H, Da)), "b3": (b3, (Da,)),
    }
    if a is not None:
        want["a"] = (a, (N, Da))
    for i, (wr1, br1, wr2, br2) in enumerate(blocks):
        want[f"Wr1[{i}]"] = (wr1, (H, H))
        want[f"br1[{i}]"] = (br1, (H,))
        want[f"Wr2[{i}]"] = (wr2, (H, H))
        want[f"br2[{i}]"] = (br2, (H,))
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
    if len(blocks) < 1:
        raise ValueError("the adjoint RHS kernel needs >= 1 residual block")
    if Z < 1:
        raise ValueError("ze must hold at least one zone")
    return N, Da, Z, Dz, Dc, H


def grad_layout(Z, Dz, Da, Dc, H, num_blocks, time_shape=None):
    """Names and shapes of the summed gradients, in the order the kernels
    write them into one float32 vector (``Slab`` in
    ``csrc/drift_stage.cuh``). ``time_shape``: that of the time rows'
    gradient, (1, H) for one stage."""
    out = [("gze", (Z, Dz)), ("gtf", time_shape or (1, H)), ("gWq", (Da, Dz)),
           ("gW1xc", (Da + Dz, H)), ("gW1h", (Dc, H))]
    for i in range(num_blocks):
        out += [(f"gWr1[{i}]", (H, H)), (f"gbr1[{i}]", (H,)),
                (f"gWr2[{i}]", (H, H)), (f"gbr2[{i}]", (H,))]
    return out + [("gW3", (H, Da)), ("gb3", (Da,))]


# whether K8 and K8a take (agent, zone, context, hidden) widths and
# residual blocks
kernel_fits = stage_kernels_fit


def drift_rhs_and_vjp(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3, a):
    """One drift evaluation and its VJP at ``a``. Arguments and result as
    :func:`drift_rhs_and_vjp_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/fused_rhs.cu`` or raise (widths it is not compiled for, too
    many blocks, a refused launch); there is no fallback. The summed
    gradients are deterministic: the same operands give the same bits.
    ``.launches`` counts the kernel launches.
    """
    N, Da, Z, Dz, Dc, H = _check(x, h, ze, tf_row, Wq, W1xc, W1h, blocks,
                                 W3, b3, a)
    if not _kernel_device("drift_rhs_and_vjp", x, (Da, Dz, Dc, H), blocks):
        return drift_rhs_and_vjp_reference(x, h, ze, tf_row, Wq, W1xc, W1h,
                                           blocks, W3, b3, a)
    nb = len(blocks)
    dev = x.device
    f = torch.empty((N, Da), dtype=torch.float32, device=dev)
    gx = torch.empty_like(f)
    gh = torch.empty((N, Dc), dtype=torch.float32, device=dev)
    layout = grad_layout(Z, Dz, Da, Dc, H, nb)
    gsum = torch.zeros((sum(int(np.prod(s)) for _, s in layout),),
                       dtype=torch.float32, device=dev)
    if N > 0:
        _launch(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3, a,
                f, gx, gh, gsum)
    return (f, gx, gh, *split_grads(gsum, layout, nb))


def split_grads(gsum, layout, nb):
    """The kernel's summed-gradient vector -> ``(gze, gtf, gWq, gW1xc,
    gW1h, gblocks, gW3, gb3)`` as views, shaped by ``layout``."""
    sizes = [int(np.prod(s)) for _, s in layout]
    parts = [p.view(s) for p, (_, s) in zip(torch.split(gsum, sizes),
                                             layout)]
    gblocks = tuple(tuple(parts[5 + 4 * i: 9 + 4 * i]) for i in range(nb))
    return (*parts[:5], gblocks, *parts[5 + 4 * nb:])


drift_rhs_and_vjp.launches = 0


def pad_zones(ze):
    """(Z, Dz) zones -> bf16 (zp, Dz) and its (Dz, zp) transpose, zp the
    next multiple of 16: the kernels walk zones in chunks of 16 and mask the
    zero rows past Z."""
    Z, Dz = ze.shape
    zp = -(-Z // 16) * 16
    ze_p = torch.zeros((zp, Dz), dtype=BF16, device=ze.device)
    ze_p[:Z] = ze
    return ze_p, ze_p.T.contiguous()


def pack_stage_weights(Wq, W1xc, W1h, blocks, W3, b3):
    """The drift's weights ((in, out) layout, any float type) -> the 12 bf16
    tensors the stage kernels take, in the order of ``set_weights`` in
    ``csrc/drift_stage.cuh``. Each matrix comes both ways: (out, in) rows
    for the forward products and (in, out) rows for the backward ones, so
    that one 32-bit load gives the two bf16 of an mma B-fragment register."""
    c16 = lambda w: w.to(BF16).contiguous()
    mats = [w for blk in blocks for w in (blk[0], blk[2])]
    return [
        c16(Wq.T), c16(Wq), c16(W1xc.T), c16(W1xc), c16(W1h.T), c16(W1h),
        torch.stack([w.T for w in mats]).to(BF16).contiguous(),
        torch.stack(mats).to(BF16).contiguous(),
        torch.stack([b for blk in blocks for b in (blk[1], blk[3])]).to(
            BF16).contiguous(),
        c16(W3.T), c16(W3), c16(b3),
    ]


def _launch(x, h, ze, tf_row, Wq, W1xc, W1h, blocks, W3, b3, a,
            f, gx, gh, gsum):
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    lib = load_library("fused_rhs")
    N = x.shape[0]
    Z, Dz = ze.shape
    Da, Dc, H = x.shape[1], h.shape[1], W1xc.shape[1]
    nb = len(blocks)
    dev = x.device
    ze_p, zeT = pad_zones(ze)
    ops = [
        x.contiguous(), h.contiguous(), a.contiguous(), ze_p, zeT,
        tf_row.float().contiguous(),
        *pack_stage_weights(Wq, W1xc, W1h, blocks, W3, b3),
        f, gx, gh,
    ]
    zp = ze_p.shape[0]
    # agent rows per tile: the kernel's choice for this depth
    rows = lib.ananke_drift_rhs_tile_rows(nb)
    num_ctas = min(NUM_SLABS, -(-N // rows))
    slabs = torch.empty((num_ctas, gsum.numel()), dtype=torch.float32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_drift_rhs_and_vjp(
            *[t.data_ptr() for t in ops], slabs.data_ptr(), gsum.data_ptr(),
            N, Z, zp, nb, num_ctas, Da, Dz, Dc, H, stream,
        )
    _raise_on(lib, err, "drift_rhs_and_vjp")
    drift_rhs_and_vjp.launches += 1


def make_fused_adjoint_rhs(model, drift_vjp=None, drift_fwd=None):
    """``(rhs, rhs_vjp)`` for ``ode.odeint_adjoint`` over the GAT-ODE drift
    with ``args = (params, h, zone_emb)``, ``params`` the tuple of every
    model parameter in :func:`flax_leaf_params` order.

    ``rhs`` runs ``drift_fwd`` (default :func:`drift_rhs_fused`, K8a on
    the card). ``rhs_vjp`` runs ``drift_vjp`` (default
    :func:`drift_rhs_and_vjp`, K8) and scatters the weight cotangents into
    a gradient for every parameter in the same order: the drift's from the
    kernel, Dense_0's time rows and bias through :func:`time_row`, exact
    zeros for the parameters the drift never reads (the encoder's, the
    context's, the decode's). The plain versions in their places give the
    same pair without the kernels.
    """
    drift_vjp = drift_vjp or drift_rhs_and_vjp
    drift_fwd = drift_fwd or drift_rhs_fused
    paths = [p for p, _ in flax_leaf_params(model)]
    split_drift_params(dict(flax_leaf_params(model)))  # raises early
    n_dense = 2 + 2 * model.num_blocks

    def prep(params, t):
        (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = split_drift_params(
            dict(zip(paths, params)))
        return (Wq, W1xc, W1h, blocks, W3, b3), time_row(t, W1t, b1)

    def rhs(t, x, args):
        params, h, zone_emb = args
        w, tf = prep(params, t)
        return drift_fwd(x, h, zone_emb, tf, *w)

    def rhs_vjp(t, x, args, a):
        params, h, zone_emb = args
        (Wq, W1xc, W1h, blocks, W3, b3), tf = prep(params, t)
        (f, gx, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3,
         gb3) = drift_vjp(x, h, zone_emb, tf, Wq, W1xc, W1h, blocks, W3,
                          b3, a)
        # tf = tfeat @ W1t + b1
        gW1t = time_features(t, x.device)[:, None] * gtf
        grads = {
            ("query_proj", "kernel"): gWq.T,
            ("drift", "Dense_0", "kernel"): torch.cat(
                [gW1xc, gW1h, gW1t]).T,
            ("drift", "Dense_0", "bias"): gtf[0],
            ("drift", f"Dense_{n_dense - 1}", "kernel"): gW3.T,
            ("drift", f"Dense_{n_dense - 1}", "bias"): gb3,
        }
        for i, (g1, gb1, g2, gb2) in enumerate(gblocks):
            grads[("drift", f"Dense_{1 + 2 * i}", "kernel")] = g1.T
            grads[("drift", f"Dense_{1 + 2 * i}", "bias")] = gb1
            grads[("drift", f"Dense_{2 + 2 * i}", "kernel")] = g2.T
            grads[("drift", f"Dense_{2 + 2 * i}", "bias")] = gb2
        gparams = tuple(grads[p] if p in grads else torch.zeros_like(w)
                        for p, w in zip(paths, params))
        return f, gx, (gparams, gh, gze)

    return rhs, rhs_vjp


__all__ = [
    "split_drift_params", "time_row", "drift_rhs_reference",
    "drift_rhs_fused", "kernel_fits",
    "drift_rhs_and_vjp_reference", "drift_rhs_and_vjp",
    "make_fused_adjoint_rhs",
]
