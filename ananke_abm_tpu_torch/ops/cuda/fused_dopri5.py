"""The DOPRI5 step of the GAT-ODE drift, the VJP of one accepted step, and
the whole discrete-adjoint backward: each one kernel.

Port of ``ananke_abm_tpu/ops/pallas/fused_dopri5.py``. Three kernels (CUDA
C++ in ``csrc/fused_dopri5.cu``) replace the three Pallas kernels of that
file, each with its plain PyTorch version beside it:

- :func:`dopri5_step_fused` (K5, ``dopri5_step_fused``) and
  :func:`dopri5_step_reference`: the six stage evaluations, the 5th-order
  update, the FSAL eval, the embedded error (or, with ``err_stats``, the
  masked sum of its scaled squares) and the CONTD5 coefficient ``r5``;
- :func:`dopri5_step_vjp_fused` (K7, ``dopri5_step_vjp_fused``) and
  :func:`dopri5_step_vjp_reference`: the VJP of one accepted step;
- :func:`dopri5_backward_fused` (K6, ``dopri5_backward_fused``) and
  :func:`dopri5_backward_reference`: the VJPs of every accepted step in
  reverse, the dense-output cotangent fold of each step and the cotangent
  carries between steps, in one launch.

All run the shared stage math (``fused_step.stage_math`` /
``stage_vjp_math``) at ``precision="f32"`` (float32: the identity cast; K7
and K6 on float32 FFMA, K5's products in 3xTF32 on the tensor cores, each
operand split into two TF32 parts with float32 sums) or ``"bf16"`` (bf16
operands and float32 sums at the reference's rounding points, on
``csrc/drift_stage.cuh``). The trainers' forward is
float32: bf16 rounding of the stage activations is noise that does not
cancel in the embedded 5(4) error and floors the step controller, so the
reference keeps K5's bf16 branch for loose tolerances (rtol >= ~1e-3),
reached through ``make_fused_dopri5_hooks(precision="bf16")``. A bf16
backward replays the forward's step sequence, so it costs gradient noise,
not a different solve.

Each wrapper takes its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises (widths it is not compiled for, a
precision it does not take, a refused launch); there is no fallback.
``.launches`` counts the kernel launches. :func:`make_fused_dopri5_hooks`
builds the ``(step_impl, step_vjp)`` pair ``ode.odeint_discrete_adjoint``
takes, ``step_vjp.backward_all`` the whole-backward hook.

Weights are passed as the reference passes them: float32, in the JAX
package's layout (every matrix (in, out)), as ``split_drift_params``
returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from ananke_abm_tpu_torch.models.gnn_embed.params import flax_leaf_params
from ananke_abm_tpu_torch.ode.dopri5 import (
    _A,
    _B4,
    _B5,
    _C,
    _D,
    F,
    ErrNormSq,
    _Interp,
    _mul,
)
from ananke_abm_tpu_torch.ops.cuda import fused_step
from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
    NUM_SLABS,
    _scale,
    grad_layout,
    pack_stage_weights,
    pad_zones,
    split_drift_params,
    split_grads,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    KERNEL_WIDTHS,
    MAX_KERNEL_BLOCKS,
    keep,
    stage_kernels_fit,
    stage_math,
    stage_vjp_math,
    time_feature_table,
)
from ananke_abm_tpu_torch.ops.cuda.fused_train import _raise_on

# embedded-error weights b5 - b4 (k7's b5 is 0)
_BE = tuple(b5 - b4 for b5, b4 in zip(_B5, _B4))


# whether K5 and K7 take (agent, zone, context, hidden) widths and residual
# blocks
kernels_fit = stage_kernels_fit


def _mk_cast(precision):
    if precision == "f32":
        return keep
    if precision == "bf16":
        return fused_step._to16
    raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")


def stage_time_rows(t0, h_step, W1t, b1):
    """(7, H) float32 additive Dense_0 pre-activations at the seven stage
    times ``t0 + c_i h`` (row 0 unused: k1 is the FSAL input), the times
    in the reference's float32 arithmetic. Differentiable with respect to
    W1t and b1."""
    return stage_time_table([t0], [h_step], W1t, b1)[0]


def _host_f32(a):
    return (a.detach().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a)).astype(np.float32)


def stage_time_table(rec_t0, rec_h, W1t, b1):
    """(S, 7, H) float32: :func:`stage_time_rows` of every recorded step
    (start ``rec_t0[s]``, size ``rec_h[s]``, each (S,)), the times in the
    reference's float32 arithmetic. Differentiable with respect to W1t and
    b1."""
    t0, h = _host_f32(rec_t0), _host_f32(rec_h)
    stage_t = t0[:, None] + np.asarray(_C, np.float32)[None, :] * h[:, None]
    return time_feature_table(
        torch.from_numpy(stage_t.reshape(-1)).to(W1t.device), W1t,
        b1).reshape(len(t0), 7, -1)


def _prepare(h, ze, Wq, W1xc, W1h, blocks, W3, b3, cast):
    """The cast operands of the stage math and the h-row product (h is
    constant over the step: one product, not one per stage)."""
    w = (cast(Wq), cast(W1xc), tuple(tuple(cast(t) for t in b)
                                     for b in blocks), cast(W3), cast(b3))
    hb = cast(h)
    return hb, cast(ze), w, fused_step._dot(hb, cast(W1h))


def _stage_inputs(x0, ks, i, h_step):
    """x0 + sum_j (h a_ij) k_j, summed in the tableau's order."""
    y = x0
    for j, a in enumerate(_A[i]):
        if a != 0.0:
            y = y + _mul(h_step, a) * ks[j]
    return y


def _lincomb(coefs, ks):
    return sum(c * k for c, k in zip(coefs, ks) if c != 0.0)


def dopri5_step_reference(x, f0, h, ze, tf_rows, Wq, W1xc, W1h, blocks, W3,
                          b3, h_step, precision="f32", err_stats=None):
    """Plain PyTorch version of K5.

    x, f0: (N, Da) float32 state at t0 and its FSAL eval; h: (N, Hc)
    float32 context; ze: (Z, Dz) float32 zones; tf_rows: (7, H) from
    :func:`stage_time_rows`; float32 weights; h_step: the step size.
    Returns ``(y1, f1, err, r5)``, each (N, Da) float32: the 5th-order
    update, the FSAL eval at (t0 + h, y1), the embedded error ``h sum_i
    (b5_i - b4_i) k_i`` and ``r5 = h sum_i d_i k_i``. With ``err_stats=(rtol,
    atol)`` ``err`` is a (1, 1) float32 tensor instead:
    ``sum((err / (atol + rtol max(|x|, |y1|)))^2)`` over every element.
    """
    cast = _mk_cast(precision)
    hb, zec, (wq, w1xc, blk, w3, b3c), hpre = _prepare(
        h, ze, Wq, W1xc, W1h, blocks, W3, b3, cast)
    scale = _scale(ze.shape[1])
    hs = float(F(h_step))
    ks = [f0]
    for i in range(1, 7):
        k, _ = stage_math(cast(_stage_inputs(x, ks, i, h_step)), hpre,
                          tf_rows[i][None, :], zec, scale, wq, w1xc, blk, w3,
                          b3c, cast=cast)
        ks.append(k)
    y1 = x + hs * _lincomb(_B5[:6], ks[:6])
    err = hs * _lincomb(_BE, ks)
    if err_stats is not None:
        rtol, atol = (float(F(v)) for v in err_stats)
        esc = err / (atol + rtol * torch.maximum(x.abs(), y1.abs()))
        err = torch.sum(esc * esc).reshape(1, 1)
    return y1, ks[6], err, hs * _lincomb(_D, ks)


def dopri5_step_vjp_reference(x, f0, h, ze, tf_rows, Wq, W1xc, W1h, blocks,
                              W3, b3, h_step, g_dy, g_r5, g_k1x, g_k7x,
                              g_y0_direct, precision="f32"):
    """Plain PyTorch version of K7: the VJP of one accepted step.

    Operands as :func:`dopri5_step_reference`, plus the step's folded
    output cotangents (each (N, Da) float32; ``ode/discrete_adjoint.py``
    derives them). The six stages are evaluated again from ``(x, f0)``;
    then the stage VJPs run through the tableau in reverse: stage j's
    cotangent is ``h (b5_j g_dy + d_j g_r5)``, plus ``g_k1x`` on k1 and
    ``g_k7x`` on k7, plus ``h a_ij gx_i`` from every later stage i.

    Returns ``(gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3,
    gb3)``: per agent gy0, gf0 (N, Da) and gh (N, Hc); gtf (7, H) the time
    rows' cotangents (row 0 zero); the rest summed over agents, shaped like
    the weights (``gblocks``: per block (gWr1, gbr1, gWr2, gbr2)).
    """
    cast = _mk_cast(precision)
    N, Da = x.shape
    Z, Dz = ze.shape
    H = W1xc.shape[1]
    hb, zec, (wq, w1xc, blk, w3, b3c), hpre = _prepare(
        h, ze, Wq, W1xc, W1h, blocks, W3, b3, cast)
    scale = _scale(Dz)
    hs = float(F(h_step))
    ks, inters = [f0], [None]
    for i in range(1, 7):
        k, inter = stage_math(cast(_stage_inputs(x, ks, i, h_step)), hpre,
                              tf_rows[i][None, :], zec, scale, wq, w1xc, blk,
                              w3, b3c, cast=cast)
        ks.append(k)
        inters.append(inter)
    tw = (zec, zec.T, wq.T, w1xc.T, tuple((b[0].T, b[2].T) for b in blk),
          w3.T)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=x.device)
    acc = (z(Z, Dz), z(Da, Dz), z(Da + Dz, H), z(N, H),
           tuple((z(H, H), z(1, H), z(H, H), z(1, H)) for _ in blocks),
           z(H, Da), z(1, Da))
    gk = [hs * (_B5[j] * g_dy + _D[j] * g_r5)
          if (_B5[j] != 0.0 or _D[j] != 0.0) else z(N, Da)
          for j in range(7)]
    gk[0] = gk[0] + g_k1x
    gk[6] = gk[6] + g_k7x
    gy0 = g_y0_direct
    gtf = [z(1, H)] * 7
    for i in range(6, 0, -1):
        gx, gtf[i], acc = stage_vjp_math(gk[i], inters[i], acc, tw, scale,
                                         Da, cast=cast)
        gy0 = gy0 + gx
        for j, a in enumerate(_A[i]):
            if a != 0.0:
                gk[j] = gk[j] + _mul(h_step, a) * gx
    (gze, gWq, gW1xc, ghp, gblk, gW3, gb3) = acc
    ghp_c, w1h = cast(ghp), cast(W1h)
    gh = fused_step._dot(ghp_c, w1h.T)
    gW1h = fused_step._nt_dot(hb, ghp_c)
    gblocks = tuple((g1, gb1[0], g2, gb2[0]) for (g1, gb1, g2, gb2) in gblk)
    return (gy0, gk[0], gh, gze, torch.cat(gtf), gWq, gW1xc, gW1h, gblocks,
            gW3, gb3[0])


def _dense_fold(g, g_y, g_f, out_step, ts, t0, h_step, step):
    """The step's folded cotangents ``(g_dy, g_r5, g_k1x, g_k7x,
    g_y0_direct)`` (``ode/discrete_adjoint.py`` derives them) from the
    carries ``g_y``, ``g_f`` and the output cotangents ``g`` (T, N, Da), as
    the reference's whole-backward kernel forms them: branch-free over the
    T rows, row t weighted by ``out_step[t] == step`` times the CONTD5
    basis ``(1, th, th om, th^2 om, th^2 om^2)``, ``th`` the row's clipped
    position in the step (``h_step == 0`` divides by 1). ``out_step`` and
    ``ts`` are (T,) tensors on g's device; ``t0`` and ``h_step`` float32
    values."""
    T = g.shape[0]
    safe_h = F(1.0) if F(h_step) == 0 else F(h_step)
    mask = (out_step == step).float()
    th = torch.clamp((ts - float(F(t0))) / float(safe_h), 0.0, 1.0)
    om = 1.0 - th
    w = torch.stack([mask, th * mask, th * om * mask, th * th * om * mask,
                     th * th * om * om * mask])  # (5, T)
    gr = [torch.zeros_like(g_y)] * 5
    for t in range(T):
        gr = [gr[k] + w[k, t] * g[t] for k in range(5)]
    gr1, gr2, gr3, gr4, gr5 = gr
    hf = float(F(h_step))
    return (g_y + gr2 - gr3 + 2.0 * gr4, gr5, hf * (gr3 - gr4),
            g_f - hf * gr4, g_y + gr1)


def dopri5_backward_reference(ckpts, ckpt_f, hc, ze, tf_all, rec_t0, rec_h,
                              n_acc, g, out_step, ts, Wq, W1xc, W1h, blocks,
                              W3, b3, precision="bf16"):
    """Plain PyTorch version of K6: the whole discrete-adjoint backward at
    ``ckpt_every=1`` with the FSAL evals recorded.

    ckpts, ckpt_f: (max_acc, N, Da) float32 or bf16, the pre-step state and
    FSAL eval of every accepted step (widened to float32 here); hc (N, Hc)
    and ze (Z, Dz) float32; tf_all (max_acc, 7, H) float32, the stage time
    rows of every recorded step (:func:`stage_time_table`); rec_t0, rec_h
    (max_acc,) the steps' starts and sizes, n_acc the accepted count; g (T,
    N, Da) float32 output cotangents; out_step (T,) the step that filled
    each row (-1: none), ts (T,) the output times; float32 weights.

    The steps ``n_acc - 1 ... 0`` are replayed in reverse: each folds the
    output rows it filled into its cotangents (:func:`_dense_fold`), runs
    :func:`dopri5_step_vjp_reference` at ``precision`` and carries ``(gy0,
    gf0)`` into the step before. Returns ``(gy0, gf0, gh, gze, gtf_all,
    gWq, gW1xc, gW1h, gblocks, gW3, gb3)``: gy0, gf0 the carries after step
    0 (the caller adds row 0 and the initial FSAL eval's VJP), gh (N, Hc)
    and the weight gradients summed over steps, gtf_all (max_acc, 7, H)
    each step's time-row cotangents (zero from n_acc on).
    """
    max_acc, N, Da = ckpts.shape
    Z, Dz = ze.shape
    H = W1xc.shape[1]
    dev = g.device
    t0s, hs = _host_f32(rec_t0), _host_f32(rec_h)
    ostep = torch.as_tensor(np.asarray(out_step), device=dev)
    tsd = torch.as_tensor(_host_f32(ts), device=dev)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    g_y, g_f, gh = z(N, Da), z(N, Da), z(N, hc.shape[1])
    sums = [z(Z, Dz), z(Da, Dz), z(Da + Dz, H), z(W1h.shape[0], H),
            tuple((z(H, H), z(H), z(H, H), z(H)) for _ in blocks), z(H, Da),
            z(Da)]
    gtf_all = z(max_acc, 7, H)
    for s in range(int(n_acc) - 1, -1, -1):
        gset = _dense_fold(g, g_y, g_f, ostep, tsd, t0s[s], hs[s], s)
        (g_y, g_f, gh_s, gze, gtf_all[s], *gw) = dopri5_step_vjp_reference(
            ckpts[s].float(), ckpt_f[s].float(), hc, ze, tf_all[s], Wq,
            W1xc, W1h, blocks, W3, b3, float(hs[s]), *gset,
            precision=precision)
        gh = gh + gh_s
        sums = [tuple(tuple(a + b for a, b in zip(u, v))
                      for u, v in zip(acc, part)) if i == 4 else acc + part
                for i, (acc, part) in enumerate(zip(sums, [gze, *gw]))]
    gze, gWq, gW1xc, gW1h, gblocks, gW3, gb3 = sums
    return (g_y, g_f, gh, gze, gtf_all, gWq, gW1xc, gW1h, gblocks, gW3,
            gb3)


def _check(name, rows, ze, tf_rows, Wq, W1xc, W1h, blocks, W3, b3):
    """Validate the operands: ``rows`` the (name, tensor, shape) of the
    per-agent ones. Returns (N, Da, Z, Dz, Dc, H)."""
    x = rows[0][1]
    N, Da = x.shape
    Z, Dz = ze.shape
    Dc = W1h.shape[0]
    H = W1xc.shape[1]
    want = list(rows) + [
        ("ze", ze, (Z, Dz)), ("tf_rows", tf_rows, (7, H)),
        ("Wq", Wq, (Da, Dz)), ("W1xc", W1xc, (Da + Dz, H)),
        ("W1h", W1h, (Dc, H)), ("W3", W3, (H, Da)), ("b3", b3, (Da,))]
    for i, (wr1, br1, wr2, br2) in enumerate(blocks):
        want += [(f"Wr1[{i}]", wr1, (H, H)), (f"br1[{i}]", br1, (H,)),
                 (f"Wr2[{i}]", wr2, (H, H)), (f"br2[{i}]", br2, (H,))]
    for key, t, shape in want:
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if len(blocks) < 1:
        raise ValueError(f"{name}: needs >= 1 residual block")
    if Z < 1:
        raise ValueError(f"{name}: ze must hold at least one zone")
    return N, Da, Z, Dz, Dc, H


def _kernel_device(name, x, widths, num_blocks, precision):
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    _mk_cast(precision)
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not kernels_fit(*widths, num_blocks):
        if widths not in KERNEL_WIDTHS:
            raise ValueError(
                f"{name}: the CUDA kernel is compiled for (agent, zone, "
                f"context, hidden) widths {KERNEL_WIDTHS}, got {widths}")
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{MAX_KERNEL_BLOCKS} residual blocks")
    return True


def _lib():
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    return load_library("fused_dopri5")


def pack_weights_f32(Wq, W1xc, W1h, blocks, W3, b3):
    """The drift's float32 weights ((in, out) layout) -> the 12 contiguous
    tensors the float32 kernels take, in the order of ``set_weights`` in
    ``csrc/fused_dopri5.cu``: each matrix (in, out) and its transpose (the
    forward's products read the first, the VJP's the second), the blocks'
    matrices stacked (Wr1_0, Wr2_0, ...) and their biases."""
    c = lambda w: w.float().contiguous()
    mats = [w for blk in blocks for w in (blk[0], blk[2])]
    return [c(Wq), c(Wq.T), c(W1xc), c(W1xc.T), c(W1h), c(W1h.T),
            c(torch.stack(mats)), c(torch.stack([w.T for w in mats])),
            c(torch.stack([b for blk in blocks for b in (blk[1], blk[3])])),
            c(W3), c(W3.T), c(b3)]


# zones per attention chunk of the float32 kernels (kZC in
# csrc/fused_dopri5.cu); the bf16 ones take chunks of 16 (pad_zones)
ZONE_CHUNK = 32
# CTAs of the kernels: each sums its tiles into its own slab (K5: its own
# partial error sum), summed in a fixed order; constants, so the sums'
# order depends on N alone and a repeated launch gives the same bits. K7,
# K6 and K5-bf16 take one an SM; K5 at float32 is offered two an SM (the
# C interface's count, which an A/B against a build of two CTAs an SM
# keeps) and its library runs on at most NUM_SLABS of them
STEP_CTAS = 2 * NUM_SLABS
VJP_CTAS = NUM_SLABS
# the kernels' tile bodies (ananke_dopri5_tile_rows' `kind`)
_K5, _F32_VJP, _BF16_VJP, _BF16_K5 = 0, 1, 2, 3


def _zones(ze):
    """(Z, Dz) -> float32 (zp, Dz) and (Dz, zp), zp the next multiple of
    ZONE_CHUNK, zero rows past Z (masked in the kernels)."""
    Z, Dz = ze.shape
    zp = -(-Z // ZONE_CHUNK) * ZONE_CHUNK
    ze_p = torch.zeros((zp, Dz), dtype=torch.float32, device=ze.device)
    ze_p[:Z] = ze
    return ze_p, ze_p.T.contiguous()


def pack_operands(ze, Wq, W1xc, W1h, blocks, W3, b3, precision="f32"):
    """The kernels' zone and weight operands at ``precision``: the padded
    zones and their transpose, then the 12 weight tensors
    (:func:`pack_weights_f32`; for "bf16" ``fused_rhs.pad_zones`` and
    ``pack_stage_weights``, rounded to bf16). One packing serves every
    launch over the same zones and weights (the hooks make one per solve
    and precision); the wrappers take it as ``packed=``."""
    w = (Wq, W1xc, W1h, blocks, W3, b3)
    if _mk_cast(precision) is keep:
        return (*_zones(ze), *pack_weights_f32(*w))
    return (*pad_zones(ze), *pack_stage_weights(*w))


def _packed(name, packed, ze, weights, precision="f32"):
    """``packed``, checked against the zones, or a packing made here."""
    if packed is None:
        return pack_operands(ze, *weights, precision=precision)
    Z, Dz = ze.shape
    f32 = precision == "f32"
    chunk = ZONE_CHUNK if f32 else 16
    if (len(packed) != 14 or tuple(packed[0].shape)
            != (-(-Z // chunk) * chunk, Dz) or packed[0].dtype
            != (torch.float32 if f32 else torch.bfloat16)):
        raise ValueError(f"{name}: packed is not pack_operands of these "
                         f"zones and weights at precision {precision!r}")
    return packed


def dopri5_step_fused(x, f0, h, ze, tf_rows, Wq, W1xc, W1h, blocks, W3, b3,
                      h_step, precision="f32", err_stats=None, packed=None):
    """One DOPRI5 step. Arguments and result as
    :func:`dopri5_step_reference`; on CUDA the kernel K5 at ``precision``
    (float32: products in 3xTF32 on the tensor cores, each operand split
    into two TF32 parts, float32 sums; or the bf16 stage math of
    ``drift_stage.cuh`` with the tableau and the error in float32), over
    ``packed``
    (:func:`pack_operands` of these zones and weights at the same precision)
    or a packing made for this launch. With ``err_stats`` the sum of squares
    is deterministic: the same operands give the same bits, and so the same
    step sequence."""
    rows = [("x", x, tuple(x.shape)), ("f0", f0, tuple(x.shape)),
            ("h", h, (x.shape[0], W1h.shape[0]))]
    N, Da, Z, Dz, Dc, H = _check("dopri5_step_fused", rows, ze, tf_rows, Wq,
                                 W1xc, W1h, blocks, W3, b3)
    nb = len(blocks)
    if not _kernel_device("dopri5_step_fused", x, (Da, Dz, Dc, H), nb,
                          precision):
        return dopri5_step_reference(x, f0, h, ze, tf_rows, Wq, W1xc, W1h,
                                     blocks, W3, b3, h_step, precision,
                                     err_stats)
    dev = x.device
    out = [torch.empty((N, Da), dtype=torch.float32, device=dev)
           for _ in range(4)]
    err_sum = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    if N == 0:
        return (*out[:2], err_sum if err_stats is not None else out[2],
                out[3])
    lib = _lib()
    bf16 = precision == "bf16"
    kind, ctas = (_BF16_K5, VJP_CTAS) if bf16 else (_K5, STEP_CTAS)
    num_ctas = min(ctas, -(-N // lib.ananke_dopri5_tile_rows(nb, kind)))
    # the CTAs' error sums; at float32 then the step state's scratch
    size = num_ctas if bf16 else num_ctas + 32 + num_ctas * (
        lib.ananke_dopri5_scratch_floats(nb, kind))
    partial = torch.empty((size,), dtype=torch.float32, device=dev)
    rtol, atol = (F(v) for v in err_stats) if err_stats else (F(0), F(0))
    ze_p, zeT, *w = _packed("dopri5_step_fused", packed, ze,
                            (Wq, W1xc, W1h, blocks, W3, b3), precision)
    ops = [x.contiguous(), f0.contiguous(), h.contiguous(), ze_p, zeT,
           tf_rows.contiguous(), *w, *out, partial, err_sum]
    step = lib.ananke_dopri5_step_bf16 if bf16 else lib.ananke_dopri5_step
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = step(
            *[t.data_ptr() for t in ops], N, Z, ze_p.shape[0], nb, num_ctas,
            int(err_stats is not None), F(h_step), rtol, atol, Da, Dz, Dc,
            H, stream)
    _raise_on(lib, err, "dopri5_step_fused")
    dopri5_step_fused.launches += 1
    y1, f1, e, r5 = out
    return y1, f1, (err_sum if err_stats is not None else e), r5


dopri5_step_fused.launches = 0


def _slabs(lib, dev, N, Z, nb, tf_rows, kind, layout):
    """(num_ctas, zeroed slabs (num_ctas + 1, size): the CTAs' and their
    sum, tile scratch) of a VJP launch; checks the kernel's slab layout
    against ``layout``."""
    size = sum(int(np.prod(s)) for _, s in layout)
    if lib.ananke_dopri5_slab_size(Z, nb, tf_rows) != size:
        raise RuntimeError("fused_dopri5: the kernel's gradient layout "
                           "differs from grad_layout's")
    num_ctas = min(VJP_CTAS, -(-N // lib.ananke_dopri5_tile_rows(nb, kind)))
    slabs = torch.zeros((num_ctas + 1, size), dtype=torch.float32,
                        device=dev)
    scratch = torch.empty(
        (num_ctas, lib.ananke_dopri5_scratch_floats(nb, kind)),
        dtype=torch.float32, device=dev)
    return num_ctas, slabs, scratch


def dopri5_step_vjp_fused(x, f0, h, ze, tf_rows, Wq, W1xc, W1h, blocks, W3,
                          b3, h_step, g_dy, g_r5, g_k1x, g_k7x, g_y0_direct,
                          precision="f32", packed=None):
    """The VJP of one accepted step. Arguments and result as
    :func:`dopri5_step_vjp_reference`; on CUDA the kernel K7 at
    ``precision``, ``packed`` as :func:`dopri5_step_fused` takes it (at the
    same precision). The summed gradients are deterministic: the same
    operands give the same bits."""
    shape = tuple(x.shape)
    rows = [("x", x, shape), ("f0", f0, shape),
            ("h", h, (x.shape[0], W1h.shape[0])), ("g_dy", g_dy, shape),
            ("g_r5", g_r5, shape), ("g_k1x", g_k1x, shape),
            ("g_k7x", g_k7x, shape), ("g_y0_direct", g_y0_direct, shape)]
    N, Da, Z, Dz, Dc, H = _check("dopri5_step_vjp_fused", rows, ze, tf_rows,
                                 Wq, W1xc, W1h, blocks, W3, b3)
    nb = len(blocks)
    if not _kernel_device("dopri5_step_vjp_fused", x, (Da, Dz, Dc, H), nb,
                          precision):
        return dopri5_step_vjp_reference(
            x, f0, h, ze, tf_rows, Wq, W1xc, W1h, blocks, W3, b3, h_step,
            g_dy, g_r5, g_k1x, g_k7x, g_y0_direct, precision)
    dev = x.device
    gy0 = torch.empty((N, Da), dtype=torch.float32, device=dev)
    gf0 = torch.empty_like(gy0)
    gh = torch.empty((N, Dc), dtype=torch.float32, device=dev)
    layout = grad_layout(Z, Dz, Da, Dc, H, nb, time_shape=(7, H))
    gsum = torch.zeros((sum(int(np.prod(s)) for _, s in layout),),
                       dtype=torch.float32, device=dev)
    if N > 0:
        lib = _lib()
        kind = _F32_VJP if precision == "f32" else _BF16_VJP
        num_ctas, slabs, scratch = _slabs(lib, dev, N, Z, nb, 7, kind,
                                          layout)
        ze_p, zeT, *w = _packed("dopri5_step_vjp_fused", packed, ze,
                                (Wq, W1xc, W1h, blocks, W3, b3), precision)
        ops = [x.contiguous(), f0.contiguous(), h.contiguous(), ze_p, zeT,
               tf_rows.contiguous(), *w,
               *(g.contiguous() for g in (g_dy, g_r5, g_k1x, g_k7x,
                                          g_y0_direct)),
               gy0, gf0, gh, scratch, slabs]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ananke_dopri5_step_vjp(
                *[t.data_ptr() for t in ops], N, Z, ze_p.shape[0], nb,
                num_ctas, int(kind == _BF16_VJP), F(h_step), Da, Dz, Dc, H,
                stream)
        _raise_on(lib, err, "dopri5_step_vjp_fused")
        dopri5_step_vjp_fused.launches += 1
        gsum = slabs[num_ctas]
    gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3 = split_grads(gsum, layout,
                                                                nb)
    return gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3


dopri5_step_vjp_fused.launches = 0


def dopri5_backward_fused(ckpts, ckpt_f, hc, ze, tf_all, rec_t0, rec_h,
                          n_acc, g, out_step, ts, Wq, W1xc, W1h, blocks, W3,
                          b3, precision="bf16", packed=None):
    """The whole discrete-adjoint backward. Arguments and result as
    :func:`dopri5_backward_reference`; on CUDA the kernel K6 at
    ``precision`` (one launch, then the sum of the CTAs' slabs), ``packed``
    as :func:`dopri5_step_fused` takes it (at the same precision). The
    checkpoints may be float32 or bf16; where the two buffers differ the
    bf16 one is widened first. The output rows a step did not fill are
    skipped in the kernel's fold (the plain version multiplies them by a
    zero weight: only a non-finite cotangent there tells the two apart).
    The summed gradients are deterministic: the same operands give the
    same bits."""
    max_acc, N, Da = ckpts.shape
    T = g.shape[0]
    Dc, H = W1h.shape[0], W1xc.shape[1]
    rows = [("g[0]", g[0], (N, Da)), ("hc", hc, (N, Dc)),
            ("g", g, (T, N, Da)), ("tf_all", tf_all, (max_acc, 7, H))]
    N, Da, Z, Dz, Dc, H = _check("dopri5_backward_fused", rows, ze,
                                 tf_all[0], Wq, W1xc, W1h, blocks, W3, b3)
    for key, t in (("ckpts", ckpts), ("ckpt_f", ckpt_f)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dopri5_backward_fused: {key} must be float32 "
                            f"or bfloat16, got {t.dtype}")
        if tuple(t.shape) != (max_acc, N, Da) or t.device != g.device:
            raise ValueError(f"dopri5_backward_fused: {key} must be "
                             f"({max_acc}, {N}, {Da}) on {g.device}")
    n_acc = int(n_acc)
    if not 0 <= n_acc <= max_acc or len(out_step) != T or len(ts) != T:
        raise ValueError("dopri5_backward_fused: n_acc must lie in [0, "
                         "max_acc] and out_step, ts hold one entry per row")
    nb = len(blocks)
    if not _kernel_device("dopri5_backward_fused", g, (Da, Dz, Dc, H), nb,
                          precision):
        return dopri5_backward_reference(
            ckpts, ckpt_f, hc, ze, tf_all, rec_t0, rec_h, n_acc, g, out_step,
            ts, Wq, W1xc, W1h, blocks, W3, b3, precision)
    dev = g.device
    if ckpts.dtype != ckpt_f.dtype:
        ckpts, ckpt_f = ckpts.float(), ckpt_f.float()
    gy0 = torch.zeros((N, Da), dtype=torch.float32, device=dev)
    gf0 = torch.zeros_like(gy0)
    gh = torch.zeros((N, Dc), dtype=torch.float32, device=dev)
    layout = grad_layout(Z, Dz, Da, Dc, H, nb, time_shape=(n_acc, 7, H))
    gsum = torch.zeros((sum(int(np.prod(s)) for _, s in layout),),
                       dtype=torch.float32, device=dev)
    if N > 0 and n_acc > 0:
        lib = _lib()
        kind = _F32_VJP if precision == "f32" else _BF16_VJP
        num_ctas, slabs, scratch = _slabs(lib, dev, N, Z, nb, 7 * n_acc,
                                          kind, layout)
        ze_p, zeT, *w = _packed("dopri5_backward_fused", packed, ze,
                                (Wq, W1xc, W1h, blocks, W3, b3), precision)
        steps = torch.from_numpy(np.concatenate([
            _host_f32(rec_t0)[:n_acc], _host_f32(rec_h)[:n_acc],
            _host_f32(ts)])).to(dev)
        ostep = torch.as_tensor(np.asarray(out_step), dtype=torch.int32,
                                device=dev)
        ops = [ckpts.contiguous(), ckpt_f.contiguous(), g.contiguous(),
               hc.contiguous(), ze_p, zeT, tf_all.contiguous(), steps,
               ostep, *w, gy0, gf0, gh, scratch, slabs]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ananke_dopri5_backward_all(
                *[t.data_ptr() for t in ops], N, Z, ze_p.shape[0], nb,
                num_ctas, n_acc, T, int(kind == _BF16_VJP),
                int(ckpts.dtype == torch.bfloat16), Da, Dz, Dc, H, stream)
        _raise_on(lib, err, "dopri5_backward_fused")
        dopri5_backward_fused.launches += 1
        gsum = slabs[num_ctas]
    gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3, gb3 = split_grads(gsum, layout,
                                                                nb)
    gtf_all = torch.zeros((max_acc, 7, H), dtype=torch.float32, device=dev)
    gtf_all[:n_acc] = gtf
    return gy0, gf0, gh, gze, gtf_all, gWq, gW1xc, gW1h, gblocks, gW3, gb3


dopri5_backward_fused.launches = 0

KERNELS = (dopri5_step_fused, dopri5_step_vjp_fused, dopri5_backward_fused)
# the plain versions in the same places: the same solve without the kernels
PLAIN = (dopri5_step_reference, dopri5_step_vjp_reference,
         dopri5_backward_reference)


def make_fused_dopri5_hooks(model, precision="f32", bwd_precision=None,
                            err_stats=None, _plain=False):
    """``(step_impl, step_vjp)`` for ``ode.odeint_discrete_adjoint`` over
    the GAT-ODE drift with ``args = (params, h, zone_emb)``, ``params`` the
    tuple of every model parameter in ``flax_leaf_params`` order.

    ``step_impl`` runs :func:`dopri5_step_fused` (the forward's attempted
    steps and the backward's replays); ``step_vjp`` runs
    :func:`dopri5_step_vjp_fused`, and ``step_vjp.backward_all`` (the
    whole backward, which ``odeint_discrete_adjoint`` takes at
    ``ckpt_every=1`` with the FSAL evals recorded) runs
    :func:`dopri5_backward_fused`. Both scatter the kernel's weight
    cotangents into a gradient for every parameter in the same order: the
    drift's from the kernel, Dense_0's time rows and bias by autograd of
    the time rows at their cotangent, exact zeros for the parameters the
    drift never reads. The weights are split from ``params``, and packed
    for the kernels (once per precision), once per solve: the forward's
    steps share one ``args`` tree, the backward's another.

    ``precision`` is the forward's (K5 takes either; the reference keeps a
    bf16 forward for loose tolerances, rtol >= ~1e-3, where its stage noise
    does not floor the controller); ``bwd_precision`` (default the same)
    the VJPs' (K7 and K6 take either). ``err_stats=(rtol, atol)``:
    the step returns an ``ErrNormSq`` reduced with those tolerances (pass
    the solve's own), and the controller reads one scalar per attempted
    step. ``_plain``: the hooks run the plain versions (:data:`PLAIN`) on
    any device, the check the kernels are held against.
    """
    step_fn, vjp_fn, bwd_fn = PLAIN if _plain else KERNELS
    bwd_precision = bwd_precision or precision
    _mk_cast(precision)
    _mk_cast(bwd_precision)
    leaves = flax_leaf_params(model)
    paths = [p for p, _ in leaves]
    split_drift_params(dict(leaves))  # raises early on a block-free drift
    n_dense = 2 + 2 * model.num_blocks
    # its args tree, the params' versions, (weights, (W1t, b1), packings)
    solve = [None, None, None]

    def operands(args, prec):
        """(drift weights, (W1t, b1), the wrappers' keywords at ``prec``)
        of the solve that ``args`` belongs to."""
        params, _, ze = args
        versions = tuple(p._version for p in params)
        if solve[0] is not args or solve[1] != versions:
            (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = split_drift_params(
                dict(zip(paths, (p.detach() for p in params))))
            solve[:] = [args, versions,
                        ((Wq, W1xc, W1h, blocks, W3, b3), (W1t, b1), {})]
        w, tw, packs = solve[2]
        if prec not in packs:
            packs[prec] = (
                {} if _plain or ze.device.type != "cuda" else
                {"packed": pack_operands(ze.detach(), *w, precision=prec)})
        return w, tw, packs[prec]

    def gradients(params, gWq, gW1xc, gW1h, gW1t, gb1, gblocks, gW3, gb3):
        """A gradient for every parameter, in ``paths``' order."""
        grads = {
            ("query_proj", "kernel"): gWq.T,
            ("drift", "Dense_0", "kernel"): torch.cat(
                [gW1xc, gW1h, gW1t]).T,
            ("drift", "Dense_0", "bias"): gb1,
            ("drift", f"Dense_{n_dense - 1}", "kernel"): gW3.T,
            ("drift", f"Dense_{n_dense - 1}", "bias"): gb3,
        }
        for i, (g1, gbr1, g2, gbr2) in enumerate(gblocks):
            grads[("drift", f"Dense_{1 + 2 * i}", "kernel")] = g1.T
            grads[("drift", f"Dense_{1 + 2 * i}", "bias")] = gbr1
            grads[("drift", f"Dense_{2 + 2 * i}", "kernel")] = g2.T
            grads[("drift", f"Dense_{2 + 2 * i}", "bias")] = gbr2
        return tuple(grads[p] if p in grads else torch.zeros_like(w)
                     for p, w in zip(paths, params))

    def time_rows(W1t, b1, table):
        """(W1t, b1) as leaves of autograd and the time rows from them."""
        with torch.enable_grad():
            W1t = W1t.clone().requires_grad_(True)
            b1 = b1.clone().requires_grad_(True)
            return W1t, b1, table(W1t, b1)

    def step_impl(t0, h_step, y, f, args):
        _, hc, ze = args
        wts, (W1t, b1), kw = operands(args, precision)
        tf_rows = stage_time_rows(t0, h_step, W1t, b1)
        y1, f1, err, r5 = step_fn(y, f, hc.detach(), ze.detach(), tf_rows,
                                  *wts, h_step, precision=precision,
                                  err_stats=err_stats, **kw)
        if err_stats is not None:
            err = ErrNormSq(sq_sum=err.reshape(()), count=y.numel())
        return y1, f1, err, _Interp(F(t0), F(h_step), y, f, y1, f1, r5)

    def step_vjp(t0, h_step, y, f, args, gset):
        params, hc, ze = args
        wts, (W1t, b1), kw = operands(args, bwd_precision)
        W1t, b1, tf_rows = time_rows(
            W1t, b1, lambda w, b: stage_time_rows(t0, h_step, w, b))
        (gy0, gf0, gh, gze, gtf, gWq, gW1xc, gW1h, gblocks, gW3,
         gb3) = vjp_fn(y, f, hc.detach(), ze.detach(), tf_rows.detach(),
                       *wts, h_step, *gset, precision=bwd_precision, **kw)
        gW1t, gb1 = torch.autograd.grad(tf_rows, (W1t, b1), gtf)
        return gy0, gf0, (gradients(params, gWq, gW1xc, gW1h, gW1t, gb1,
                                    gblocks, gW3, gb3), gh, gze)

    def backward_all(ckpts, ckpt_f, rec_t0, rec_h, n_acc, g, out_step, ts,
                     args):
        """The whole backward in one :func:`dopri5_backward_fused` launch
        in place of ``n_acc`` step VJPs; the stage time rows of every
        recorded step are formed once."""
        params, hc, ze = args
        wts, (W1t, b1), kw = operands(args, bwd_precision)
        W1t, b1, tf_all = time_rows(
            W1t, b1, lambda w, b: stage_time_table(rec_t0, rec_h, w, b))
        (gy0, gf0, gh, gze, gtf_all, gWq, gW1xc, gW1h, gblocks, gW3,
         gb3) = bwd_fn(ckpts, ckpt_f, hc.detach(), ze.detach(),
                       tf_all.detach(), rec_t0, rec_h, n_acc, g, out_step,
                       ts, *wts, precision=bwd_precision, **kw)
        gW1t, gb1 = torch.autograd.grad(tf_all, (W1t, b1), gtf_all)
        return gy0, gf0, (gradients(params, gWq, gW1xc, gW1h, gW1t, gb1,
                                    gblocks, gW3, gb3), gh, gze)

    step_vjp.backward_all = backward_all
    return step_impl, step_vjp


__all__ = [
    "kernels_fit", "stage_time_rows", "stage_time_table",
    "pack_weights_f32", "pack_operands", "dopri5_step_reference",
    "dopri5_step_fused", "dopri5_step_vjp_reference",
    "dopri5_step_vjp_fused", "dopri5_backward_reference",
    "dopri5_backward_fused", "make_fused_dopri5_hooks", "KERNELS", "PLAIN",
]
