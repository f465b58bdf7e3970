"""The GAT-ODE serving rollout's kernels: one output interval (``substeps``
RK4 steps of the drift, then the decode and its argmax), and one RK4 step.

Port of ``ananke_abm_tpu/ops/pallas/fused_step.py``. Two kernels (CUDA C++
in ``csrc/fused_step.cu``, one template) replace the Pallas kernels of that
file, each with its plain PyTorch version beside it, which the wrapper takes
for tensors on the CPU and the tests compare against:

- :func:`rk4_interval_decode_fused` (K1, ``rk4_interval_decode_fused``) and
  :func:`rk4_interval_decode_reference`;
- :func:`rk4_step_fused` (K0, ``rk4_step_fused``) and
  :func:`rk4_step_reference`: one step, no decode; the per-step rollout
  (``rollout.make_pallas_rollout(fuse_decode=False)``) decodes with
  :func:`decode_ids_bf16` after each interval.

Every rounding point of the reference stage math is kept: activations are
rounded to bf16 before each matmul, products accumulate in float32, the
softmax is max-free with the exp clamped at 80 and normalised after the
context product, and the RK4 state stays float32. In PyTorch ``a16 @ b16``
returns bf16, which would round away the float32 accumulation, so the
plain version multiplies the bf16-rounded operands as float32
(:func:`_dot`); that is exact for bf16 x bf16 -> f32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ananke_abm_tpu_torch.utils.profiling import check_nan

BF16 = torch.bfloat16
# (agent_dim, zone_dim, context_dim, hidden_dim) the CUDA kernel is
# compiled for: the shipping GATODEConfig widths. Must match the template
# instantiation in csrc/fused_step.cu.
KERNEL_WIDTHS = ((32, 64, 32, 128),)
# residual blocks the kernel takes (kMaxBlocks in csrc/fused_step.cu)
MAX_KERNEL_BLOCKS = 8


def stage_kernels_fit(da, dz, dc, hidden, num_blocks) -> bool:
    """Whether the kernels compiled for this width set (K1, K0, K8, K2f /
    K2b, K5, K7) take these (agent, zone, context, hidden) widths and
    residual blocks: the rule their wrappers enforce on CUDA tensors, for
    callers to choose a route before anything launches."""
    return ((da, dz, dc, hidden) in KERNEL_WIDTHS
            and 1 <= num_blocks <= MAX_KERNEL_BLOCKS)


def pack_weights_bf16(model):
    """GATODE -> bf16 weight tuple for the interval kernel, in the JAX
    package's layout (every matrix (in, out)).

    Dense_0's kernel is split by the drift's concat order
    [x, ctx, h, sin_t, cos_t]: the x/ctx rows go into the per-stage
    matmul, the h rows into a once-per-interval precompute (h is constant
    across RK4 stages) and the 2 time-feature rows into a per-stage table
    (:func:`time_feature_table`).

    Returns (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3), ``blocks`` a tuple
    of (Wr1, br1, Wr2, br2) per residual block. Reads the module's
    current parameters.
    """
    dense = model.drift.dense
    n_dense = len(dense)
    num_blocks = (n_dense - 2) // 2
    if num_blocks < 1:
        raise ValueError(
            "the fused interval kernel requires num_blocks >= 1 residual "
            f"drift blocks (got a drift with {n_dense} Dense layers => "
            f"num_blocks={num_blocks}); use the float32 path for "
            "block-free drifts"
        )
    to = lambda t: t.detach().to(BF16)
    Wq = model.query_proj.weight.T
    Da, Dz = Wq.shape
    W1 = dense[0].weight.T  # (in, out)
    Hc = W1.shape[0] - Da - Dz - 2
    blocks = tuple(
        (to(dense[1 + 2 * i].weight.T), to(dense[1 + 2 * i].bias),
         to(dense[2 + 2 * i].weight.T), to(dense[2 + 2 * i].bias))
        for i in range(num_blocks)
    )
    return (
        to(Wq),
        to(W1[: Da + Dz]),               # x/ctx rows: per-stage matmul
        to(W1[Da + Dz: Da + Dz + Hc]),   # h rows: per-interval precompute
        to(W1[Da + Dz + Hc:]),           # sin/cos rows: per-stage table
        to(dense[0].bias),
        blocks,
        to(dense[-1].weight.T), to(dense[-1].bias),
    )


def interval_stage_times(t0, dt_sub, substeps: int) -> np.ndarray:
    """(substeps * 4,) float32 RK4 stage times of one output interval, in
    the reference's float32 arithmetic."""
    f32 = np.float32
    t0, dt_sub = f32(t0), f32(dt_sub)
    sub_starts = t0 + dt_sub * np.arange(substeps, dtype=f32)
    offs = np.asarray([0.0, 0.5, 0.5, 1.0], f32) * dt_sub
    return (sub_starts[:, None] + offs[None, :]).reshape(-1).astype(f32)


def time_feature_table(stage_t, W1t_bf16, b1_bf16):
    """(S,) float32 stage times -> (S, H) float32 additive pre-activations:
    the sin/cos rows of Dense_0 plus its bias, evaluated per stage."""
    ang = stage_t * (2 * np.pi / 24.0)
    tfeat = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return tfeat.float() @ W1t_bf16.float() + b1_bf16.float()[None, :]


def _dot(a16, b16):
    """bf16 x bf16 -> float32, exactly: the operands are bf16 values, the
    product and sums are float32."""
    return a16.float() @ b16.float()


def _nt_dot(a16, b16):
    """(N, I), (N, O) bf16 -> (I, O) float32: contract the agent axis
    (the weight gradients)."""
    return a16.float().T @ b16.float()


def _to16(a):
    return a.to(BF16)


def keep(a):
    """The identity cast: nothing is narrowed (the DOPRI5 step kernels'
    float32 stage math)."""
    return a


def stage_math(xb, hpre, tfp_row, ze, scale, wq, w1xc, blocks, w3, b3,
               cast=_to16):
    """One drift-RHS evaluation: the one copy of the stage math, shared by
    the plain versions of every stage kernel.

    xb: (N, Da) stage input, already cast; hpre: (N, H) float32 h-row
    pre-activation; tfp_row: (1, H) float32 time-row pre-activation;
    ze: (Z, Dz), already cast. ``cast`` narrows each activation before its
    product and the stored intermediates: bf16 by default (the serving and
    fixed-step kernels' rounding points), :func:`keep` for the DOPRI5 step
    kernels, which stay float32 throughout. Returns (k (N, Da) float32,
    intermediates): the intermediates are ``(q, attn, ((z_in, rt, z_out)
    per block), feats)``, each cast, for :func:`stage_vjp_math`.
    """
    q = _dot(xb, wq)
    q16 = cast(q)
    scores = _dot(q16, ze.T) * scale
    # max-free softmax: the max subtraction cancels in the ratio; the
    # clamp guards float32 overflow for scores > 80
    p_att = torch.exp(torch.clamp_max(scores, 80.0))
    inv = 1.0 / torch.sum(p_att, dim=-1, keepdim=True)
    # normalised AFTER the context product, as the reference kernel does
    ctx = _dot(cast(p_att), ze) * inv
    attn16 = cast(p_att * inv)
    feats = torch.cat([xb, cast(ctx)], dim=-1)
    z = torch.tanh(_dot(feats, w1xc) + hpre + tfp_row)
    block_inter = []
    for (wr1, br1, wr2, br2) in blocks:
        z_in16 = cast(z)
        rt = torch.tanh(_dot(z_in16, wr1) + br1.float())
        rt16 = cast(rt)
        r3 = _dot(rt16, wr2) + br2.float()
        z = torch.tanh(z + r3)
        block_inter.append((z_in16, rt16, cast(z)))
    k = _dot(cast(z), w3) + b3.float()
    return k, (q16, attn16, tuple(block_inter), feats)


def stage_vjp_math(gk, inter, acc, tw, scale, Da, cast=_to16):
    """The VJP of one :func:`stage_math` evaluation at cotangent ``gk``
    (N, Da) float32, with the rounding points of the reference's
    ``_stage_vjp_math``: cotangents are cast (bf16 by default, as the
    forward) before each product, ``tanh'`` is recomputed from the cast
    activation, bias and time-row gradients are float32 sums.

    inter: from :func:`stage_math`. acc: float32 accumulators
    ``(gze, gwq, gw1, ghp, blocks, gw3, gb3)`` (``blocks``: per block
    ``(gwr1, gbr1, gwr2, gbr2)``; ``ghp`` (N, H), the rest summed over
    agents). tw: bf16 ``(ze, ze.T, wq.T, w1xc.T, ((wr1.T, wr2.T) per
    block), w3.T)``. Returns ``(gx, gtf (1, H), acc')``.
    """
    (ze16, zeT, wqT, w1xcT, blkT, w3T) = tw
    (q16, attn16, block_inter, feats) = inter
    (gzeA, gwqA, gw1A, ghpA, blkA, gw3A, gb3A) = acc
    gk16 = cast(gk)
    # k = z_out @ W3 + b3
    gw3A = gw3A + _nt_dot(block_inter[-1][2], gk16)
    gb3A = gb3A + torch.sum(gk, dim=0, keepdim=True)
    gz = _dot(gk16, w3T)
    # residual blocks, reversed: z_out = tanh(z_in + rt @ Wr2 + br2)
    blkA = list(blkA)
    for b in range(len(blkT) - 1, -1, -1):
        z_in16, rt16, zo16 = block_inter[b]
        (gwr1A, gbr1A, gwr2A, gbr2A) = blkA[b]
        wr1T, wr2T = blkT[b]
        zo = zo16.float()
        gpre = gz * (1.0 - zo * zo)
        gp16 = cast(gpre)
        gwr2A = gwr2A + _nt_dot(rt16, gp16)
        gbr2A = gbr2A + torch.sum(gpre, dim=0, keepdim=True)
        grt = _dot(gp16, wr2T)
        rt = rt16.float()
        gpre2 = grt * (1.0 - rt * rt)
        gp216 = cast(gpre2)
        gwr1A = gwr1A + _nt_dot(z_in16, gp216)
        gbr1A = gbr1A + torch.sum(gpre2, dim=0, keepdim=True)
        gz = gpre + _dot(gp216, wr1T)
        blkA[b] = (gwr1A, gbr1A, gwr2A, gbr2A)
    # z1 = tanh(feats @ W1xc + hpre + tfp_row), the first block's input
    z1 = block_inter[0][0].float()
    gpre1 = gz * (1.0 - z1 * z1)
    gp116 = cast(gpre1)
    gw1A = gw1A + _nt_dot(feats, gp116)
    ghpA = ghpA + gpre1
    gtf = torch.sum(gpre1, dim=0, keepdim=True)
    gfeats = _dot(gp116, w1xcT)
    gxb = gfeats[:, :Da]
    gctx16 = cast(gfeats[:, Da:])
    # ctx = attn @ ze
    gzeA = gzeA + _nt_dot(attn16, gctx16)
    gattn = _dot(gctx16, zeT)
    # softmax VJP (the max-free form has the same Jacobian)
    attn = attn16.float()
    ds = attn * (gattn - torch.sum(attn * gattn, dim=-1, keepdim=True)) \
        * scale
    ds16 = cast(ds)
    # scores = (q @ ze.T) * scale
    gq = _dot(ds16, ze16)
    gzeA = gzeA + _nt_dot(ds16, q16)
    # q = xb @ Wq
    gq16 = cast(gq)
    gwqA = gwqA + _nt_dot(feats[:, :Da], gq16)
    gx = gxb + _dot(gq16, wqT)
    return gx, gtf, (gzeA, gwqA, gw1A, ghpA, tuple(blkA), gw3A, gb3A)


def decode_ids_bf16(x, wd_bf16, ze_bf16):
    """The interval kernel's decode: ids = argmax(bf16(bf16(x) @ Wd) @
    ze^T), float32 sums, the FIRST index of the largest logit."""
    logits = _dot(_dot(x.to(BF16), wd_bf16).to(BF16), ze_bf16.T)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _rk4_coefs(dt_sub):
    """(dt, dt/2, dt/6) as float32 values, computed in float32."""
    f32 = np.float32
    step = f32(dt_sub)
    return float(step), float(step * f32(0.5)), float(step / f32(6.0))


def _rk4_substeps(x, h, ze_bf16, weights_bf16, tf_pre, dt_sub):
    """``tf_pre.shape[0] // 4`` RK4 substeps of the bf16 stage math from
    float32 ``x``: the integration both plain versions share."""
    (Wq, W1xc, W1h, _W1t, _b1, blocks, W3, b3) = weights_bf16
    scale = float(np.float32(1.0 / np.sqrt(float(ze_bf16.shape[1]))))
    step, half, sixth = _rk4_coefs(dt_sub)
    # h is constant across the interval: one Dense_0 h-row product
    h_pre = _dot(h.to(BF16), W1h)

    def rhs(xc, stage):
        k, _ = stage_math(xc.to(BF16), h_pre, tf_pre[stage][None, :],
                          ze_bf16, scale, Wq, W1xc, blocks, W3, b3)
        return k

    xs = x
    for s in range(tf_pre.shape[0] // 4):
        k1 = rhs(xs, 4 * s + 0)
        k2 = rhs(xs + half * k1, 4 * s + 1)
        k3 = rhs(xs + half * k2, 4 * s + 2)
        k4 = rhs(xs + step * k3, 4 * s + 3)
        xs = xs + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return xs


def rk4_interval_decode_reference(x, h, ze_bf16, weights_bf16, wd_bf16,
                                  tf_pre, dt_sub):
    """Plain PyTorch version of the interval kernel.

    x: (N, Da) float32; h: (N, Dc) float32; ze_bf16: (Z, Dz) bf16;
    weights_bf16: tuple from :func:`pack_weights_bf16`; wd_bf16: (Da, Dz)
    bf16 decode projection; tf_pre: (substeps * 4, H) float32 from
    :func:`time_feature_table`; dt_sub: the substep size. Returns
    (x_new (N, Da) float32, ids (N,) int32), ids the FIRST index of the
    largest logit.
    """
    xs = _rk4_substeps(x, h, ze_bf16, weights_bf16, tf_pre, dt_sub)
    return xs, decode_ids_bf16(xs, wd_bf16, ze_bf16)


def rk4_step_reference(x, h, ze_bf16, weights_bf16, tf_pre, dt):
    """Plain PyTorch version of the step kernel: one RK4 step ``x0 +
    (dt/6)(k1 + 2 k2 + 2 k3 + k4)``, the stage inputs ``x0 + (dt/2) k`` and
    ``x0 + dt k3``, every product in the bf16 stage math.

    Operands as :func:`rk4_interval_decode_reference`, without the decode
    projection; tf_pre: (4, H) float32, the step's stage rows at ``[t0, t0
    + dt/2, t0 + dt/2, t0 + dt]`` (:func:`interval_stage_times` with one
    substep). Returns x_new (N, Da) float32.
    """
    return _rk4_substeps(x, h, ze_bf16, weights_bf16, tf_pre, dt)


def _check(x, h, ze, weights, wd, tf_pre):
    """Validate the interval's operands (the step's: ``wd`` None, 4 stage
    rows); returns (N, Da, Z, Dz, Dc, H)."""
    (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = weights
    if x.ndim != 2 or h.ndim != 2 or ze.ndim != 2 or tf_pre.ndim != 2:
        raise ValueError("x, h, ze and tf_pre must be 2-D")
    N, Da = x.shape
    Z, Dz = ze.shape
    Dc = h.shape[1]
    H = W1xc.shape[1]
    S = tf_pre.shape[0]
    if len(blocks) < 1:
        raise ValueError("the interval kernel needs >= 1 residual block")
    want = {
        "x": (x, torch.float32, (N, Da)),
        "h": (h, torch.float32, (N, Dc)),
        "ze": (ze, BF16, (Z, Dz)),
        "tf_pre": (tf_pre, torch.float32, (S, H)),
        "Wq": (Wq, BF16, (Da, Dz)),
        "W1xc": (W1xc, BF16, (Da + Dz, H)),
        "W1h": (W1h, BF16, (Dc, H)),
        "W1t": (W1t, BF16, (2, H)),
        "b1": (b1, BF16, (H,)),
        "W3": (W3, BF16, (H, Da)),
        "b3": (b3, BF16, (Da,)),
    }
    if wd is not None:
        want["wd"] = (wd, BF16, (Da, Dz))
    for i, (wr1, br1, wr2, br2) in enumerate(blocks):
        want[f"Wr1[{i}]"] = (wr1, BF16, (H, H))
        want[f"br1[{i}]"] = (br1, BF16, (H,))
        want[f"Wr2[{i}]"] = (wr2, BF16, (H, H))
        want[f"br2[{i}]"] = (br2, BF16, (H,))
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
    for name in ("x", "h", "ze", "tf_pre"):
        if not want[name][0].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S < 4 or S % 4 or (wd is None and S != 4):
        want_rows = "4" if wd is None else "substeps * 4"
        raise ValueError(f"tf_pre must have {want_rows} rows, got {S}")
    if Z < 1:
        raise ValueError("ze must hold at least one zone")
    return N, Da, Z, Dz, Dc, H


def _kernel_device(name, x, widths, blocks):
    """True for a CUDA tensor the kernels take, False for a CPU tensor;
    raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if widths not in KERNEL_WIDTHS:
        raise ValueError(
            f"{name}: the CUDA kernel is compiled for (agent, zone, "
            f"context, hidden) widths {KERNEL_WIDTHS}, got {widths}")
    if len(blocks) > MAX_KERNEL_BLOCKS:
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{MAX_KERNEL_BLOCKS} residual blocks")
    return True


def rk4_interval_decode_fused(x, h, ze_bf16, weights_bf16, wd_bf16, tf_pre,
                              dt_sub):
    """One output interval: ``tf_pre.shape[0] // 4`` RK4 substeps, then the
    decode and first-index argmax. Arguments and result as
    :func:`rk4_interval_decode_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``csrc/fused_step.cu``, or raise (unsupported widths, too many blocks,
    a refused launch); there is no fallback. ``.launches`` counts the
    kernel launches.
    """
    N, Da, Z, Dz, Dc, H = _check(x, h, ze_bf16, weights_bf16, wd_bf16,
                                 tf_pre)
    if not _kernel_device("rk4_interval_decode_fused", x, (Da, Dz, Dc, H),
                          weights_bf16[5]):
        return rk4_interval_decode_reference(
            x, h, ze_bf16, weights_bf16, wd_bf16, tf_pre, dt_sub
        )
    x_new = torch.empty_like(x)
    ids = torch.empty((N,), dtype=torch.int32, device=x.device)
    if N == 0:
        return x_new, ids
    lib, ops, sizes = _operands(x, h, ze_bf16, weights_bf16, tf_pre, x_new)
    ops[11:11] = [wd_bf16.T.contiguous()]
    step, _, _ = _rk4_coefs(dt_sub)
    with torch.cuda.device(x.device):
        err = lib.ananke_rk4_interval_decode(
            *[t.data_ptr() for t in ops], ids.data_ptr(), *sizes,
            tf_pre.shape[0], ctypes.c_float(step), Da, Dz, Dc, H,
            _stream(x))
    _raise_on(lib, err, "rk4_interval_decode_fused")
    rk4_interval_decode_fused.launches += 1
    check_nan("rk4_interval_decode_fused", x_new)
    return x_new, ids


rk4_interval_decode_fused.launches = 0


def rk4_step_fused(x, h, ze_bf16, weights_bf16, tf_pre, dt):
    """One RK4 step, no decode. Arguments and result as
    :func:`rk4_step_reference`.

    CPU tensors take the plain version. CUDA tensors launch the step kernel
    of ``csrc/fused_step.cu`` (the interval kernel's stage code with the
    decode compiled out), or raise (unsupported widths, too many blocks, a
    refused launch); there is no fallback. ``.launches`` counts the kernel
    launches.
    """
    N, Da, Z, Dz, Dc, H = _check(x, h, ze_bf16, weights_bf16, None, tf_pre)
    if not _kernel_device("rk4_step_fused", x, (Da, Dz, Dc, H),
                          weights_bf16[5]):
        return rk4_step_reference(x, h, ze_bf16, weights_bf16, tf_pre, dt)
    x_new = torch.empty_like(x)
    if N == 0:
        return x_new
    lib, ops, sizes = _operands(x, h, ze_bf16, weights_bf16, tf_pre, x_new)
    step, _, _ = _rk4_coefs(dt)
    with torch.cuda.device(x.device):
        err = lib.ananke_rk4_step(*[t.data_ptr() for t in ops], *sizes,
                                  ctypes.c_float(step), Da, Dz, Dc, H,
                                  _stream(x))
    _raise_on(lib, err, "rk4_step_fused")
    rk4_step_fused.launches += 1
    check_nan("rk4_step_fused", x_new)
    return x_new


rk4_step_fused.launches = 0


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.ananke_cuda_error_string(err) or b"unknown"
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg.decode()})")


def _operands(x, h, ze, weights, tf_pre, x_new):
    """(the library, the 13 operand tensors of the kernels' C interface but
    the decode's, in its order, (N, Z, zp, blocks)). The kernels read
    weights as (out, in) rows, each output's inputs contiguous: the
    K-major boxes their products take; zones are padded to a multiple of 16
    with zero rows (masked in the kernels)."""
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    lib = load_library("fused_step")
    (Wq, W1xc, W1h, _W1t, _b1, blocks, W3, b3) = weights
    Z, Dz = ze.shape
    zp = -(-Z // 16) * 16
    ze_p = torch.zeros((zp, Dz), dtype=BF16, device=x.device)
    ze_p[:Z] = ze
    wrT = torch.stack(
        [w.T for blk in blocks for w in (blk[0], blk[2])]
    ).contiguous()
    br = torch.stack([b for blk in blocks for b in (blk[1], blk[3])])
    ops = [x, h, ze_p, ze_p.T.contiguous(), Wq.T.contiguous(),
           W1xc.T.contiguous(), W1h.T.contiguous(), wrT, br.contiguous(),
           W3.T.contiguous(), b3.contiguous(), tf_pre, x_new]
    return lib, ops, (x.shape[0], Z, zp, len(blocks))


__all__ = [
    "pack_weights_bf16", "interval_stage_times", "time_feature_table",
    "keep", "stage_kernels_fit", "stage_math",
    "stage_vjp_math", "decode_ids_bf16", "rk4_interval_decode_reference",
    "rk4_interval_decode_fused", "rk4_step_reference", "rk4_step_fused",
]
