"""The zone-graph encoder (``ZoneGAT``) as one forward kernel and one VJP
kernel.

Port of ``ananke_abm_tpu/ops/pallas/fused_gat.py``. Two kernels (CUDA C++
in ``csrc/fused_gat.cu``) replace the two Pallas kernels of that file,
each with its plain PyTorch version beside it:

- :func:`gat_forward_fused` (K4f, ``_gat_fwd_impl``) and
  :func:`gat_forward_reference`;
- :func:`gat_backward_fused` (K4b, ``_gat_bwd_impl``) and
  :func:`gat_backward_reference`.

Both compute ``_gat_math`` in float32 throughout: leaky-relu (slope 0.2)
edge scores, the adjacency mask at -1e30, a max-subtracted softmax per head
over the neighbours, elu and the residual, and LayerNorm with flax's
statistics (var = E[x^2] - E[x]^2, eps 1e-6 inside the rsqrt). A row with
no neighbour at all attends uniformly over every zone, as there.

Each wrapper takes its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises (widths it is not compiled for, a
refused launch); there is no fallback. ``.launches`` counts the wrapper's
calls that launched the kernel (K4f runs ``num_layers + 1`` grids a call,
K4b ``3 * num_layers + 1``). :func:`zone_gat_fused` is the differentiable
entry point. The TPU module's ``fits_vmem`` and ``probe_lowering`` have no
counterpart: the first is a VMEM budget, and the second demotes to the flax
encoder when a lowering fails, where the port raises.
"""
from __future__ import annotations

import torch

from ananke_abm_tpu_torch.ops.cuda.fused_train import _raise_on

NEG = -1e30
LN_EPS = 1e-6
# the widths the CUDA kernels are compiled for
KERNEL_FEATURES = 64
KERNEL_HEADS = 4
MAX_KERNEL_LAYERS = 4
MAX_KERNEL_IN_FEATURES = 64
MAX_KERNEL_ZONES = 16_384


def flatten_gat_params(zone_gat) -> tuple:
    """A ``ZoneGAT`` module's parameters as the flat tuple of the TPU
    module's ``flatten_gat_params``: ``Win (F, D)``, ``bin (D,)``, then per
    layer ``W (D, D)``, the per-head ``a_src[h]`` rows (1, d), the per-head
    ``a_dst[h]`` rows (1, d), ``scale (D,)`` and ``bias (D,)``. The entries
    are views of the module's own parameters (kernels transposed to (in,
    out)), so gradients flow back into the module."""
    flat = [zone_gat.inp.weight.T, zone_gat.inp.bias]
    for layer, norm in zip(zone_gat.layers, zone_gat.norms):
        flat.append(layer.proj.weight.T)
        flat += [layer.a_src[h:h + 1] for h in range(layer.heads)]
        flat += [layer.a_dst[h:h + 1] for h in range(layer.heads)]
        flat += [norm.weight, norm.bias]
    return tuple(flat)


def _mm(a, b):
    """The plain version's float32 matrix product (the TF32 control of the
    kernel checks replaces it)."""
    return a @ b


def _kink_side(s):
    """Which scores take the leaky-relu's slope 1 (``s >= 0``). Its gradient
    is undefined at 0, and two float32 versions may round a score near 0 to
    either side; the kernel checks replace this with the kernel's own sides
    (``checks.on_kernel_sides``)."""
    return s >= 0


def gat_forward_reference(zf, adj, flat, heads, num_layers):
    """Plain PyTorch version of the encoder forward, op for op as
    ``_gat_math``.

    zf: (Z, F) float32 zone features; adj: (Z, Z) float32 {0, 1}; flat: from
    :func:`flatten_gat_params`. Returns ``(out (Z, D), None)``: this version
    keeps no residuals (its backward recomputes the forward, as the Pallas
    backward re-traces ``_gat_math``).
    """
    win, bin_ = flat[0], flat[1]
    h = _mm(zf, win) + bin_[None, :]
    d = win.shape[1] // heads
    per_layer = 3 + 2 * heads
    off = ~(adj > 0)
    for i in range(num_layers):
        lf = flat[2 + per_layer * i: 2 + per_layer * (i + 1)]
        W = lf[0]
        a_src, a_dst = lf[1: 1 + heads], lf[1 + heads: 1 + 2 * heads]
        sc, bi = lf[1 + 2 * heads], lf[2 + 2 * heads]
        Wh = _mm(h, W)
        outs = []
        for hd in range(heads):
            whd = Wh[:, hd * d:(hd + 1) * d]
            es = torch.sum(whd * a_src[hd], dim=1, keepdim=True)
            ed = torch.sum(whd * a_dst[hd], dim=1, keepdim=True)
            s = es + ed.T  # s[i, j] = e_src[i] + e_dst[j]
            s = torch.where(_kink_side(s), s, 0.2 * s)
            s = s.masked_fill(off, NEG)
            s = s - torch.max(s, dim=1, keepdim=True).values
            e = torch.exp(s)
            alpha = e / torch.sum(e, dim=1, keepdim=True)
            outs.append(_mm(alpha, whd))
        g = torch.cat(outs, dim=-1)
        g = torch.where(g > 0, g, torch.exp(torch.clamp(g, max=0.0)) - 1.0)
        h = h + g
        mu = torch.mean(h, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(h * h, dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
        h = (h - mu) * torch.rsqrt(var + LN_EPS) * sc[None, :] + bi[None, :]
    return h, None


def gat_backward_reference(zf, adj, flat, g, heads, num_layers, res=None):
    """Plain PyTorch version of the encoder's VJP with respect to ``flat``
    at the output's cotangent ``g`` (Z, D): autograd through
    :func:`gat_forward_reference`. ``res`` is unused. Returns the gradients
    in the shapes of ``flat``."""
    del res
    with torch.enable_grad():
        leaves = [w.detach().requires_grad_() for w in flat]
        out, _ = gat_forward_reference(zf, adj, leaves, heads, num_layers)
        return torch.autograd.grad(out, leaves, g)


def _check(name, zf, adj, flat, heads, num_layers, g=None):
    """Validate the operands; returns (Z, F, D)."""
    Z, F = zf.shape
    D = flat[0].shape[1]
    if D % heads:
        raise ValueError(f"{name}: {D} features do not split into {heads} "
                         "heads")
    d = D // heads
    shapes = [(F, D), (D,)]
    for _ in range(num_layers):
        shapes += [(D, D)] + [(1, d)] * (2 * heads) + [(D,), (D,)]
    if len(flat) != len(shapes):
        raise ValueError(f"{name}: {len(flat)} parameters, expected "
                         f"{len(shapes)} for {num_layers} layers of {heads} "
                         "heads")
    want = [("zf", zf, (Z, F)), ("adj", adj, (Z, Z))]
    want += [(f"flat[{i}]", w, s) for i, (w, s) in enumerate(zip(flat,
                                                                 shapes))]
    if g is not None:
        want.append(("g", g, (Z, D)))
    for key, t, shape in want:
        if t.device != zf.device:
            raise ValueError(f"{name}: {key} is on {t.device}, zf on "
                             f"{zf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    return Z, F, D


def kernels_fit(z, f, d, heads, num_layers) -> bool:
    """Whether the encoder kernels (K4f / K4b) take ``z`` zones of ``f``
    features, ``d`` output features in ``heads`` heads and ``num_layers``
    layers: the rule their wrappers enforce on CUDA tensors, for callers to
    choose a route before anything launches."""
    return (d == KERNEL_FEATURES and heads == KERNEL_HEADS
            and 1 <= num_layers <= MAX_KERNEL_LAYERS
            and 1 <= f <= MAX_KERNEL_IN_FEATURES
            and 1 <= z <= MAX_KERNEL_ZONES)


def _kernel_device(name, zf, Z, F, D, heads, num_layers):
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    if zf.device.type == "cpu":
        return False
    if zf.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {zf.device}")
    if not kernels_fit(Z, F, D, heads, num_layers):
        raise ValueError(
            f"{name}: the CUDA kernel is compiled for {KERNEL_FEATURES} "
            f"features in {KERNEL_HEADS} heads, 1-{MAX_KERNEL_LAYERS} layers, "
            f"1-{MAX_KERNEL_IN_FEATURES} zone features and "
            f"1-{MAX_KERNEL_ZONES} zones; got {D} features, {heads} heads, "
            f"{num_layers} layers, {F} zone features, {Z} zones")
    return True


def _lib():
    from ananke_abm_tpu_torch.ops.cuda._build import load_library

    return load_library("fused_gat")


def gat_forward_fused(zf, adj, flat, heads, num_layers):
    """The encoder forward. Arguments as :func:`gat_forward_reference`; on
    CUDA the kernel K4f. Returns ``(out (Z, D), residuals)``: on CUDA the
    packed parameters and the forward's saved activations, which
    :func:`gat_backward_fused` reads; on the CPU ``None``."""
    Z, F, D = _check("gat_forward_fused", zf, adj, flat, heads, num_layers)
    if not _kernel_device("gat_forward_fused", zf, Z, F, D, heads,
                          num_layers):
        return gat_forward_reference(zf, adj, flat, heads, num_layers)
    lib = _lib()
    prm = torch.cat([w.reshape(-1) for w in flat])
    if lib.ananke_gat_param_size(F, num_layers) != prm.numel():
        raise RuntimeError("gat_forward_fused: the kernel's parameter "
                           "layout differs from flatten_gat_params'")
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=zf.device)
    L = num_layers
    res = (prm, empty(L + 1, Z, D), empty(L, Z, D), empty(4, L, Z, heads),
           empty(2, L, Z, D), empty(L, Z))
    ops = [zf.contiguous(), adj.contiguous(), *res]
    stream = torch.cuda.current_stream(zf.device).cuda_stream
    with torch.cuda.device(zf.device):
        err = lib.ananke_gat_forward(*[t.data_ptr() for t in ops], Z, F, L,
                                     D, heads, stream)
    _raise_on(lib, err, "gat_forward_fused")
    gat_forward_fused.launches += 1
    return res[1][L], res


gat_forward_fused.launches = 0


def gat_backward_fused(zf, adj, flat, g, heads, num_layers, res):
    """The encoder's VJP with respect to ``flat``. Arguments and result as
    :func:`gat_backward_reference`; on CUDA the kernel K4b, which reads the
    residuals :func:`gat_forward_fused` returned (``res``). The gradients
    are summed over the zones without atomics: the same operands give the
    same bits."""
    Z, F, D = _check("gat_backward_fused", zf, adj, flat, heads, num_layers,
                     g)
    if not _kernel_device("gat_backward_fused", zf, Z, F, D, heads,
                          num_layers):
        return gat_backward_reference(zf, adj, flat, g, heads, num_layers)
    if res is None:
        raise ValueError("gat_backward_fused: needs the residuals of "
                         "gat_forward_fused on the card")
    lib = _lib()
    L, dev = num_layers, zf.device
    size = lib.ananke_gat_param_size(F, L)
    tiles = -(-Z // lib.ananke_gat_bwd_tile_rows())
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    gsum = empty(size)
    ops = [zf.contiguous(), adj.contiguous(), *res, g.contiguous(),
           empty(L, Z, D), empty(3, Z, D), empty(3, Z, heads),
           empty(tiles, size), gsum]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ananke_gat_backward(*[t.data_ptr() for t in ops], Z, F, L,
                                      tiles, D, heads, stream)
    _raise_on(lib, err, "gat_backward_fused")
    gat_backward_fused.launches += 1
    sizes = [w.numel() for w in flat]
    return tuple(part.view(w.shape)
                 for part, w in zip(torch.split(gsum, sizes), flat))


gat_backward_fused.launches = 0


KERNELS = (gat_forward_fused, gat_backward_fused)
# the plain versions in the same places: a run of the same step without the
# kernels, to hold the kernels' step against
PLAIN = (gat_forward_reference, gat_backward_reference)


class _GatCore(torch.autograd.Function):
    """The encoder's output; backward: the parameters' gradients and zero
    cotangents for the zone features and the adjacency (data, as
    ``_gat_core_bwd``)."""

    @staticmethod
    def forward(ctx, impl, heads, num_layers, zf, adj, *flat):
        out, res = impl[0](zf, adj, flat, heads, num_layers)
        ctx.impl, ctx.heads, ctx.num_layers, ctx.res = (impl, heads,
                                                        num_layers, res)
        ctx.save_for_backward(zf, adj, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        zf, adj, *flat = ctx.saved_tensors
        gflat = ctx.impl[1](zf, adj, tuple(flat), g.contiguous(), ctx.heads,
                            ctx.num_layers, ctx.res)
        zero = lambda t, i: (torch.zeros_like(t) if ctx.needs_input_grad[i]
                             else None)
        return (None, None, None, zero(zf, 3), zero(adj, 4), *gflat)


def zone_gat_fused(zone_feats, adj, zone_gat, *, heads, num_layers,
                   _impl=None):
    """The ``ZoneGAT`` module's forward through the encoder kernels,
    differentiable with respect to the module's parameters; ``zone_feats``
    (Z, F) and ``adj`` (Z, Z) are data (zero cotangents). On CUDA it
    launches K4f / K4b or raises. ``_impl``: (forward, backward) pair,
    default the kernel wrappers (:data:`KERNELS`)."""
    if (heads, num_layers) != (zone_gat.heads, zone_gat.num_layers):
        raise ValueError(f"zone_gat_fused: heads={heads}, num_layers="
                         f"{num_layers} do not match the module")
    flat = flatten_gat_params(zone_gat)
    return _GatCore.apply(_impl or KERNELS, heads, num_layers,
                          zone_feats.float().contiguous(),
                          adj.float().contiguous(), *flat)


__all__ = [
    "flatten_gat_params", "kernels_fit",
    "gat_forward_reference", "gat_forward_fused",
    "gat_backward_reference", "gat_backward_fused",
    "zone_gat_fused", "KERNELS", "PLAIN",
]
