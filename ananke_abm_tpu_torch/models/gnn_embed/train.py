"""GAT-ODE configuration, construction, initialisation, serving, the
fixed-step trainers (plain autograd, and fused through the zone-encoder and
training-day kernels), the continuous- and discrete-adjoint trainers, the
epoch function and ``train()`` (port of
``ananke_abm_tpu/models/gnn_embed/train.py``).

A zone graph is dense, ``static = (zone_feats, adj, times)``, or a sparse
edge list, ``static = (zone_feats, adj_or_None, times, edge_index)`` with
an optional fifth element (the reference's ``EdgeChunks``, ignored here:
the CSR kernels need no chunks). Not ported yet: the data-parallel step
across cards (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ananke_abm_tpu_torch.data_generator import (
    ZONES,
    generate_agent_population,
)
from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gnn_embed.model import GATODE
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    _linears,
    flax_leaf_params,
    load_flax_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
    make_decoded_rollout,
)
from ananke_abm_tpu_torch.ops.segment import edges_from_adj
from ananke_abm_tpu_torch.utils.cfg import ensure_dir
from ananke_abm_tpu_torch.utils.ckpt import (
    OPT_STATE_FORMAT,
    adamw_state,
    load_adamw_state,
    load_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class GATODEConfig:
    zone_dim: int = 64
    agent_dim: int = 32
    context_dim: int = 32
    hidden_dim: int = 128
    gat_heads: int = 4
    gat_layers: int = 2
    num_blocks: int = 2
    method: str = "rk4"
    substeps: int = 2
    rtol: float = 1e-5
    atol: float = 1e-5
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    batch_size: int = 4096
    epochs: int = 10
    compute_dtype: str = "float32"  # or "bfloat16"


def build_model(config: GATODEConfig, num_zone_features: int,
                person_feat_dim: int, *, device="cuda") -> GATODE:
    """A GATODE with uninitialised parameters on ``device`` (the card unless
    the caller asks for the CPU; no fallback); fill it with
    :func:`init_params` or ``load_flax_params``."""
    return GATODE(
        num_zone_features=num_zone_features,
        person_feat_dim=person_feat_dim,
        zone_dim=config.zone_dim,
        agent_dim=config.agent_dim,
        context_dim=config.context_dim,
        hidden_dim=config.hidden_dim,
        gat_heads=config.gat_heads,
        gat_layers=config.gat_layers,
        num_blocks=config.num_blocks,
        compute_dtype=torch.bfloat16
        if config.compute_dtype == "bfloat16"
        else torch.float32,
        device=resolve_device(device),
    )


# flax's lecun_normal: a normal truncated at +-2 standard deviations,
# rescaled by the truncated distribution's standard deviation
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: GATODE, generator: torch.Generator) -> None:
    """Initialise ``model`` in place as flax initialises the reference:
    lecun-normal (truncated) Dense kernels, zero biases, xavier-uniform
    ``a_src`` / ``a_dst``, LayerNorm scale 1 and bias 0. Every draw comes
    from ``generator`` (the numbers differ from JAX's for the same seed)."""
    gdev = generator.device
    for lin in _linears(model).values():
        fan_in = lin.weight.shape[1]
        w = torch.empty(lin.weight.shape, device=gdev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        lin.weight.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        if lin.bias is not None:
            lin.bias.zero_()
    for layer in model.zone_gat.layers:
        for p in (layer.a_src, layer.a_dst):
            heads, d = p.shape  # flax: fan_in = heads, fan_out = d
            limit = math.sqrt(6.0 / (heads + d))
            u = torch.rand(p.shape, generator=generator, device=gdev)
            p.copy_(u * (2 * limit) - limit)
    for norm in model.zone_gat.norms:
        norm.weight.fill_(1.0)
        norm.bias.zero_()


def serve(
    ckpt_path: str,
    out_npz: str,
    n_agents: int = 4096,
    num_times: int | None = None,
    seed: int = 1,
    use_kernel: str | bool = "auto",
    world_seed: int | None = None,
    *,
    device="cuda",
):
    """Serve a GAT-ODE checkpoint (written by either package): regenerate
    its zone world from the checkpoint's world keys, draw a FRESH agent
    population of ``n_agents`` (``seed`` governs the agents only), run the
    decoded rollout on ``device`` and write
    ``out_npz{zone_ids (N, T) int32, times (T,)}``. A sparse-world
    checkpoint serves through the edge-list encoder (no (Z, Z) array), in
    the rollout's float32 body.

    ``use_kernel`` as in ``make_decoded_rollout``. ``device``: the card
    unless the caller asks for the CPU (no fallback). ``world_seed``
    overrides the checkpoint's stored world seed. Checkpoints written
    before the world keys existed record none; serving them requires
    passing it, because guessing would rebuild a different zone world than
    the model was trained on.
    """
    device = resolve_device(device)
    ck = load_checkpoint(ckpt_path)
    config = GATODEConfig(**ck["config"])
    sparse = bool(ck.get("sparse_world", False))
    if world_seed is None:
        if "world_seed" in ck:
            world_seed = int(ck["world_seed"])
        elif not sparse and int(ck["num_zones"]) == len(ZONES):
            # the default mock world is fixed and seed-independent
            world_seed = 0
        else:
            raise ValueError(
                f"checkpoint {ckpt_path} predates the world-reconstruction "
                "keys (no 'world_seed') and its zone world is seeded; pass "
                "world_seed= (the seed the model was trained with) to "
                "serve it"
            )
    data = generate_agent_population(
        n_agents,
        num_times=int(num_times or ck["num_times"]),
        seed=seed,
        num_zones=int(ck["num_zones"]),
        sparse_world=sparse,
        world_seed=int(world_seed),
    )
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=device)
    load_flax_params(model, ck["params"])
    on = lambda a, dtype: torch.as_tensor(a, dtype=dtype).to(device)
    adj = edge_index = None
    if sparse:
        edge_index = tuple(on(e, torch.long) for e in data["edge_index"])
    else:
        adj = on(data["adj"], torch.float32)
    rollout = make_decoded_rollout(
        model, config, on(data["zone_features"], torch.float32), adj,
        on(data["times"], torch.float32), use_kernel=use_kernel,
        edge_index=edge_index,
    )
    t0 = time.time()
    ids = rollout(on(data["person_feats"], torch.float32),
                  on(data["home_zone"], torch.long)).cpu().numpy()
    elapsed = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez(out_npz, zone_ids=ids, times=data["times"])
    return {
        "n_agents": n_agents,
        "num_times": ids.shape[1],
        "seconds": elapsed,
        "out": out_npz,
    }


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay))`` on a model's ``.grad``s.

    The clip is optax's: when the global norm ``g`` of all gradients
    reaches ``max_norm``, each gradient becomes ``grad / g * max_norm``
    (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to ``g``). AdamW
    takes optax's defaults: betas (0.9, 0.999), eps 1e-8, decoupled weight
    decay ``config.weight_decay`` (torch's own default is 1e-2). The clip
    decides on the device: no host sync.
    """

    def __init__(self, params, lr: float, weight_decay: float,
                 max_norm: float):
        self.params = list(params)
        self.max_norm = float(max_norm)
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * self.max_norm))
        self.adamw.step()


def make_optimizer(model, config: GATODEConfig) -> ClippedAdamW:
    """The reference trainer's optimizer (global-norm clip, then AdamW)
    over every parameter of ``model``."""
    return ClippedAdamW(model.parameters(), config.lr, config.weight_decay,
                        config.grad_clip)


def _cross_entropy(logits, targets):
    """(mean NLL of the targets, accuracy of the argmax) over (N, T, Z)
    logits."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    acc = (torch.argmax(logits, -1) == targets).float().mean()
    return nll.mean(), acc


def _build_loss_fn_g(model, config):
    """``loss_fn_g(pf, hz, targets, graph) -> (mean nll, accuracy)``
    through ``GATODE.forward`` at ``config.method`` (plain autograd through
    the solver, each fixed-step interval rematerialised in the backward);
    ``graph`` is a static (:func:`_unpack_static`)."""

    def loss_fn_g(pf, hz, targets, graph):
        zone_feats, adj, times, edge_index, edge_chunks = _unpack_static(
            graph)
        logits, _ = model(zone_feats, adj, pf, hz, times,
                          ode_method=config.method,
                          substeps=config.substeps, rtol=config.rtol,
                          atol=config.atol, edge_index=edge_index,
                          edge_chunks=edge_chunks)
        return _cross_entropy(logits, targets)

    return loss_fn_g


def _step_fns(loss_fn_g, optimizer, graph):
    """(train_step, loss_fn) around ``loss_fn_g(pf, hz, targets, graph)``:
    ``train_step`` zeroes the gradients, backpropagates, steps
    ``optimizer`` (anything with ``zero_grad`` / ``step``) and returns
    ``(loss, acc)``."""

    def train_step(pf, hz, targets):
        optimizer.zero_grad()
        loss, acc = loss_fn_g(pf, hz, targets, graph)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc

    def loss_fn(pf, hz, targets):
        return loss_fn_g(pf, hz, targets, graph)

    return train_step, loss_fn


def make_step_fns(model, optimizer, config, static):
    """The plain training step: ``GATODE.forward`` at ``config.method``
    with autograd through the solver (the reference's ``make_step_fns``).
    ``static`` is ``(zone_feats, adj, times)`` or a sparse static
    (:func:`_unpack_static`). Returns ``(train_step, loss_fn)`` as
    :func:`make_adjoint_step_fns` does."""
    return _step_fns(_build_loss_fn_g(model, config), optimizer,
                     _unpack_static(static))


def build_fused_loss_fn(model, config, zone_feats, adj, times,
                        _plain=False):
    """``loss_fn(pf, hz, targets) -> (loss, acc)`` of the fused fixed-step
    trainer: the zone encoder through the encoder kernels
    (``zone_gat_fused``, K4f/K4b), the initial state in plain PyTorch, the
    day's RK4 integration through the day kernels (``rk4_day_rollout``,
    K2f/K2b) and the decode's cross-entropy through the cross-entropy
    kernels (``decode_ce``, K3f/K3b). On the CPU the kernels' wrappers run
    their plain versions.

    The kernels' contract is enforced: fixed-step RK4 (``config.method``),
    ``attn_temp == 1.0`` (the kernels hard-code that attention) and at
    least one residual drift block; anything else raises, as do widths the
    kernels are not compiled for.

    The encoder goes through K4 where its kernels take the encoder's widths
    (``fused_gat.kernels_fit``) and through ``model.encode_zones``
    elsewhere, as the reference drops back to flax where its kernel does
    not fit.

    Loss and accuracy are means over the agent-time rows. ``_plain``: run
    the kernels' plain versions wherever the tensors lie (to hold the
    kernels' step against).
    """
    if getattr(config, "method", "rk4") != "rk4":
        raise ValueError(
            f"fused train step implements fixed-step rk4, not "
            f"{config.method!r}; use make_step_fns/make_adjoint_step_fns"
        )
    if getattr(model, "attn_temp", 1.0) != 1.0:
        raise ValueError("fused train step requires attn_temp == 1.0")
    if getattr(config, "num_blocks", 1) < 1:
        raise ValueError(
            "fused train step requires num_blocks >= 1 (the VJP kernel's "
            "reverse sweep assumes at least one residual drift block); "
            "use make_step_fns for a block-free drift"
        )
    from ananke_abm_tpu_torch.ops.cuda import fused_gat
    from ananke_abm_tpu_torch.ops.cuda.fused_train import (
        PLAIN,
        decode_ce,
        rk4_day_rollout,
    )

    day_impl, ce_impl, gat_impl = ((PLAIN["day"], PLAIN["ce"],
                                    fused_gat.PLAIN) if _plain
                                   else (None, None, None))
    gat = model.zone_gat
    fuse_gat = fused_gat.kernels_fit(zone_feats.shape[0], zone_feats.shape[1],
                                     model.zone_dim, gat.heads,
                                     gat.num_layers)

    def loss_fn(pf, hz, targets):
        if fuse_gat:
            zone_emb = fused_gat.zone_gat_fused(
                zone_feats, adj, gat, heads=gat.heads,
                num_layers=gat.num_layers, _impl=gat_impl)
        else:
            zone_emb = model.encode_zones(zone_feats, adj)
        x0, h = model.initial_state(pf, hz, zone_emb)
        dense = model.drift.dense
        blocks = tuple(
            (dense[1 + 2 * i].weight.T, dense[1 + 2 * i].bias,
             dense[2 + 2 * i].weight.T, dense[2 + 2 * i].bias)
            for i in range((len(dense) - 2) // 2)
        )
        xs = rk4_day_rollout(
            x0, h, zone_emb, dense[0].weight.T, dense[0].bias,
            model.query_proj.weight.T, blocks, dense[-1].weight.T,
            dense[-1].bias, times, substeps=config.substeps, _impl=day_impl,
        )  # (T, N, Da)
        # the (N, T, Z) logits are never stored
        T, N, Da = xs.shape
        rows = xs.transpose(0, 1).reshape(N * T, Da)
        nll, correct = decode_ce(rows, targets.reshape(-1).to(torch.int32),
                                 model.decode_proj.weight.T, zone_emb,
                                 _impl=ce_impl)
        return nll.sum() / (N * T), correct.float().sum() / (N * T)

    return loss_fn


def make_fused_train_step(model, optimizer, config, static):
    """Training step whose day integration and decode cross-entropy run
    through the training-day kernels (:func:`build_fused_loss_fn`); the
    same loss and gradients as :func:`make_step_fns` to bf16 accuracy.

    ``static`` is ``(zone_feats, adj, times)``: the kernels' encoder is
    dense, so a sparse static raises (``train()`` never takes this step on
    a sparse graph, as the reference's gate). Returns ``(train_step,
    loss_fn)``: ``train_step(pf, hz, targets)`` zeroes the gradients,
    backpropagates, steps ``optimizer`` (``make_optimizer``'s or a
    ``torch.optim`` optimizer) and returns ``(loss, acc)``.
    """
    zone_feats, adj, times, edge_index, _ = _unpack_static(static)
    if edge_index is not None:
        raise ValueError("the fused train step is dense-only; train a "
                         "sparse zone graph with make_step_fns")
    loss_fn = build_fused_loss_fn(model, config, zone_feats, adj, times)
    return _step_fns(lambda pf, hz, tg, _graph: loss_fn(pf, hz, tg),
                     optimizer, None)


def make_epoch_fn(optimizer, loss_fn_g, graph=(), accum=1):
    """One epoch of training steps over permuted batches, with the data on
    the device (the reference's ``make_epoch_fn``; there one jitted scan).

    ``loss_fn_g(pf, hz, targets, graph) -> (loss, acc)``; ``optimizer``:
    ``make_optimizer``'s or a ``torch.optim`` optimizer over the model's
    parameters. Returns ``epoch(pf, hz, tg, batches) -> (losses, accs)``
    with ``batches`` an (n_batches, bsz) long tensor of agent rows on the
    model's device; it steps the model and the optimizer in place, in the
    order of a per-step loop (same batches, same ops), and returns the
    per-microbatch (n_batches,) losses and accuracies on the device: no
    host sync.

    ``accum=k`` turns every k consecutive microbatches into ONE optimizer
    update on the mean of their gradients (backward k times into ``.grad``,
    divide by k, step: the clip of ``ClippedAdamW`` sees the mean, as
    optax's chain does). ``n_batches`` must be a multiple of ``accum``.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def epoch(pf, hz, tg, batches):
        n_b = batches.shape[0]
        if n_b % accum:
            raise ValueError(f"accum={accum} must divide n_batches={n_b}")
        losses, accs = [], []
        for u in range(0, n_b, accum):
            optimizer.zero_grad()
            for rows in batches[u:u + accum]:
                loss, acc = loss_fn_g(pf[rows], hz[rows], tg[rows], graph)
                loss.backward()
                losses.append(loss.detach())
                accs.append(acc.detach())
            if accum > 1:
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.div_(accum)
            optimizer.step()
        return torch.stack(losses), torch.stack(accs)

    return epoch


# zone counts up to which train() runs the fused step (the reference's gate)
FUSED_MAX_ZONES = 2048


def fused_step_fits(config) -> bool:
    """Whether the fused fixed-step trainer's day and cross-entropy kernels
    (K2, K3) take ``config``'s widths and depth: train()'s gate, decided
    from the configuration before anything launches."""
    from ananke_abm_tpu_torch.ops.cuda.fused_train import (
        ce_kernels_fit,
        day_kernels_fit,
    )

    return (day_kernels_fit(config.agent_dim, config.zone_dim,
                            config.context_dim, config.hidden_dim,
                            config.num_blocks)
            and ce_kernels_fit(config.agent_dim, config.zone_dim))


def _resume_checkpoint(path, config, run):
    """The ``gatode_last.ckpt`` at ``path`` if this package wrote it for the
    same run (``run``: the world keys; ``config`` but its ``epochs``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"resume=True but no {path}; run with ckpt_every to produce one")
    refuse = (f"{path} holds an optax optimizer state (a checkpoint of the "
              "JAX package); the port resumes only the checkpoints it wrote")
    try:
        ck = load_checkpoint(path)
    except ModuleNotFoundError as e:  # optax's classes, where optax is absent
        raise ValueError(f"{refuse} (unpickling needs {e.name!r})") from e
    opt = ck.get("opt_state")
    if not (isinstance(opt, dict) and opt.get("format") == OPT_STATE_FORMAT):
        raise ValueError(refuse)
    # everything but the epoch target must match, or the continued run
    # silently diverges from the uninterrupted one
    got = {k: ck.get(k) for k in run}
    cfg_now = {k: v for k, v in dataclasses.asdict(config).items()
               if k != "epochs"}
    cfg_ck = {k: v for k, v in (ck.get("config") or {}).items()
              if k != "epochs"}
    if got != run or cfg_ck != cfg_now:
        diffs = [f"{k}: ckpt {got[k]!r} vs {run[k]!r}"
                 for k in run if got[k] != run[k]]
        diffs += [f"config.{k}: ckpt {cfg_ck.get(k)!r} vs {v!r}"
                  for k, v in cfg_now.items() if cfg_ck.get(k) != v]
        raise ValueError("resume checkpoint was written for a different "
                         "run: " + "; ".join(diffs))
    return ck


def train(
    outdir: str,
    n_agents: int = 8192,
    num_times: int = 48,
    config: GATODEConfig | None = None,
    seed: int = 0,
    num_zones: int | None = None,
    sparse_zones: bool = False,
    sparse_world: bool = False,
    data_parallel: bool = False,
    ckpt_every: int = 0,
    resume: bool = False,
    accum_steps: int = 1,
    *,
    device="cuda",
):
    """Train a GAT-ODE on a generated world (the reference's ``train()``,
    same keys, files and refusals): ``generate_agent_population(n_agents,
    num_times, seed, num_zones)``, :func:`init_params` from ``seed``,
    :func:`make_optimizer`, then ``config.epochs`` epochs of
    :func:`make_epoch_fn`, each over ``np.random.default_rng(seed +
    epoch).permutation(n_agents)`` cut into ``max(1, n_agents // bsz)``
    batches (the reference's batches).

    The step: on the card with ``config.method == "rk4"``, at most
    FUSED_MAX_ZONES zones and widths the day and cross-entropy kernels take
    (:func:`fused_step_fits`), the fused step (:func:`build_fused_loss_fn`:
    the encoder kernels where they fit, the day and cross-entropy kernels);
    ``method="dopri5"`` trains through the discrete adjoint
    (:func:`build_adjoint_loss_fn_g` with ``adjoint_mode="discrete"`` and
    its defaults: K5 and K7 on the card where they fit); otherwise the
    plain step at ``config.method`` (what the reference runs off the TPU,
    and what runs on the CPU), each fixed-step interval rematerialised in
    the backward.

    ``sparse_zones=True`` trains with the edge-list zone encoder: the graph
    rides a COO edge list (the world's ``edge_index``, or
    ``edges_from_adj`` of its adjacency) and the dense (Z, Z) matrix never
    reaches the device; the fused step is never taken on a sparse graph
    (its encoder is dense), as in the reference. ``sparse_world=True``
    (implies ``sparse_zones``) has the generator build the graph as an edge
    list (``sparse_zone_world``), so no O(Z^2) array exists at any stage.
    ``data_parallel`` over more than one card raises (ROADMAP.md queue 1
    item 11); with one card it runs the single-device step, as the
    reference does with one device.

    ``ckpt_every=k`` writes ``gatode_last.ckpt`` (flax-layout params, this
    package's AdamW state, epoch, history, world keys) every k epochs;
    ``resume=True`` continues from it and reproduces the uninterrupted run.
    A ``gatode_last.ckpt`` of the JAX package (an optax state) is refused.
    ``accum_steps=k`` makes each update the mean gradient of k microbatches;
    it must divide the epoch's batch count. ``gatode_best.ckpt`` is written
    at the end in the reference's format: the JAX package's ``serve()``
    reads it. ``device``: the card unless the caller asks for the CPU (no
    fallback).

    Returns ``{final_loss, final_acc, seconds, ckpt}``; ``seconds`` is the
    epochs' wall time, the device synchronised before each reading.
    """
    sparse_zones = sparse_zones or sparse_world
    config = config or GATODEConfig()
    device = resolve_device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    data_parallel = data_parallel and n_dev > 1
    if accum_steps > 1 and data_parallel:
        raise ValueError(
            "accum_steps > 1 is a single-device feature; the data-parallel "
            "step scales its effective batch across chips instead")
    if data_parallel:
        raise NotImplementedError(
            f"data_parallel over {n_dev} cards is not ported yet: "
            "ROADMAP.md queue 1 item 11")
    ensure_dir(outdir)
    data = generate_agent_population(n_agents, num_times=num_times,
                                     seed=seed, num_zones=num_zones,
                                     sparse_world=sparse_world)
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=device)
    init_params(model, torch.Generator(device).manual_seed(seed))
    optimizer = make_optimizer(model, config)
    bsz = min(config.batch_size, n_agents)
    on = lambda a, dtype=torch.float32: torch.as_tensor(
        a, dtype=dtype).to(device)
    static = (on(data["zone_features"]),
              None if sparse_zones else on(data["adj"]), on(data["times"]))
    if sparse_zones:
        ei = (data["edge_index"] if "edge_index" in data
              else edges_from_adj(data["adj"]))
        static += (tuple(on(e, torch.long) for e in ei),)
    Z = int(static[0].shape[0])
    if (config.method == "rk4" and device.type == "cuda" and not sparse_zones
            and Z <= FUSED_MAX_ZONES and fused_step_fits(config)):
        fused_loss = build_fused_loss_fn(model, config, *static)
        epoch_fn = make_epoch_fn(
            optimizer, lambda pf, hz, tg, _g: fused_loss(pf, hz, tg),
            graph=(), accum=accum_steps)
    elif config.method == "dopri5":
        # the adaptive solve trains through the discrete adjoint
        epoch_fn = make_epoch_fn(
            optimizer, build_adjoint_loss_fn_g(model, config, static,
                                               adjoint_mode="discrete"),
            graph=static, accum=accum_steps)
    else:
        epoch_fn = make_epoch_fn(optimizer, _build_loss_fn_g(model, config),
                                 graph=static, accum=accum_steps)
    pf = on(data["person_feats"])
    hz = on(data["home_zone"], torch.long)
    tg = on(data["zone_ids"], torch.long)
    n_batches = max(1, n_agents // bsz)
    if accum_steps > 1 and n_batches % accum_steps:
        raise ValueError(
            f"accum_steps={accum_steps} must divide the epoch's batch count "
            f"({n_batches} batches of {bsz} agents)")

    last_ckpt = os.path.join(outdir, "gatode_last.ckpt")
    names = [name for name, _ in model.named_parameters()]
    run = {"world_seed": seed, "n_agents": n_agents, "num_times": num_times,
           "num_zones": Z, "sparse_world": bool(sparse_world)}
    start_epoch, hist = 1, []
    if resume:
        ck = _resume_checkpoint(last_ckpt, config, run)
        load_flax_params(model, ck["params"])
        load_adamw_state(optimizer.adamw, ck["opt_state"], names)
        hist = list(ck["history"])
        start_epoch = int(ck["epoch"]) + 1

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.time()
    for epoch in range(start_epoch, config.epochs + 1):
        perm = np.random.default_rng(seed + epoch).permutation(n_agents)
        batches = on(perm[: n_batches * bsz].reshape(n_batches, bsz),
                     torch.long)
        losses, accs = epoch_fn(pf, hz, tg, batches)
        # the epoch's one host sync
        hist.append({"epoch": epoch, "loss": float(losses.mean()),
                     "acc": float(accs.mean())})
        if ckpt_every and epoch % ckpt_every == 0:
            save_checkpoint({
                "params": to_flax_params(model),
                "opt_state": adamw_state(optimizer.adamw, names),
                "epoch": epoch,
                "history": hist,
                "config": dataclasses.asdict(config),
                **run,
            }, last_ckpt)
    sync()
    elapsed = time.time() - t0

    ckpt = os.path.join(outdir, "gatode_best.ckpt")
    save_checkpoint({
        "params": to_flax_params(model),
        "config": dataclasses.asdict(config),
        "num_zones": Z,
        "num_times": num_times,
        "history": hist,
        # world reconstruction keys for serve()
        "world_seed": seed,
        "sparse_world": bool(sparse_world),
    }, ckpt)
    return {
        "final_loss": hist[-1]["loss"],
        "final_acc": hist[-1]["acc"],
        "seconds": elapsed,
        "ckpt": ckpt,
    }


class _Rhs(torch.nn.Module):
    """``model.rhs`` as a module's forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, t, x, h, zone_emb):
        return self.model.rhs(t, x, h, zone_emb)


def _adjoint_loss_fn(model, config, rhs_vjp, stats=None, discrete=None,
                     rhs=None):
    """``loss_fn(pf, hz, targets, graph) -> (mean nll, accuracy)`` whose
    integration is adaptive DOPRI5 with adjoint gradients: continuous
    (``rhs_vjp`` its joint evaluator, or None), or discrete where
    ``discrete`` holds ``odeint_discrete_adjoint``'s keywords (its step
    hooks and recording knobs). ``rhs``: the continuous solve's forward
    right-hand side in place of ``model.rhs`` (``make_fused_adjoint_rhs``'s
    first half, whose forward is K8a; not differentiable, so it needs
    ``rhs_vjp``).

    The solver's ``args`` are ``(params, h, zone_emb)`` with ``params``
    every model parameter in the reference's leaf order, as the reference
    threads its whole flax tree: the continuous backward's error norm
    counts them all. The default ``rhs`` reads its weights from ``args``
    (``functional_call``), so the generic backward differentiates the drift
    through them.
    """
    from torch.func import functional_call

    from ananke_abm_tpu_torch.ode import (
        odeint_adjoint,
        odeint_discrete_adjoint,
    )

    leaves = flax_leaf_params(model)
    by_id = {id(p): name for name, p in model.named_parameters()}
    names = ["model." + by_id[id(p)] for _, p in leaves]
    rhs_module = _Rhs(model)

    def model_rhs(t, x, args):
        params, h, zone_emb = args
        return functional_call(rhs_module, dict(zip(names, params)),
                               (t, x, h, zone_emb))

    if rhs is None:
        rhs = model_rhs
    elif discrete is not None or rhs_vjp is None:
        raise ValueError("rhs= is the continuous adjoint's forward; it "
                         "needs rhs_vjp")

    def loss_fn(pf, hz, targets, graph):
        zone_feats, adj, times, edge_index, edge_chunks = _unpack_static(
            graph)
        zone_emb = model.encode_zones(zone_feats, adj, edge_index,
                                      edge_chunks)
        x0, h = model.initial_state(pf, hz, zone_emb)
        params = tuple(p for _, p in leaves)
        args = (params, h, zone_emb)
        if discrete is None:
            xs = odeint_adjoint(rhs, x0, times, args, rtol=config.rtol,
                                atol=config.atol, rhs_vjp=rhs_vjp,
                                stats=stats)
        else:
            xs = odeint_discrete_adjoint(rhs, x0, times, args,
                                         rtol=config.rtol, atol=config.atol,
                                         stats=stats, **discrete)
        return _cross_entropy(model.decode(xs.transpose(0, 1), zone_emb),
                              targets)

    return loss_fn


def _unpack_static(static):
    """``static`` is ``(zone_feats, adj, times)`` or, for a sparse edge-list
    zone graph, ``(zone_feats, adj_or_None, times, edge_index)``: the fourth
    element routes the zone encoder over the edge list (``adj`` may then be
    None). An optional fifth element (the reference's ``EdgeChunks``) is
    carried and ignored. Returns the 5-tuple ``(zone_feats, adj, times,
    edge_index, edge_chunks)``."""
    zone_feats, adj, times = static[:3]
    edge_index = static[3] if len(static) > 3 else None
    edge_chunks = static[4] if len(static) > 4 else None
    return zone_feats, adj, times, edge_index, edge_chunks


def build_adjoint_loss_fn_g(model, config, static, use_fused="auto",
                            adjoint_mode="continuous", max_accepted=512,
                            ckpt_every=16, bwd_precision=None,
                            store_f="auto", ckpt_dtype="auto", stats=None,
                            _plain=False):
    """``loss_fn_g(pf, hz, targets, graph) -> (loss, acc)`` whose
    integration is adaptive DOPRI5 at ``config.rtol``/``config.atol`` with
    adjoint gradients; ``loss.backward()`` fills the model's ``.grad``s.
    ``static`` is ``(zone_feats, adj, times)`` or a sparse static
    (:func:`_unpack_static`), whose edge list the zone encoder reads.

    ``adjoint_mode="continuous"``: the forward runs ``model.rhs`` in
    float32, the backward solves the augmented system, its right-hand side
    through the adjoint RHS kernel (``fused_rhs.drift_rhs_and_vjp``, K8)
    under ``use_fused``. ``"discrete"``: backprop through the forward's
    accepted steps (``ode.odeint_discrete_adjoint``); under ``use_fused``
    each attempted step runs the step kernel (K5, with the controller's
    error norm reduced in the kernel at the config's tolerances) and each
    accepted step's VJP the VJP kernel (K7); ``max_accepted`` and
    ``ckpt_every`` size its recording, ``bwd_precision`` sets the VJPs'
    precision (None: the forward's float32; "bf16": the bf16 stage math).
    ``store_f="auto"`` records the FSAL evals, and ``ckpt_dtype="auto"``
    narrows the state checkpoints to bf16, exactly when ``ckpt_every == 1``
    with ``bwd_precision="bf16"`` (the two bf16 buffers then cost what the
    float32 state buffer alone did); explicit values override. With
    ``ckpt_every == 1`` and the FSAL evals recorded the whole backward is
    one launch of K6 (``fused_dopri5.dopri5_backward_fused``) in place of
    one K7 launch per accepted step: bench rung 3's
    ``max_accepted=256, ckpt_every=1, bwd_precision="bf16"``.

    ``use_fused``: "auto" takes the mode's kernels where the model is on
    CUDA, ``attn_temp == 1.0`` and the kernels take the configuration's
    widths and depth, decided before anything launches; elsewhere the
    plain route (autograd of ``model.rhs``). True forces the kernels'
    route (their plain versions on the CPU; on CUDA widths they do not
    take raise from the wrappers); False keeps the plain route.
    ``_plain``: the discrete kernels' route runs their plain versions, on
    the card too (the check the kernels are held against).

    ``stats``: a dict that each call fills with the solves' step counts
    (``stats["forward"]``; the continuous backward's per interval in
    ``stats["backward"]``, the discrete backward's step replays and VJPs
    in ``stats["replays"]`` and ``stats["vjps"]``).
    """
    if adjoint_mode not in ("continuous", "discrete"):
        raise ValueError(f"unknown adjoint_mode {adjoint_mode!r}")
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5, fused_rhs

    widths = (config.agent_dim, config.zone_dim, config.context_dim,
              config.hidden_dim, config.num_blocks)
    fits = (fused_rhs.kernel_fits if adjoint_mode == "continuous"
            else fused_dopri5.kernels_fit)
    on_cuda = next(model.parameters()).device.type == "cuda"
    if use_fused == "auto":
        use_fused = (on_cuda and getattr(model, "attn_temp", 1.0) == 1.0
                     and fits(*widths))
    if use_fused and getattr(model, "attn_temp", 1.0) != 1.0:
        raise ValueError(
            "the fused adjoint kernels require attn_temp == 1.0 (they "
            "hard-code that attention); pass use_fused=False")
    if adjoint_mode == "continuous":
        rhs_vjp = (fused_rhs.make_fused_adjoint_rhs(model)[1] if use_fused
                   else None)
        return _adjoint_loss_fn(model, config, rhs_vjp, stats)
    explicit_ckpt_dtype = None if ckpt_dtype == "auto" else ckpt_dtype
    ckpt_dtype = None
    if store_f == "auto":
        if ckpt_every == 1 and bwd_precision == "bf16":
            store_f = ckpt_dtype = "bf16"
        else:
            store_f = False
    if explicit_ckpt_dtype is not None:
        ckpt_dtype = explicit_ckpt_dtype
    step_impl = step_vjp = None
    if use_fused:
        step_impl, step_vjp = fused_dopri5.make_fused_dopri5_hooks(
            model, bwd_precision=bwd_precision,
            err_stats=(config.rtol, config.atol), _plain=_plain)
    discrete = dict(max_accepted=max_accepted, ckpt_every=ckpt_every,
                    store_f=store_f, ckpt_dtype=ckpt_dtype,
                    step_impl=step_impl, step_vjp=step_vjp)
    return _adjoint_loss_fn(model, config, None, stats, discrete)


def make_adjoint_step_fns(model, optimizer, config, static,
                          use_fused="auto", adjoint_mode="continuous",
                          max_accepted=512, ckpt_every=16,
                          bwd_precision=None, store_f="auto",
                          ckpt_dtype="auto"):
    """Training step whose integration is adaptive DOPRI5 with adjoint
    gradients, continuous or discrete (the reference's
    ``make_adjoint_step_fns``; knobs as :func:`build_adjoint_loss_fn_g`).

    Returns ``(train_step, loss_fn)``. ``train_step(pf, hz, targets)``
    computes the loss and its gradients, steps ``optimizer`` (from
    :func:`make_optimizer`), updates the model in place and returns
    ``(loss, acc)``. ``loss_fn(pf, hz, targets)`` returns ``(loss, acc)``
    with the graph attached. Both record the last solve's step counts in
    ``.stats``: ``stats["forward"]`` (the forward solve's ``n_steps``,
    ``n_accepted``, ``ok``) and, once the backward has run,
    ``stats["backward"]`` (continuous: one per backward interval, last
    first) or ``stats["replays"]`` and ``stats["vjps"]`` (discrete).
    """
    stats: dict = {}
    loss_fn_g = build_adjoint_loss_fn_g(
        model, config, static, use_fused=use_fused,
        adjoint_mode=adjoint_mode, max_accepted=max_accepted,
        ckpt_every=ckpt_every, bwd_precision=bwd_precision,
        store_f=store_f, ckpt_dtype=ckpt_dtype, stats=stats)
    train_step, loss_fn = _step_fns(loss_fn_g, optimizer,
                                    _unpack_static(static))
    train_step.stats = loss_fn.stats = stats
    return train_step, loss_fn
