#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the GAT-ODE serving
path (kernel K1) and the continuous-adjoint DOPRI5 trainer (kernel K8).

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles every ``ananke_abm_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, all at once, into ``build/ananke_abm_tpu_torch/``;
3. kernel: the interval kernel against its plain PyTorch version on the
   card at the three shapes of KERNEL_SHAPES and at the main path's own
   operands (x_new's mean and max difference within X_MEAN_ATOL and
   X_MAX_RTOL, ids agreement >= IDS_MIN), and a bf16-product control that
   must fail the same check;
4. slice: ``serve()`` of a seeded random-weight checkpoint at the shipping
   widths, 1,048,576 agents x 48 output times x 64 zones, with the launch
   count of the kernel read around it; the first CHECK_AGENTS agents are
   served again through the plain version and compared;
5. times: the kernel rollout and the plain-version rollout at 1,048,576
   agents, and per-launch times of the kernel and its plain version;
6. adjoint kernel: the drift-and-VJP kernel against its plain version at
   the three shapes of K8_SHAPES (f, gx, gh and every summed gradient
   within the bounds of k8_bounds: mean and max difference against their
   scale, 1 - cosine),
   a repeat on the same operands that must give the same bits, and a
   bf16-product control that must fail the same check;
7. trainer: 3 steps of ``make_adjoint_step_fns`` (continuous adjoint,
   ``use_fused="auto"``) with ``make_optimizer`` at bench rung 3's shape,
   98,304 agents x 64 zones x 12 times, GATODEConfig(method="dopri5"):
   finite losses, the third below the first, and exactly 2 + 6 x
   (attempted steps) kernel launches per backward interval;
8. trainer check: loss and full gradient of one step at 8,192 agents with
   the kernel against the same step with its plain version;
9. times: the adjoint kernel and its plain version per launch at 98,304
   agents, and one full-size training step with each.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``{"kernels": [...]}``, the line before that the card's name and power
limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

N_AGENTS = 1_048_576
NUM_TIMES = 48
NUM_ZONES = 64
WORLD_SEED = 0
AGENT_SEED = 1
CHECK_AGENTS = 65_536
# Kernel vs plain version, one interval. Both round at the same bf16
# points; their float32 sums run in another order, so a sum near a bf16
# rounding boundary now and then rounds the other way. Bounds set from
# H100 readings over these shapes, the main path's intervals and 3 weight
# seeds (PERF.md): a sound kernel read mean |dx| <= 3.9e-5, max |dx| /
# max |x| <= 6.0e-4, ids >= 0.99951; a control whose products round to
# bf16 read mean |dx| >= 3.6e-4 and ids <= 0.9984. The mean separates a
# lower-precision kernel; the max catches a few rows gone wrong.
X_MEAN_ATOL = 1e-4
X_MAX_RTOL = 2e-3
IDS_MIN = 0.999
# the whole 48-time day, where a flipped id carries into later intervals
SLICE_IDS_MIN = 0.995
# (agents, zones, residual blocks) of the kernel check
KERNEL_SHAPES = ((65_536, 64, 2), (1_000, 500, 1), (4_096, 2_048, 2))


def rollout_matmul_flops(da, dz, dc, hidden, num_zones, num_blocks,
                         substeps):
    """Matmul FLOPs per agent of one interval as the kernel computes it
    (2*m*k*n per product; the split Dense_0 runs its h rows once per
    interval and its time rows not at all)."""
    stage = 2 * (da * dz + dz * num_zones + num_zones * dz
                 + (da + dz) * hidden + num_blocks * 2 * hidden * hidden
                 + hidden * da)
    return (4 * substeps * stage + 2 * dc * hidden
            + 2 * (da * dz + dz * num_zones))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out):
    """x_new's (max abs, mean abs, max abs / max |x|) difference and the
    ids' agreement."""
    (xk, ik), (xr, ir) = kernel_out, plain_out
    if not torch.isfinite(xk).all():
        fail("x_new is not finite")
    d = (xk - xr).abs()
    err = d.max().item()
    return {"max": err, "mean": d.mean().item(),
            "rel": err / xr.abs().max().item(),
            "ids": (ik == ir).float().mean().item()}


def agrees(r):
    return (r["mean"] <= X_MEAN_ATOL and r["rel"] <= X_MAX_RTOL
            and r["ids"] >= IDS_MIN)


def describe(r):
    return (f"x_new max abs diff {r['max']:.3e}, mean {r['mean']:.3e} "
            f"(<= {X_MEAN_ATOL}), max / max|x| {r['rel']:.3e} "
            f"(<= {X_MAX_RTOL}); ids agree {r['ids']:.6f} (>= {IDS_MIN})")


def bf16_product_dot(a16, b16):
    """The control of the kernel check: bf16 x bf16 products rounded to
    bf16 (PyTorch's ``a16 @ b16``), a kernel that lost the float32
    accumulation."""
    return (a16.to(torch.bfloat16) @ b16.to(torch.bfloat16)).float()


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this runs on a CUDA card")
    if not (ROOT / "ananke_abm_tpu_torch" / "csrc").is_dir():
        fail(f"no ananke_abm_tpu_torch/csrc beside {Path(__file__).name}: "
             f"run it from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        load_flax_params,
        to_flax_params,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        _kernel_body,
        make_decoded_rollout,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
        serve,
    )
    from ananke_abm_tpu_torch.ops.cuda import _build, fused_step
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        interval_stage_times,
        pack_weights_bf16,
        rk4_interval_decode_fused,
        rk4_interval_decode_reference,
        time_feature_table,
    )
    from ananke_abm_tpu_torch.utils.ckpt import (
        load_checkpoint,
        save_checkpoint,
    )

    # ---- 1. card ----------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name, (path, log, seconds) in built.items():
        print(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(line.strip())
        _build.load_library(name)
    sys.stdout.flush()

    # ---- 3. kernel against its plain version --------------------------------
    config = GATODEConfig()
    max_err = 0.0
    with torch.inference_mode():
        for n, z, nb in KERNEL_SHAPES:
            model = build_model(dataclasses.replace(config, num_blocks=nb),
                                7, 8, device=dev)
            init_params(model, torch.Generator().manual_seed(nb))
            g = torch.Generator(device=dev).manual_seed(n)
            x = torch.randn(n, config.agent_dim, device=dev, generator=g)
            h = torch.randn(n, config.context_dim, device=dev, generator=g)
            ze = torch.randn(z, config.zone_dim, device=dev,
                             generator=g).bfloat16()
            w = pack_weights_bf16(model)
            wd = model.decode_proj.weight.T.bfloat16()
            stage_t = torch.from_numpy(
                interval_stage_times(6.5, 0.25, config.substeps)).to(dev)
            args = (x, h, ze, w, wd, time_feature_table(stage_t, w[3], w[4]),
                    0.25)
            got = rk4_interval_decode_fused(*args)
            torch.cuda.synchronize()
            want = rk4_interval_decode_reference(*args)
            torch.cuda.synchronize()
            r = compare(got, want)
            max_err = max(max_err, r["max"])
            print(f"kernel check N={n} Z={z} num_blocks={nb}: {describe(r)}",
                  flush=True)
            if not agrees(r):
                fail(f"kernel disagrees with its plain version at N={n}")

    # ---- 4. the slice at bench rung 1 size ------------------------------------
    OUT.mkdir(parents=True, exist_ok=True)
    ckpt = OUT / "gatode_random.ckpt"
    data = generate_agent_population(N_AGENTS, num_times=NUM_TIMES,
                                     seed=AGENT_SEED, num_zones=NUM_ZONES,
                                     world_seed=WORLD_SEED)
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    save_checkpoint({
        "params": to_flax_params(model),
        "config": dataclasses.asdict(config),
        "num_zones": NUM_ZONES,
        "num_times": NUM_TIMES,
        "history": [],
        "world_seed": WORLD_SEED,
        "sparse_world": False,
    }, str(ckpt))

    rk4_interval_decode_fused.launches = 0
    info = serve(str(ckpt), str(OUT / "served.npz"), n_agents=N_AGENTS,
                 seed=AGENT_SEED, use_kernel="auto", device="cuda")
    launches = rk4_interval_decode_fused.launches
    print(f"serve: {info['n_agents']} agents x {info['num_times']} times in "
          f"{info['seconds']:.3f} s (host clock, incl. encode/init/copy "
          f"out); kernel launches {launches}", flush=True)
    if launches != NUM_TIMES - 1:
        fail(f"expected {NUM_TIMES - 1} kernel launches, got {launches}")
    with np.load(OUT / "served.npz") as served:
        ids = served["zone_ids"]
    if ids.shape != (N_AGENTS, NUM_TIMES) or ids.dtype != np.int32:
        fail(f"served ids {ids.shape} {ids.dtype}")
    if ids.min() < 0 or ids.max() >= NUM_ZONES:
        fail(f"served ids out of [0, {NUM_ZONES})")

    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    served_model = build_model(config, data["zone_features"].shape[-1],
                               data["person_feats"].shape[-1], device=dev)
    load_flax_params(served_model, load_checkpoint(str(ckpt))["params"])
    graph = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    agents = (on(data["person_feats"]), on(data["home_zone"], torch.long))
    plain_body = _kernel_body(served_model, config.substeps,
                              rk4_interval_decode_reference)

    def plain(person_feats, home_zone_ids):
        with torch.inference_mode():
            return plain_body(*graph, person_feats, home_zone_ids)

    ref = plain(agents[0][:CHECK_AGENTS], agents[1][:CHECK_AGENTS])
    agree = float(np.mean(ref.cpu().numpy() == ids[:CHECK_AGENTS]))
    print(f"slice check: served ids[:{CHECK_AGENTS}] vs the plain-version "
          f"body: agree {agree:.6f} (>= {SLICE_IDS_MIN})", flush=True)
    if agree < SLICE_IDS_MIN:
        fail("served ids disagree with the plain-version body")

    # the kernel at the main path's own operands: interval 0 of the day
    weights = pack_weights_bf16(served_model)
    with torch.inference_mode():
        zone_emb = served_model.encode_zones(*graph[:2])
        x0, h = served_model.initial_state(*agents, zone_emb)
        t = data["times"]
        dt = float((np.float32(t[1]) - np.float32(t[0]))
                   / np.float32(config.substeps))
        stage_t = torch.from_numpy(
            interval_stage_times(t[0], dt, config.substeps)).to(dev)
        args = (x0, h, zone_emb.bfloat16(), weights,
                served_model.decode_proj.weight.T.bfloat16(),
                time_feature_table(stage_t, weights[3], weights[4]), dt)
        got = rk4_interval_decode_fused(*args)
        torch.cuda.synchronize()
        want = rk4_interval_decode_reference(*args)
        r = compare(got, want)
        max_err = max(max_err, r["max"])
        print(f"kernel check at the main path's operands (N={N_AGENTS}, "
              f"Z={NUM_ZONES}, interval 0): {describe(r)}", flush=True)
        if not agrees(r):
            fail("kernel disagrees with its plain version on the main path")
        # the control must fail the same check, or the bounds cannot tell a
        # kernel that lost the float32 accumulation from a sound one
        plain_dot, fused_step._dot = fused_step._dot, bf16_product_dot
        try:
            control = compare(rk4_interval_decode_reference(*args), want)
        finally:
            fused_step._dot = plain_dot
        print(f"control (bf16-rounded products) at the same operands: "
              f"{describe(control)}", flush=True)
        if agrees(control):
            fail("the kernel check passes the bf16-product control")

        # ---- 5. times ---------------------------------------------------------
        ms = cuda_ms(lambda: rk4_interval_decode_fused(*args), 20)
        plain_ms = cuda_ms(lambda: rk4_interval_decode_reference(*args), 5)
    flop = rollout_matmul_flops(config.agent_dim, config.zone_dim,
                                config.context_dim, config.hidden_dim,
                                NUM_ZONES, config.num_blocks,
                                config.substeps) * N_AGENTS
    print(f"interval at N={N_AGENTS}: kernel {ms:.3f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain version {plain_ms:.3f} ms "
          f"({flop / plain_ms / 1e9:.1f} TFLOP/s) [card {card}]", flush=True)

    rollouts = {
        "kernel": make_decoded_rollout(served_model, config, *graph,
                                       use_kernel=True),
        "plain": plain,
    }
    walls = {k: [] for k in rollouts}
    for name in ("plain", "kernel", "kernel", "plain"):
        if not walls[name]:
            rollouts[name](*agents)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollouts[name](*agents)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    for name, w in walls.items():
        best = min(w)
        print(f"rollout {name}: {N_AGENTS} agents x {NUM_TIMES} times, wall "
              f"{best:.4f} s (runs {', '.join(f'{s:.4f}' for s in w)}), "
              f"{N_AGENTS / best:.0f} agents/s [card {card}]", flush=True)

    k1 = {
        "name": "rk4_interval_decode_fused",
        "route": "cuda",
        "source": "ananke_abm_tpu_torch/csrc/fused_step.cu",
        "replaces": "ananke_abm_tpu/ops/pallas/fused_step.py:385",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }
    k8 = adjoint_phases(dev, card)

    print(card)
    print(json.dumps({"kernels": [k1, k8]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


# ---- the continuous-adjoint trainer and its kernel, K8 ---------------------

# bench rung 3 (bench.py ADAPT_*): 98,304 agents x 64 zones x 12 times
ADAPT_N = 98_304
ADAPT_ZONES = 64
ADAPT_TIMES = 12
ADAPT_SEED = 7
TRAIN_STEPS = 3
# the kernel trainer against the plain-version trainer
CHECK_TRAIN_AGENTS = 8_192
TRAIN_LOSS_RTOL = 2e-3
TRAIN_COS_MIN = 0.999
# (agents, zones, residual blocks) of the kernel check
K8_SHAPES = ((98_304, 64, 2), (1_000, 500, 1), (4_096, 2_048, 2))
# Kernel vs plain version, per output (f, gx, gh and each summed
# gradient): mean |d| / mean |ref|, max |d| / max |ref| and 1 - cosine.
# Both round at the same bf16 points and sum in other orders, and the
# flips compound through the residual blocks: readings grow about
# linearly with depth. Bounds for 2 blocks, scaled by (2 + blocks) / 4,
# set from H100 readings over 1-8 blocks and 2-3 weight seeds each
# (PERF.md, "Tolerance of the K8 check"). At 2 blocks a sound kernel read
# worst mean <= 1.04e-3, worst max <= 3.95e-3, worst 1 - cosine <=
# 5.3e-7; a control whose products round to bf16 read worst mean >=
# 6.9e-3 and worst 1 - cosine >= 2.5e-5. The mean and the cosine separate
# a lower-precision kernel; the max catches a few rows gone wrong.
K8_REL_MEAN = 3e-3
K8_REL_MAX = 1e-2
K8_ONE_MINUS_COS = 1e-5


def k8_bounds(num_blocks):
    """(mean, max, 1 - cosine) bounds of the K8 check at a depth."""
    s = (2 + num_blocks) / 4
    return K8_REL_MEAN * s, K8_REL_MAX * s, K8_ONE_MINUS_COS * s

def drift_vjp_flops(da, dz, dc, hidden, num_zones, num_blocks):
    """Matmul FLOPs per agent of one launch of the adjoint RHS kernel as
    it computes them (2*m*k*n per product): the forward, the backward's
    per-row products and weight-gradient products, the recomputed inner
    activation of each block and the attention scores recomputed in two
    passes."""
    h, z, f = hidden, num_zones, da + dz
    fwd = 2 * (da * dz + 2 * dz * z + f * h + dc * h
               + num_blocks * 2 * h * h + h * da)
    bwd = 2 * (2 * h * da + num_blocks * 5 * h * h + 2 * h * dc
               + 2 * f * h + 4 * dz * z + z * dz + 2 * z * dz
               + 2 * da * dz)
    return fwd + bwd


def k8_operands(model, n, z, dev, seed):
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


def k8_outputs(out):
    """(name, tensor) of every output of drift_rhs_and_vjp."""
    names = ["f", "gx", "gh", "gze", "gtf", "gWq", "gW1xc", "gW1h"]
    items = list(zip(names, out[:8]))
    for i, blk in enumerate(out[8]):
        items += list(zip([f"gWr1[{i}]", f"gbr1[{i}]", f"gWr2[{i}]",
                           f"gbr2[{i}]"], blk))
    return items + [("gW3", out[9]), ("gb3", out[10])]


def k8_compare(got, want):
    """Per output: mean |d| / mean |ref|, max |d| / max |ref|, cosine;
    the worst of each over the outputs, the largest |d|, and the output
    that set each worst."""
    worst = {"mean": (0.0, ""), "max": (0.0, ""), "cos": (1.0, "")}
    max_abs = 0.0
    for (name, u), (_, v) in zip(k8_outputs(got), k8_outputs(want)):
        if not torch.isfinite(u).all():
            fail(f"adjoint kernel output {name} is not finite")
        d = (u - v).abs()
        max_abs = max(max_abs, d.max().item())
        mean = d.mean().item() / max(v.abs().mean().item(), 1e-30)
        mx = d.max().item() / max(v.abs().max().item(), 1e-30)
        cos = (torch.dot(u.flatten().double(), v.flatten().double())
               / (u.double().norm() * v.double().norm() + 1e-300)).item()
        if mean > worst["mean"][0]:
            worst["mean"] = (mean, name)
        if mx > worst["max"][0]:
            worst["max"] = (mx, name)
        if cos < worst["cos"][0]:
            worst["cos"] = (cos, name)
    return worst, max_abs


def k8_agrees(worst, num_blocks):
    mean, mx, one_minus_cos = k8_bounds(num_blocks)
    return (worst["mean"][0] <= mean and worst["max"][0] <= mx
            and 1 - worst["cos"][0] <= one_minus_cos)


def k8_describe(worst, num_blocks):
    mean, mx, one_minus_cos = k8_bounds(num_blocks)
    return (f"worst mean|d|/mean|ref| {worst['mean'][0]:.3e} "
            f"({worst['mean'][1]}; <= {mean:.3g}), worst max|d|/max|ref| "
            f"{worst['max'][0]:.3e} ({worst['max'][1]}; <= {mx:.3g}), "
            f"worst 1 - cosine {1 - worst['cos'][0]:.3e} ({worst['cos'][1]}; "
            f"<= {one_minus_cos:.3g})")


def bf16_product_nt_dot(a16, b16):
    """The control's agent contraction: bf16 products rounded to bf16."""
    return (a16.to(torch.bfloat16).T @ b16.to(torch.bfloat16)).float()


def k8_control(args):
    """The plain version with every product rounded to bf16: a kernel that
    lost the float32 accumulation."""
    from ananke_abm_tpu_torch.ops.cuda import fused_rhs, fused_step

    saved = (fused_step._dot, fused_step._nt_dot, fused_rhs._dot,
             fused_rhs._nt_dot)
    fused_step._dot = fused_rhs._dot = bf16_product_dot
    fused_step._nt_dot = fused_rhs._nt_dot = bf16_product_nt_dot
    try:
        return fused_rhs.drift_rhs_and_vjp_reference(*args)
    finally:
        (fused_step._dot, fused_step._nt_dot, fused_rhs._dot,
         fused_rhs._nt_dot) = saved


def grads_of(model):
    return torch.cat([p.grad.flatten() for p in model.parameters()])


def adjoint_phases(dev, card):
    """Phases 6-9: K8 against its plain version, the trainer at rung 3,
    the kernel trainer against the plain-version trainer, and times.
    Returns K8's entry of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _adjoint_loss_fn,
        build_model,
        init_params,
        make_adjoint_step_fns,
        make_optimizer,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
        drift_rhs_and_vjp,
        drift_rhs_and_vjp_reference,
        make_fused_adjoint_rhs,
    )

    # ---- 6. adjoint kernel against its plain version ----------------------
    config = GATODEConfig(method="dopri5")
    max_err = 0.0
    main_args = None
    for n, z, nb in K8_SHAPES:
        model = build_model(dataclasses.replace(config, num_blocks=nb), 7, 8,
                            device=dev)
        init_params(model, torch.Generator().manual_seed(nb))
        args = k8_operands(model, n, z, dev, seed=n)
        with torch.inference_mode():
            got = drift_rhs_and_vjp(*args)
            again = drift_rhs_and_vjp(*args)
            torch.cuda.synchronize()
            want = drift_rhs_and_vjp_reference(*args)
        if not all(torch.equal(u, v) for (_, u), (_, v) in
                   zip(k8_outputs(got), k8_outputs(again))):
            fail(f"adjoint kernel repeat at N={n} Z={z} is not "
                 "bit-identical")
        worst, err = k8_compare(got, want)
        max_err = max(max_err, err)
        print(f"adjoint kernel check N={n} Z={z} num_blocks={nb}: "
              f"{k8_describe(worst, nb)}; max |d| {err:.3e}; repeat "
              f"bit-identical", flush=True)
        if not k8_agrees(worst, nb):
            fail(f"adjoint kernel disagrees with its plain version at N={n}")
        if main_args is None:
            main_args = args
    with torch.inference_mode():
        control, _ = k8_compare(k8_control(main_args),
                                drift_rhs_and_vjp_reference(*main_args))
    print(f"control (bf16-rounded products) at N={K8_SHAPES[0][0]}: "
          f"{k8_describe(control, K8_SHAPES[0][2])}", flush=True)
    if k8_agrees(control, K8_SHAPES[0][2]):
        fail("the adjoint kernel check passes the bf16-product control")

    # ---- 7. the trainer at bench rung 3 ---------------------------------
    data = generate_agent_population(ADAPT_N, num_times=ADAPT_TIMES,
                                     seed=ADAPT_SEED, num_zones=ADAPT_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(ADAPT_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(model, config)
    step, _ = make_adjoint_step_fns(model, opt, config, static,
                                    adjoint_mode="continuous",
                                    use_fused="auto")
    flop = drift_vjp_flops(config.agent_dim, config.zone_dim,
                           config.context_dim, config.hidden_dim,
                           ADAPT_ZONES, config.num_blocks) * ADAPT_N
    with torch.inference_mode():
        k8_ms = cuda_ms(lambda: drift_rhs_and_vjp(*main_args), 20)
    losses, walls = [], []
    drift_rhs_and_vjp.launches = 0
    for i in range(TRAIN_STEPS):
        before = drift_rhs_and_vjp.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = step(*batch)
        loss = loss.item()
        wall = time.perf_counter() - t0
        launched = drift_rhs_and_vjp.launches - before
        fwd, bwd = step.stats["forward"], step.stats["backward"]
        want = sum(2 + 6 * s["n_steps"] for s in bwd)
        syncs = (fwd["n_steps"] + 3) + sum(s["n_steps"] + 2 for s in bwd)
        print(f"train step {i + 1}: loss {loss:.6f} acc {acc.item():.4f}, "
              f"wall {wall:.3f} s; forward {fwd['n_steps']} steps "
              f"({fwd['n_accepted']} accepted); backward "
              f"{sum(s['n_steps'] for s in bwd)} steps "
              f"({sum(s['n_accepted'] for s in bwd)} accepted; per interval "
              f"{[s['n_steps'] for s in bwd]}); kernel launches {launched} "
              f"(expected {want}); host syncs {syncs}; kernel share "
              f"{launched * k8_ms / 1e3 / wall:.1%} ({launched} x "
              f"{k8_ms:.3f} ms by CUDA events) [card {card}]", flush=True)
        if launched != want:
            fail(f"step {i + 1} launched the adjoint kernel {launched} "
                 f"times, expected {want}")
        if not (fwd["ok"] and all(s["ok"] for s in bwd)):
            fail(f"step {i + 1}: a solve ran out of steps")
        losses.append(loss)
        walls.append(wall)
    k8_launches = drift_rhs_and_vjp.launches
    print(f"trainer: {ADAPT_N} agents x {ADAPT_ZONES} zones x {ADAPT_TIMES} "
          f"times, {n_params} parameters, {TRAIN_STEPS} steps, losses "
          f"{losses}, kernel launches {k8_launches}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses {losses}: not finite and falling")

    # ---- 8. kernel trainer against the plain-version trainer -------------
    sub = tuple(b[:CHECK_TRAIN_AGENTS] for b in batch)
    kernel_loss = _adjoint_loss_fn(model, config,
                                   make_fused_adjoint_rhs(model)[1])
    plain_loss = _adjoint_loss_fn(
        model, config,
        make_fused_adjoint_rhs(model, drift_rhs_and_vjp_reference)[1])
    results = []
    for fn in (kernel_loss, plain_loss):
        model.zero_grad()
        loss, _ = fn(*sub, static)
        loss.backward()
        results.append((loss.item(), grads_of(model)))
    (lk, gk), (lp, gp) = results
    cos = (torch.dot(gk.double(), gp.double())
           / (gk.double().norm() * gp.double().norm())).item()
    rel = abs(lk - lp) / abs(lp)
    print(f"trainer check at {CHECK_TRAIN_AGENTS} agents: loss kernel "
          f"{lk:.7f} plain {lp:.7f} (rel {rel:.3e} <= {TRAIN_LOSS_RTOL}; the "
          f"forward is the same float32 solve); gradient cosine {cos:.9f}, "
          f"1 - cosine {1 - cos:.3e} (cosine > {TRAIN_COS_MIN})", flush=True)
    if not (rel <= TRAIN_LOSS_RTOL and cos > TRAIN_COS_MIN):
        fail("the kernel trainer disagrees with the plain-version trainer")

    # ---- 9. times ----------------------------------------------------------
    with torch.inference_mode():
        plain_ms = cuda_ms(lambda: drift_rhs_and_vjp_reference(*main_args),
                           5)
    print(f"adjoint kernel at N={ADAPT_N} Z={ADAPT_ZONES}: kernel "
          f"{k8_ms:.3f} ms ({flop / k8_ms / 1e9:.1f} TFLOP/s), plain version "
          f"{plain_ms:.3f} ms ({flop / plain_ms / 1e9:.1f} TFLOP/s) of "
          f"{flop / 1e9:.1f} GFLOP [card {card}]", flush=True)
    opt.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = plain_loss(*batch, static)
    loss.backward()
    opt.step()
    loss = loss.item()
    plain_wall = time.perf_counter() - t0
    print(f"training step at rung 3: kernel {min(walls[1:]):.3f} s (best of "
          f"steps 2-{TRAIN_STEPS}), plain version {plain_wall:.3f} s (one "
          f"step, loss {loss:.6f}) [card {card}]", flush=True)
    return {
        "name": "drift_rhs_and_vjp",
        "route": "cuda",
        "source": "ananke_abm_tpu_torch/csrc/fused_rhs.cu",
        "replaces": "ananke_abm_tpu/ops/pallas/fused_rhs.py:184",
        "launches": k8_launches,
        "max_abs_err": max_err,
        "ms": k8_ms,
        "plain_ms": plain_ms,
    }


if __name__ == "__main__":
    main()
