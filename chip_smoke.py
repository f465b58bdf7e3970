#!/usr/bin/env python3
"""Smoke test of the PyTorch port's GAT-ODE serving path on one CUDA card.

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles ``ananke_abm_tpu_torch/csrc/fused_step.cu`` with nvcc
   into ``build/ananke_abm_tpu_torch/``;
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
   agents, and per-launch times of the kernel and its plain version.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``{"kernels": [...]}``.
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
    path, log, seconds = _build.build()
    print(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    _build.load_library()
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

    print(card)
    print(json.dumps({"kernels": [{
        "name": "rk4_interval_decode_fused",
        "route": "cuda",
        "source": "ananke_abm_tpu_torch/csrc/fused_step.cu",
        "replaces": "ananke_abm_tpu/ops/pallas/fused_step.py:385",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
