#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the GAT-ODE serving
path (kernel K1), the continuous-adjoint DOPRI5 trainer (kernel K8), the
fixed-step RK4 trainer (kernels K4f, K4b, K2f, K2b, K3f, K3b) and
``train()`` through it, ``serve()`` of what it trained, the
discrete-adjoint DOPRI5 trainer (kernels K5, K7) with
``train(method="dopri5")``, that trainer at bench rung 3's own settings,
its whole backward one launch of K6 (K7's bf16 branch on the per-step bf16
route), sparse edge-list zone graphs (the CSR edge kernel pair):
``serve()`` and ``train()`` of the Z=32,768 sparse world, and the last
four kernels' paths: the per-step serving rollout (K0), the continuous
adjoint over the fused pair (K8a forward, K8 backward), the discrete
adjoint with a bf16 forward (K5's bf16 branch, K6) and the segment sum
(K9e).

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles every ``ananke_abm_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, all at once, into ``build/ananke_abm_tpu_torch/``,
   and prints ptxas's registers and spills per kernel;
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
   within the bounds of ``ops/cuda/checks.py``'s k8_bounds: mean and max
   difference against their scale, 1 - cosine),
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
   agents, and one full-size training step with each;
10. training-day kernels: the day forward and backward (K2f, K2b) and the
    decode cross-entropy forward and backward (K3f, K3b) against their
    plain versions at the shapes of DAY_SHAPES (every output within the
    bounds of ``ops/cuda/checks.py``: day_bounds, CE_BOUNDS), repeats of
    K2b and K3b that must give the same bits, and a bf16-product control
    that must fail each check;
11. fixed-step trainer: 3 steps of ``make_fused_train_step`` with
    ``torch.optim.AdamW`` at optax's defaults at bench rung 2's shape,
    32,768 agents x 500 zones x 12 times, GATODEConfig(substeps=2,
    num_blocks=2): one launch of each of the six kernels (the encoder's
    K4f / K4b included) per step, finite losses, the third below the first;
12. fixed-step trainer check: loss and full gradient of one step at 4,096
    agents with the kernels against the same step with their plain
    versions (the encoder's too);
13. times: the four day and cross-entropy kernels and their plain versions
    per launch at rung 2, and one full-size fixed-step training step with
    each;
14. encoder kernels: K4f and K4b against their plain versions at the
    shapes of GAT_SHAPES (the first the main path's zone world; the last
    with a zone whose adjacency row is all zero): the output and every
    parameter gradient within ``ops/cuda/checks.py``'s GAT_FWD_BOUNDS /
    GAT_BWD_BOUNDS, repeats that must give the same bits, and a control
    whose products run in TF32 that must fail each check;
15. ``train()`` on the card at rung 2's widths: 65,536 agents x 500 zones x
    12 times, batches of 32,768, 2 epochs with ``ckpt_every=1``: finite
    losses and one launch of each of the six kernels per step; then
    ``resume=True`` to 3 epochs against a straight 3-epoch run (histories
    within rtol 1e-5), then one ``accum_steps=2`` epoch (2 microbatches, 1
    update);
16. ``serve()`` of phase 15's ``gatode_best.ckpt`` at 65,536 agents through
    K1;
17. times: K4f, K4b and their plain versions per call at Z=500 (device
    time, each call captured in a CUDA graph and replayed, and eager time),
    the encoder forward and backward through K4 and through
    ``model.encode_zones`` (the step's encoder before K4), one rung-2 fixed
    step with each encoder, and the wall time of a ``train()`` epoch;
18. DOPRI5 step kernels: K5 (with and without the in-kernel error sum)
    and K7 against their plain versions at the shapes of DOPRI5_SHAPES
    (rung 3's operands, an N no tile divides, 1 and 8 blocks) within
    ``ops/cuda/checks.py``'s DOPRI5_STEP_BOUNDS / DOPRI5_VJP_BOUNDS,
    repeats that must give the same bits, a control whose products run in
    TF32 that must fail each check, and kernel, plain version and control
    against a float64 run at DOPRI5_WITNESS_SHAPE;
19. discrete trainer: 3 steps of ``make_adjoint_step_fns(adjoint_mode=
    "discrete")`` at rung 3's shape with train()'s defaults (max_accepted
    512, ckpt_every 16): finite losses, the third below the first, K5
    launched once per attempted forward step and backward replay, K7 once
    per accepted step; its step wall beside phase 7's; then a fourth step
    under ``torch.profiler``: the device's busy and idle share of its wall
    time and its device time by kernel name (the model and optimizer put
    back after it);
20. discrete trainer check at 8,192 agents: the kernels against their
    plain versions (the same accepted steps, loss rel <= 1e-4, gradient
    cosine > 0.9999) and against the continuous adjoint (loss rel <= 2e-4,
    cosine > 0.999);
21. ``train(method="dopri5")``: 32,768 agents x 64 zones x 12 times,
    batches of 16,384, 2 epochs: finite losses and the launch counts of
    phase 19 summed over its steps;
22. repair check: ``train()`` at ``gat_heads=2`` (no K4 launch, each day
    and cross-entropy kernel once a step) and ``hidden_dim=64`` (no kernel
    launch); ``serve()`` of the ``hidden_dim=64`` checkpoint with
    ``use_kernel="auto"``: no K1 launch, ids equal to the float32 body's
    (``use_kernel=False``);
23. times: K5 and K7 and their plain versions per launch at rung 3;
24. whole-backward kernels: K6 (precision bf16 and f32, checkpoints bf16
    and float32, recordings of ``checks.K6_RECORD``, steps past the
    accepted count among them) and K7's bf16 branch against their plain
    versions at the shapes of DOPRI5_SHAPES within ``ops/cuda/checks.py``'s
    DOPRI5_BWD_BF16_BOUNDS
    (scaled with depth), DOPRI5_BWD_BOUNDS and DOPRI5_VJP_BF16_BOUNDS,
    repeats that must give the same bits, the bf16-product control (TF32
    for K6 at f32) that must fail each check, and kernel, plain version and
    control against a float64 run at DOPRI5_WITNESS_SHAPE;
25. rung 3 at its own settings: 3 steps of ``make_adjoint_step_fns(
    adjoint_mode="discrete", max_accepted=256, ckpt_every=1,
    bwd_precision="bf16")`` at 98,304 x 64 x 12, seed 7: finite losses,
    the third below the first, K6 launched once and K7 never per step, K5
    once per attempted forward step; its step wall beside phase 19's; a
    fourth step under ``torch.profiler`` as in phase 19;
26. at 8,192 agents the K6 route against the same route with
    ``_plain=True`` (every plain version: loss rel <= 1e-4 as phase 20,
    the same accepted steps, cosine > 0.999), the per-step bf16 route
    (``ckpt_every=2``, K7-bf16; cosine > 0.9999) and the float32 per-step
    route of phase 20 (cosine > 0.999);
27. K6 against its plain version on the operands phase 25's last step
    gave it (its recording of 16-17 accepted steps in a 256-step buffer,
    bf16 checkpoints, the loss's cotangents) within DOPRI5_BWD_BF16_BOUNDS,
    the same bits on a repeat; times: K6 and its plain version per launch
    on those operands, K7-bf16 and its plain version per launch at rung 3,
    and the rung-3 step;
28. CSR edge kernels: the forward and backward of ``ops/cuda/
    edge_segment.py`` against their plain versions at the shapes of
    ``ops/cuda/checks.py``'s EDGE_SHAPES (the Z=32,768 sparse world, rung
    2's Z=500 world as an edge list, a random graph with isolated
    destinations, duplicate edges and num_nodes below the source count, in
    heads of 32 and of 48, which straddle lanes; one head of 64) within EDGE_FWD_BOUNDS / EDGE_BWD_BOUNDS, repeats that
    must give the same bits, and a control whose features round to bf16
    (the TPU kernels' own) that must fail each check;
29. the sparse encoder against the dense one at rung 2's world:
    ``encode_zones(zf, None, edge_index)`` against ``encode_zones(zf,
    adj)``, output and parameter gradients (tests/test_gnn_embed.py's
    bounds), the CSR kernels launched ``gat_layers`` times each;
30. ``serve()`` of a seeded random-weight sparse-world checkpoint at
    Z=32,768, 65,536 agents x 48 times: the CSR forward launched
    ``gat_layers`` times and the backward never, wall time, agents/s and
    peak device memory; the first 8,192 agents served again with the
    encoder's plain version (ids agree >= SPARSE_IDS_MIN);
31. ``train(sparse_world=True)`` at Z=32,768, 8,192 agents x 12 times,
    batches of 4,096, 2 epochs, the plain RK4 step with remat: finite
    losses, each CSR kernel launched ``gat_layers`` times a step, no dense
    kernel, the step's wall time and peak device memory beside the
    no-remat estimate; ``serve()`` of what it trained;
32. ``train(sparse_world=True, num_zones=4096, method="dopri5")``, 4,096
    agents x 12 times, 1 epoch: a finite loss, the CSR launches per step
    and the K5 / K7 counts;
33. times: the CSR forward and backward and their plain versions per call
    at Z=32,768 (CUDA-graph replay, eager beside), the sparse training
    step with the kernels and with their plain versions, and a dense plain
    RK4 step (Z=4,096, no kernel) with remat and without: its wall time
    and peak device memory at ``checkpoint=True`` and ``False``.
34. serving step kernel: K0 against its plain version at KERNEL_SHAPES and
    at the rung-1 operands (substep 0 of phase 4's day) within X_MEAN_ATOL
    / X_MAX_RTOL, repeats that must give the same bits, and the
    bf16-product control that must fail the same check;
35. the per-step rollout ``make_pallas_rollout(fuse_decode=False)`` at
    rung 1 (phase 4's weights and agents): K0 launched 94 times and K1
    never, its ids against phase 4's K1 rollout (>= IDS_MIN), the first
    CHECK_AGENTS served again with the plain step (>= SLICE_IDS_MIN),
    wall time, agents/s beside phase 5's and peak device memory; K0's time;
36. K8a against its plain version at K8_SHAPES within k8_bounds, repeats
    that must give the same bits, the bf16-product control; then one loss
    and gradient of the continuous adjoint over the fused pair
    (``make_fused_adjoint_rhs``: K8a forward, K8 backward) at rung 3's
    shape and rtol = atol = 1e-5, K8a launched 2 + 6 x (attempted forward
    steps) times and K8 as phase 7 counts it, against phase 7's route
    (``model.rhs`` forward, K8 backward) on the same batch: loss rel <=
    TRAIN_LOSS_RTOL and gradient cosine > TRAIN_COS_MIN, held at 1e-3
    where the fused forward's bf16 stage noise takes more than
    FUSED_PAIR_STEP_RATIO times phase 7's forward steps; K8a's time;
37. K5's bf16 branch against its plain version at DOPRI5_SHAPES (y1, f1,
    r5 and the error sum, within checks.DOPRI5_STEP_BF16_BOUNDS), repeats
    that must give the same bits, K5's float32 kernel on the same operands
    as the control, and all three against a float64 witness at
    DOPRI5_WITNESS_SHAPE; then the discrete adjoint with
    ``make_fused_dopri5_hooks(precision="bf16", bwd_precision="bf16")`` at
    rung 3's shape and recording (max_accepted 256, ckpt_every 1) at rtol
    = atol = 1e-3: a finite loss, K5 once per attempted step, K6 once, K7
    never; against the float32-forward route at the same tolerance
    (gradient cosine > TRAIN_COS_MIN); K5-bf16's time;
38. the segment sum K9e against its plain version at
    checks.SEGMENT_SHAPES (rung 1's 1,048,576 x 32 into 64 zones, rung 2's
    32,768 x 32 into 500, a random case of 2,048 segments with dropped and
    negative ids and empty segments) within checks.SEGMENT_BOUNDS, repeats
    with int32 ids that must give the same bits, the unrounded sum as the
    control; the two real sizes once each; times of K9e, its plain version
    and ``index_add_`` on the same bf16-rounded rows.

``python3 chip_smoke.py --readings`` runs phases 1-2 and then only the
training kernels' checks of phase 10, at DAY_SHAPES and DEPTH_SHAPES for 3
seeds with the control everywhere, printing the readings the bounds were
set from and failing on none of them; then, at WITNESS_SHAPES, the day
kernels, their plain versions and the control each against a float64
witness. ``python3 chip_smoke.py --readings encoder`` prints the same
readings of K4f and K4b, at GAT_SHAPES and GAT_READING_SHAPES for 3 seeds,
and K4b and its plain version each against a float64 run;
``--readings dopri5`` those of K5, K7, K6 and K7-bf16 at DOPRI5_SHAPES
and DOPRI5_READING_SHAPES for 3 seeds, with their controls and the float64
witness; ``--readings edge`` those of the CSR edge kernels at EDGE_SHAPES
for 3 seeds with their bf16-feature control; ``--readings dopri5`` also
K5-bf16's against K5's float32 kernel and the float64 witness;
``--readings k0``, ``k8a`` and ``segment`` those of K0 (KERNEL_SHAPES),
K8a (K8_SHAPES) and K9e (SEGMENT_SHAPES) for 3 seeds with their
controls; ``--readings serving`` (which builds only the serving kernels'
library) those of K1 and K0 at checks.SERVING_EDGE_SHAPES and
SERVING_READING_SHAPES against their plain versions and, with the plain
versions and the bf16-product control, against the float64 witness
(checks.SERVING_WITNESS_RATIO's readings).
``python3 chip_smoke.py --ab-step DIR [DIR ...]`` builds only the serving
kernels' library, with each DIR's ``fused_step.cu`` compiling beside it,
then prints ptxas's registers and spills of every build (and the other
builds' SASS counts), the bits of K1's x_new and ids and K0's x_new at
KERNEL_SHAPES, checks.SERVING_EDGE_SHAPES and the rung-1 operands (phase
4's weights and agents, interval 0) against this checkout, and the
per-launch times of K1 and K0 at the rung-1 operands, in the order DIR...,
this, this, ...DIR.
``python3 chip_smoke.py --ab-train DIR [DIR ...]`` builds only the day
kernels' libraries (``fused_step.cu``, which holds K2f, and
``fused_train.cu``, which holds K2b and the decode CE pair K3f / K3b),
each DIR's beside them, then prints ptxas's registers and spills of every
build, the bits of K2f's xs, K2b's ten outputs, K3f's nll and flags and
K3b's three outputs at DAY_SHAPES (the first: the rung-2 operands of
phases 10 and 13a) and DEPTH_SHAPES against this checkout, and the
per-launch times of K2f, K2b, K3f and K3b at the rung-2 operands in the
order DIR..., this, this, ...DIR, with K2b's tile rows, tiles and CTAs per
build. A DIR written ``DIR+PROBE`` is a copy of DIR's kernel sources with
PROBE's substitutions (PROBES: products, B loads, slab traffic or
``expf`` / ``tanhf`` taken out, K3b's among them; K2b's tile at 4 warps;
K2f's CTAs at 4 warps; for ``--ab-dopri5`` K5's float32 products as adds,
its weights uncopied, one barrier a weight chunk), built under
``build/chip_smoke/variants/``: its results are wrong by design and only
timed.
``python3 chip_smoke.py --ab-k8 DIR [DIR ...]`` runs phases 1-2 and then
compares K8 of this checkout with K8 built from each checkout at DIR:
ptxas and SASS counts of each build, bits at K8_SHAPES and alternating
per-launch times. ``python3 chip_smoke.py --ab-dopri5 DIR [DIR ...]``
does the same for the step K5 (float32 and bf16), the step VJP K7
(float32 and bf16) and the whole backward K6 (bf16 and float32 bodies):
each DIR's ``fused_dopri5.cu`` (``DIR+PROBE`` a probe variant, as for
``--ab-train``) compiles beside phase 2, then ptxas's registers and
spills of both builds, the bits at DOPRI5_SHAPES, and the per-launch
times of K5 (with the controller's error sum) and K7 at phase 19's shape
(rung 3's) and of K6 on the recording of one rung-3 step at its own
settings, in the order DIR..., this, this, ...DIR.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``{"kernels": [...]}`` (for every kernel its launches on the main path,
largest difference from its plain version, times, and ``bound_ms``: the
larger of the bytes it must move over 3.35 TB/s and its operations over
the peak of their type: for the bf16 kernels (K6 and K7-bf16 among them)
their matmul operations over 989 TFLOP/s, the H100's dense bf16 peak; for
the float32 encoder, step VJP and CSR edge kernels their operations over
67 TFLOP/s, its FP32 peak outside the tensor cores; for K5 at float32,
whose products run in 3xTF32 on the tensor cores, three times its
products over 495 TFLOP/s, the dense TF32 peak, plus its elementwise
operations over the FP32 peak (k5_tf32_flops; phase 23 prints its FP32
bound beside it); K0, K8a and K5-bf16 their stage products at the bf16
peak, K9e its bytes), eighteen entries, the line before that the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
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
# --readings serving also reads K1 and K0 at the main path's zones and the
# deepest drift, beside checks.SERVING_EDGE_SHAPES
SERVING_READING_SHAPES = ((4_096, 64, 8), (65_536, 64, 8))


def interval_operands(model, config, n, z, dev, seed=None):
    """The operands of ``rk4_interval_decode_fused`` for a model: random
    states, context and bf16 zones seeded from ``seed`` (``n`` unless
    given), the interval of 0.25 at 6.5 in ``config.substeps`` substeps
    (phase 3's check)."""
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        interval_stage_times,
        pack_weights_bf16,
        time_feature_table,
    )

    g = torch.Generator(device=dev).manual_seed(n if seed is None else seed)
    x = torch.randn(n, config.agent_dim, device=dev, generator=g)
    h = torch.randn(n, config.context_dim, device=dev, generator=g)
    ze = torch.randn(z, config.zone_dim, device=dev, generator=g).bfloat16()
    w = pack_weights_bf16(model)
    wd = model.decode_proj.weight.T.bfloat16()
    stage_t = torch.from_numpy(
        interval_stage_times(6.5, 0.25, config.substeps)).to(dev)
    return (x, h, ze, w, wd, time_feature_table(stage_t, w[3], w[4]), 0.25)


def rung1_operands(model, substeps, graph, agents):
    """The operands the rung-1 rollout gives its kernels at its first
    interval: (K1's for interval 0, K0's for substep 0 of it), from the
    zone graph ``(zone_feats, adj, times)`` and the agents ``(person_feats,
    home_zone)`` on the card."""
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        interval_stage_times,
        pack_weights_bf16,
        time_feature_table,
    )

    dev = graph[0].device
    weights = pack_weights_bf16(model)
    with torch.inference_mode():
        zone_emb = model.encode_zones(*graph[:2])
        x0, h = model.initial_state(*agents, zone_emb)
    t = graph[2].cpu().numpy().astype(np.float32)
    dt = float((t[1] - t[0]) / np.float32(substeps))
    ze = zone_emb.bfloat16()

    def table(n_sub):
        return time_feature_table(torch.from_numpy(
            interval_stage_times(t[0], dt, n_sub)).to(dev), weights[3],
            weights[4])

    return ((x0, h, ze, weights, model.decode_proj.weight.T.bfloat16(),
             table(substeps), dt),
            (x0, h, ze, weights, table(1), dt))


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


def graph_ms(fn, reps):
    """Device milliseconds of one call of ``fn``: the call captured in a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's enqueue (Python, checks, ctypes) is not timed. For calls whose
    device work is shorter than their enqueue, where ``cuda_ms`` times the
    host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


# the H100 SXM's published peaks (700 W): dense bf16 tensor-core rate, FP32
# rate outside the tensor cores and device-memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flop, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for
    ``flop`` operations at ``peak`` (default: bf16 matmul operations)
    moving ``nbytes`` bytes."""
    t_ops, t_bytes = flop / peak, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def device_busy(label, fn, card):
    """One call of ``fn`` (a training step) under torch.profiler: prints the
    device's busy and idle share of its wall time (the sum of the device
    time of its kernels, copies and fills, one stream, over the host clock
    around the synced call) and the device time by kernel name, largest
    first; "not measured" where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (ms + e.self_device_time_total / 1e3,
                              n + e.count)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0:
        print(f"device busy share, {label}: not measured (the profiler "
              f"recorded no device time in a {wall:.3f} ms step) "
              f"[card {card}]", flush=True)
        return
    print(f"device busy share, {label}: {busy:.3f} ms of device time in a "
          f"{wall:.3f} ms step (host clock, profiled): busy {busy / wall:.1%}"
          f", idle {1 - busy / wall:.1%} [card {card}]", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"device time by kernel, {label}: " + "; ".join(
        f"{name[:48]} {ms:.3f} ms x{n}" for name, (ms, n) in top[:10]),
        flush=True)


@contextlib.contextmanager
def state_kept(model, optimizer):
    """The model's parameters and the optimizer's AdamW state put back as
    they were before the block: a profiled step leaves no trace on the
    phases after it."""
    import copy

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    adamw = copy.deepcopy(optimizer.adamw.state_dict())
    try:
        yield
    finally:
        model.load_state_dict(params)
        optimizer.adamw.load_state_dict(adamw)


def kernel_entry(name, source, replaces, launches, max_abs_err, ms,
                 plain_ms, flop, nbytes, peak=PEAK_BF16_FLOPS,
                 library_ms=None):
    """One kernel's entry of the {"kernels": [...]} line. No single PyTorch
    call computes any of the stage kernels' functions (each is a chain of
    products, activations and reductions), so their library_ms is null;
    the segment sum's is ``index_add_``'s."""
    bound_ms, bound_by = bound(flop, nbytes, peak)
    return {"name": name, "route": "cuda",
            "source": f"ananke_abm_tpu_torch/csrc/{source}",
            "replaces": f"ananke_abm_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def compare(kernel_out, plain_out):
    """x_new's (max abs, mean abs, max abs / max |x|) difference and the
    ids' agreement (None for a step, which decodes nothing: ``(x_new,
    None)``)."""
    (xk, ik), (xr, ir) = kernel_out, plain_out
    if not torch.isfinite(xk).all():
        fail("x_new is not finite")
    d = (xk - xr).abs()
    err = d.max().item()
    return {"max": err, "mean": d.mean().item(),
            "rel": err / xr.abs().max().item(),
            "ids": None if ik is None else (ik == ir).float().mean().item()}


def agrees(r):
    return (r["mean"] <= X_MEAN_ATOL and r["rel"] <= X_MAX_RTOL
            and (r["ids"] is None or r["ids"] >= IDS_MIN))


def describe(r):
    return (f"x_new max abs diff {r['max']:.3e}, mean {r['mean']:.3e} "
            f"(<= {X_MEAN_ATOL}), max / max|x| {r['rel']:.3e} "
            f"(<= {X_MAX_RTOL})" + ("" if r["ids"] is None else
                                    f"; ids agree {r['ids']:.6f} (>= "
                                    f"{IDS_MIN})"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--readings", nargs="?", const="training",
                        choices=("training", "encoder", "dopri5", "edge",
                                 "k0", "k8a", "segment", "serving"),
                        help="print the training (or the encoder, the "
                        "DOPRI5 step, the CSR edge, K0, K8a, the segment "
                        "sum or the serving) kernels' readings only")
    parser.add_argument("--ab-k8", metavar="DIR", nargs="+",
                        help="time K8 against K8 of the checkouts at DIR")
    parser.add_argument("--ab-dopri5", metavar="DIR", nargs="+",
                        help="compare and time K5, K6 and K7 against those "
                        "of the checkouts at DIR (DIR+PROBE: a probe "
                        "variant of DIR's sources)")
    parser.add_argument("--ab-step", metavar="DIR", nargs="+",
                        help="compare and time K1 and K0 against those of "
                        "the checkouts at DIR")
    parser.add_argument("--ab-train", metavar="DIR", nargs="+",
                        help="compare and time K2f and K2b against those "
                        "of the checkouts at DIR (DIR+PROBE: a probe "
                        "variant of DIR's sources)")
    args = parser.parse_args()
    t_start = time.perf_counter()
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
    from ananke_abm_tpu_torch.ops.cuda.checks import bf16_product_dot
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        rk4_interval_decode_fused,
        rk4_interval_decode_reference,
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
    # the other checkouts' DOPRI5 or serving kernels compile beside this
    # one's; an A/B of the serving kernels builds only their library
    others = [start_build(ab_checkout(d)[1], f"other{i}", "fused_dopri5")
              for i, d in enumerate(args.ab_dopri5 or ())]
    others += [start_build(Path(d).resolve(), f"other{i}", "fused_step")
               for i, d in enumerate(args.ab_step or ())]
    train_others = []
    for i, d in enumerate(args.ab_train or ()):
        name, checkout = ab_checkout(d)
        train_others.append((name, [start_build(checkout, f"train{i}", lib)
                                    for lib in ("fused_step",
                                                "fused_train")]))
    built = _build.build_all(
        ("fused_step",) if args.ab_step or args.readings == "serving"
        else ("fused_step", "fused_train") if args.ab_train
        else _build.NAMES)
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name, (path, log, seconds) in built.items():
        print(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
        for line in ptxas_lines(log):
            print(f"  {line}")
        if not args.ab_train:  # ab_train loads its own (declare_entries)
            _build.load_library(name)
    sys.stdout.flush()

    if args.readings == "training":
        readings(dev)
        return
    if args.readings == "encoder":
        encoder_readings(dev)
        return
    if args.readings == "dopri5":
        dopri5_readings(dev)
        return
    if args.readings == "edge":
        edge_readings(dev)
        return
    if args.readings == "k0":
        k0_readings(dev)
        return
    if args.readings == "k8a":
        k8a_readings(dev)
        return
    if args.readings == "segment":
        segment_readings(dev)
        return
    if args.readings == "serving":
        serving_readings(dev)
        return
    if args.ab_k8:
        ab_k8(dev, [Path(d) for d in args.ab_k8])
        return
    if args.ab_dopri5:
        ab_dopri5(dev, built["fused_dopri5"][1], others)
        return
    if args.ab_step:
        ab_step(dev, built["fused_step"][1], others)
        return
    if args.ab_train:
        ab_train(dev, built, train_others)
        return

    # ---- 3. kernel against its plain version --------------------------------
    config = GATODEConfig()
    max_err = 0.0
    with torch.inference_mode():
        for n, z, nb in KERNEL_SHAPES:
            model = build_model(dataclasses.replace(config, num_blocks=nb),
                                7, 8, device=dev)
            init_params(model, torch.Generator().manual_seed(nb))
            args = interval_operands(model, config, n, z, dev)
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
    args, step_args = rung1_operands(served_model, config.substeps, graph,
                                     agents)
    with torch.inference_mode():
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
    k1_rate = N_AGENTS / min(walls["kernel"])

    # per agent and interval: read x and h, write x and the id
    k1 = kernel_entry(
        "rk4_interval_decode_fused", "fused_step.cu", "fused_step.py:385",
        launches, max_err, ms, plain_ms, flop,
        N_AGENTS * (4 * (2 * config.agent_dim + config.context_dim) + 4))
    k8, continuous_wall = adjoint_phases(dev, card)
    fixed, rung2 = fixed_step_phases(dev, card)
    k4 = encoder_phases(dev, card, rung2)
    k57, discrete_wall = dopri5_phases(dev, card, continuous_wall)
    k67 = backward_all_phases(dev, card, discrete_wall)
    k9 = edge_phases(dev, card)
    k0 = serving_step_phases(dev, card, served_model, graph, agents, ids,
                             k1_rate, step_args)
    k8a = fused_pair_phases(dev, card)
    k5b = bf16_forward_phases(dev, card)
    k9e = segment_phases(dev, card)
    print(f"smoke: phases 1-38 in {time.perf_counter() - t_start:.1f} s, "
          f"the build included", flush=True)

    print(card)
    print(json.dumps({"kernels": [k1, k8, *fixed, *k4, *k57, *k67, *k9, k0,
                                  k8a, k5b, k9e]}))
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


def stage_flops(da, dz, dc, hidden, num_zones, num_blocks):
    """(forward, VJP) matmul FLOPs per agent of one stage evaluation as the
    function needs them (2*m*k*n per product). The forward's h-row product
    (h @ W1h) is 2*dc*hidden of it. The VJP takes two products per forward
    product, the input's cotangent and the weight's; its h-row terms (gh,
    gW1h) are 4*hidden*dc of it. What a kernel recomputes (the stage
    kernels redo each block's inner activation and the attention scores in
    the VJP) is not the function's work and is not counted."""
    h, z, f = hidden, num_zones, da + dz
    fwd = 2 * (da * dz + 2 * dz * z + f * h + dc * h
               + num_blocks * 2 * h * h + h * da)
    return fwd, 2 * fwd


def drift_vjp_flops(da, dz, dc, hidden, num_zones, num_blocks):
    """Matmul FLOPs per agent of one launch of the adjoint RHS kernel."""
    return sum(stage_flops(da, dz, dc, hidden, num_zones, num_blocks))


def k8_outputs(out):
    """(name, tensor) of every output of drift_rhs_and_vjp."""
    names = ["f", "gx", "gh", "gze", "gtf", "gWq", "gW1xc", "gW1h"]
    items = list(zip(names, out[:8]))
    for i, blk in enumerate(out[8]):
        items += list(zip([f"gWr1[{i}]", f"gbr1[{i}]", f"gWr2[{i}]",
                           f"gbr2[{i}]"], blk))
    return items + [("gW3", out[9]), ("gb3", out[10])]


def worst_of(got, want):
    """Per output ((name, tensor) pairs): mean |d| / mean |ref|, max |d| /
    max |ref|, cosine; the worst of each over the outputs, the largest
    |d|, and the output that set each worst."""
    worst = {"mean": (0.0, ""), "max": (0.0, ""), "cos": (1.0, "")}
    max_abs = 0.0
    for (name, u), (_, v) in zip(got, want):
        u, v = u.float(), v.float()
        if not torch.isfinite(u).all():
            fail(f"kernel output {name} is not finite")
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


def within(worst, bounds):
    mean, mx, one_minus_cos = bounds
    return (worst["mean"][0] <= mean and worst["max"][0] <= mx
            and 1 - worst["cos"][0] <= one_minus_cos)


def describe_worst(worst, bounds):
    mean, mx, one_minus_cos = bounds
    return (f"worst mean|d|/mean|ref| {worst['mean'][0]:.3e} "
            f"({worst['mean'][1]}; <= {mean:.3g}), worst max|d|/max|ref| "
            f"{worst['max'][0]:.3e} ({worst['max'][1]}; <= {mx:.3g}), "
            f"worst 1 - cosine {1 - worst['cos'][0]:.3e} ({worst['cos'][1]}; "
            f"<= {one_minus_cos:.3g})")


def grads_of(model):
    return torch.cat([p.grad.flatten() for p in model.parameters()])


def adjoint_phases(dev, card):
    """Phases 6-9: K8 against its plain version, the trainer at rung 3,
    the kernel trainer against the plain-version trainer, and times.
    Returns K8's entry of the {"kernels": [...]} line and the best wall
    time of a rung-3 training step."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _adjoint_loss_fn,
        build_model,
        init_params,
        make_adjoint_step_fns,
        make_optimizer,
    )
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        bf16_control,
        k8_bounds,
        k8_operands,
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
        worst, err = worst_of(k8_outputs(got), k8_outputs(want))
        max_err = max(max_err, err)
        print(f"adjoint kernel check N={n} Z={z} num_blocks={nb}: "
              f"{describe_worst(worst, k8_bounds(nb))}; max |d| {err:.3e}; "
              f"repeat "
              f"bit-identical", flush=True)
        if not within(worst, k8_bounds(nb)):
            fail(f"adjoint kernel disagrees with its plain version at N={n}")
        if main_args is None:
            main_args = args
    with torch.inference_mode():
        control, _ = worst_of(
            k8_outputs(bf16_control(drift_rhs_and_vjp_reference,
                                    *main_args)),
            k8_outputs(drift_rhs_and_vjp_reference(*main_args)))
    bounds = k8_bounds(K8_SHAPES[0][2])
    print(f"control (bf16-rounded products) at N={K8_SHAPES[0][0]}: "
          f"{describe_worst(control, bounds)}", flush=True)
    if within(control, bounds):
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
    # per agent: read x, h and a, write f, gx and gh; the summed gradients
    da, dc = config.agent_dim, config.context_dim
    nbytes = ADAPT_N * 4 * (5 * da + 2 * dc) + 4 * 92_832
    return kernel_entry("drift_rhs_and_vjp", "fused_rhs.cu",
                        "fused_rhs.py:184", k8_launches, max_err, k8_ms,
                        plain_ms, flop, nbytes), min(walls[1:])

# ---- the fixed-step trainer and its kernels, K2f, K2b, K3f, K3b ------------

# bench rung 2 (bench.py TRAIN_*): 32,768 agents x 500 zones x 12 times
TRAIN_N = 32_768
TRAIN_ZONES = 500
TRAIN_TIMES = 12
TRAIN_SEED = 1  # the data (bench.py's)
# the weights: AdamW's first steps move every weight by about lr, and from
# some initialisations the loss rises before it falls (weight seed 1 on the
# CPU plain versions: 38.30, 44.91, 54.94); from seed 3 it falls by the
# third step (31.21, 32.41, 19.52)
TRAIN_WEIGHT_SEED = 3
FIXED_STEPS = 3
# the kernel trainer against the plain-version trainer: the JAX tests'
# bounds for its fused step against its XLA step (1e-2, 0.999), tightened
# from an H100 reading of 2.2e-5 and 1 - cos 1.7e-9
CHECK_FIXED_AGENTS = 4_096
FIXED_LOSS_RTOL = 1e-3
FIXED_COS_MIN = 0.99999
# (agents, zones, residual blocks, output times) of the kernel checks; the
# first is the main path's shape
DAY_SHAPES = ((32_768, 500, 2, 12), (1_000, 64, 1, 5), (4_096, 2_048, 2, 4))
# deeper drifts, for the readings that set the depth scaling
DEPTH_SHAPES = ((4_096, 64, 4, 5), (4_096, 64, 6, 5), (4_096, 64, 8, 5),
                (200, 64, 8, 3))
# the day kernels against a float64 witness, where few agents and a deep
# drift put kernel and plain version far apart
WITNESS_SHAPES = ((200, 64, 8, 3), (4_096, 64, 8, 5), (1_000, 64, 1, 5))
WITNESS_SEEDS = 6
SUBSTEPS = 2


def day_bwd_outputs(out):
    names = ["gx0", "gh", "gze", "gWq", "gW1xc", "gW1h", "gtfp"]
    items = list(zip(names, out[:7]))
    for i, blk in enumerate(out[7]):
        items += list(zip([f"gWr1[{i}]", f"gbr1[{i}]", f"gWr2[{i}]",
                           f"gbr2[{i}]"], blk))
    return items + [("gW3", out[8]), ("gb3", out[9])]


def check(label, got, want, bounds, control=None, enforce=True,
          control_kind="bf16-rounded products"):
    """Hold ``got`` against ``want`` ((name, tensor) pairs) within
    ``bounds``; the control, where given, must fail the same check.
    Returns the largest |d|. With ``enforce`` off it only reports."""
    worst, err = worst_of(got, want)
    print(f"{label}: {describe_worst(worst, bounds)}; max |d| {err:.3e}",
          flush=True)
    cw = None
    if control is not None:
        cw, _ = worst_of(control, want)
        print(f"{label} control ({control_kind}): "
              f"{describe_worst(cw, bounds)}", flush=True)
    if enforce and not within(worst, bounds):
        fail(f"{label}: the kernel disagrees with its plain version")
    if enforce and cw is not None and within(cw, bounds):
        fail(f"{label}: the check passes the control ({control_kind})")
    return err


def same_bits(a, b):
    return all(torch.equal(u, v) for (_, u), (_, v) in zip(a, b))


def training_operands(dev, n, z, nb, num_times, seed):
    """(model, the day forward's operands, a generator for the rest) of
    the training kernels' checks at one shape: random weights, states and
    zones from ``seed``."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.checks import day_operands

    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=nb)
    model = build_model(config, 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
    fargs = day_operands(model, n, z, num_times, SUBSTEPS, dev, seed=n + seed)
    return model, fargs, torch.Generator(device=dev).manual_seed(n + seed + 1)


def training_kernel_checks(dev, n, z, nb, num_times, seed, control,
                           enforce=True):
    """K2f, K2b, K3f and K3b against their plain versions at one shape
    (random weights, states, zones, cotangents and targets from ``seed``),
    with the bf16-product control where ``control``; K2b and K3b run twice
    and must give the same bits. Returns (the largest |d| of each kernel,
    the four kernels' operands)."""
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        CE_BOUNDS,
        CE_CORRECT_MIN,
        DAY_BWD_BOUNDS,
        DAY_FWD_BOUNDS,
        bf16_control,
        day_bounds,
    )

    model, fargs, g = training_operands(dev, n, z, nb, num_times, seed)
    x0, h, ze, tf, dts, w16 = fargs
    tag = f"N={n} Z={z} num_blocks={nb} T={num_times} seed={seed}"
    fwd_b = day_bounds(DAY_FWD_BOUNDS, nb)
    bwd_b = day_bounds(DAY_BWD_BOUNDS, nb)
    errs = []
    with torch.inference_mode():
        xs = ft.day_forward_fused(*fargs)
        torch.cuda.synchronize()
        xs_ref = ft.day_forward_reference(*fargs)
        ctl = [("xs_all", bf16_control(ft.day_forward_reference, *fargs))] \
            if control else None
        errs.append(check(f"K2f {tag}", [("xs_all", xs)],
                          [("xs_all", xs_ref)], fwd_b, ctl, enforce))
        gxs = torch.randn(xs_ref.shape, device=dev, generator=g)
        bargs = (xs_ref, gxs, h, ze, tf, dts, w16)
        got = day_bwd_outputs(ft.day_backward_fused(*bargs))
        again = day_bwd_outputs(ft.day_backward_fused(*bargs))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"K2b repeat at {tag} is not bit-identical")
        want = day_bwd_outputs(ft.day_backward_reference(*bargs))
        ctl = day_bwd_outputs(bf16_control(ft.day_backward_reference,
                                           *bargs)) if control else None
        errs.append(check(f"K2b {tag} (repeat bit-identical)", got, want,
                          bwd_b, ctl, enforce))
        rows = xs_ref[::SUBSTEPS].transpose(0, 1).reshape(
            -1, model.agent_dim).contiguous()
        tgt = torch.randint(0, z, (rows.shape[0],), device=dev, generator=g,
                            dtype=torch.int32)
        cargs = (rows, tgt, model.decode_proj.weight.T.bfloat16(), ze)
        nll, corr = ft.ce_forward_fused(*cargs)
        torch.cuda.synchronize()
        nll_ref, corr_ref = ft.ce_forward_reference(*cargs)
        agree = (corr == corr_ref).float().mean().item()
        ctl = [("nll", bf16_control(ft.ce_forward_reference, *cargs)[0])] \
            if control else None
        errs.append(check(
            f"K3f M={rows.shape[0]} Z={z} seed={seed} (correct agree "
            f"{agree:.6f} >= {CE_CORRECT_MIN})", [("nll", nll)],
            [("nll", nll_ref)], CE_BOUNDS, ctl, enforce))
        if enforce and agree < CE_CORRECT_MIN:
            fail(f"K3f correct flags disagree at {tag}")
        gnll = torch.rand(rows.shape[0], device=dev, generator=g) / (
            rows.shape[0])
        bcargs = (*cargs, gnll)
        names = ("gx", "gWd", "gze")
        got = list(zip(names, ft.ce_backward_fused(*bcargs)))
        again = list(zip(names, ft.ce_backward_fused(*bcargs)))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"K3b repeat at {tag} is not bit-identical")
        want = list(zip(names, ft.ce_backward_reference(*bcargs)))
        ctl = list(zip(names, bf16_control(ft.ce_backward_reference,
                                           *bcargs))) if control else None
        errs.append(check(
            f"K3b M={rows.shape[0]} Z={z} seed={seed} (repeat "
            "bit-identical)", got, want, CE_BOUNDS, ctl, enforce))
    return errs, (fargs, bargs, cargs, bcargs)


def readings(dev):
    """``--readings``: the four training kernels against their plain
    versions and the bf16-product control at every shape of DAY_SHAPES and
    DEPTH_SHAPES for seeds 0-2, printed against the bounds, then the day
    kernels' float64 witness readings; nothing fails on a bound."""
    for seed in range(3):
        for n, z, nb, num_times in DAY_SHAPES + DEPTH_SHAPES:
            training_kernel_checks(dev, n, z, nb, num_times, seed,
                                   control=True, enforce=False)
    for n, z, nb, num_times in WITNESS_SHAPES:
        for seed in range(WITNESS_SEEDS):
            witness_readings(dev, n, z, nb, num_times, seed)


def describe_far(worst):
    return (f"mean {worst['mean'][0]:.3e} ({worst['mean'][1]}), max "
            f"{worst['max'][0]:.3e} ({worst['max'][1]}), 1 - cos "
            f"{1 - worst['cos'][0]:.3e} ({worst['cos'][1]})")


def witness_readings(dev, n, z, nb, num_times, seed):
    """K2f's and K2b's kernel, plain version and bf16-product control,
    each against the float64 witness (the plain version with its products
    and all after them in float64) on the operands of
    ``training_kernel_checks`` at the same shape and seed."""
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        bf16_control,
        float64_witness,
    )

    _, fargs, g = training_operands(dev, n, z, nb, num_times, seed)
    tag = f"N={n} Z={z} num_blocks={nb} T={num_times} seed={seed}"
    with torch.inference_mode():
        xs_ref = ft.day_forward_reference(*fargs)
        gxs = torch.randn(xs_ref.shape, device=dev, generator=g)
        bargs = (xs_ref, gxs, *fargs[1:])
        for label, fn, args, out in (
                ("K2f", "day_forward", fargs, lambda o: [("xs_all", o)]),
                ("K2b", "day_backward", bargs, day_bwd_outputs)):
            kernel, plain = (getattr(ft, f"{fn}_fused"),
                             getattr(ft, f"{fn}_reference"))
            want = out(float64_witness(plain, *args))
            far = {side: worst_of(out(f(*args)), want)[0] for side, f in (
                ("kernel", kernel), ("plain", plain),
                ("control", lambda *a: bf16_control(plain, *a)))}
            ratio = far["kernel"]["mean"][0] / far["plain"]["mean"][0]
            print(f"{label} {tag} against the float64 witness: "
                  + "; ".join(f"{side} {describe_far(w)}"
                              for side, w in far.items())
                  + f"; kernel / plain worst mean {ratio:.3f}", flush=True)


def ptxas_lines(log):
    """One line per kernel of an nvcc -Xptxas -v log: its name (demangled
    where c++filt is at hand, without its parameter list), registers and
    spill stores and loads; then one line per device function a kernel
    calls (its spills, "called")."""
    import re

    rows, called, name, prop, spill = [], {}, None, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            prop = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            text = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
            if prop == name:
                spill = text
            elif prop:
                called[prop] = text
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, f"{m.group(1)} registers, {spill}"])
            name, spill = None, ""
    rows += [[n, f"called: {text}"] for n, text in called.items()]
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout
        for r, d in zip(rows, out.splitlines()):
            r[0] = d.replace("(anonymous namespace)::", "").split("(")[0]
    return [f"{n}: {rest}" for n, rest in rows]


def start_build(checkout, name, lib):
    """Start nvcc on ``checkout``'s ``csrc/<lib>.cu`` (with its own
    headers) with the port's flags, into ``OUT/ab/<name>-<lib>.so``; the
    handle goes to :func:`finish_build`."""
    from ananke_abm_tpu_torch.ops.cuda import _build

    path = OUT / "ab" / f"{name}-{lib}.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    src = checkout / "ananke_abm_tpu_torch" / "csrc" / f"{lib}.cu"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             str(path), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path, src, name, lib


def finish_build(handle, sass=False):
    """Wait for a :func:`start_build`, print ptxas's registers and spills
    per kernel (and, with ``sass``, the kernels' SASS opcode counts) and
    load the library with the port's C interface."""
    import ctypes
    import re

    from ananke_abm_tpu_torch.ops.cuda import _build

    proc, path, src, name, lib = handle
    log, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"nvcc failed on {src}:\n{log}")
    print(f"build [{name}]: {src}")
    for line in ptxas_lines(log):
        print(f"  {line}")
    if sass:
        cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
        out = subprocess.run([str(cuobjdump), "-sass", str(path)],
                             capture_output=True, text=True,
                             timeout=300).stdout
        op = re.compile(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
        for fn in re.split(r"\n\s*Function : ", out)[1:]:
            ops = {}
            for m in op.finditer(fn):
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            keys = ("HMMA", "LDS", "STS", "LDSM", "LDG", "STG", "LDL", "STL",
                    "BAR", "SHFL", "MUFU")
            print(f"  sass {fn.split(chr(10), 1)[0][:60]}: "
                  f"{sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {ops.get(k, 0)}" for k in keys))
    so = declare_entries(ctypes.CDLL(str(path)))
    so.ananke_cuda_error_string.argtypes = [ctypes.c_int]
    so.ananke_cuda_error_string.restype = ctypes.c_char_p
    return so


def declare_entries(so):
    """``so`` with the argument and result types of every entry of the
    port's C interface it exports: another checkout's library may hold an
    entry that this checkout's holds in another."""
    from ananke_abm_tpu_torch.ops.cuda import _build

    for entries in _build._ENTRY.values():
        for entry, (argtypes, restype) in entries.items():
            if hasattr(so, entry):
                getattr(so, entry).argtypes = argtypes
                getattr(so, entry).restype = restype
    return so


@contextlib.contextmanager
def library_of(lib, so):
    """The port's wrappers launch from ``so`` (a build of another checkout's
    ``csrc/<lib>.cu``) inside the block."""
    from ananke_abm_tpu_torch.ops.cuda import _build

    load = _build.load_library
    _build.load_library = lambda name: so if name == lib else load(name)
    try:
        yield
    finally:
        _build.load_library = load


def build_k8(checkout, name):
    """``checkout``'s K8 library (``csrc/fused_rhs.cu``), with ptxas's and
    the SASS counts printed."""
    return finish_build(start_build(checkout, name, "fused_rhs"), sass=True)


def ab_k8(dev, others):
    """``--ab-k8 DIR [DIR ...]``: K8 of this checkout against K8 of each
    checkout at DIR (its ``csrc/fused_rhs.cu`` and headers, the same flags
    and C interface): the bits at every shape of K8_SHAPES, then the
    per-launch time at the main path's shape in the order DIR..., this,
    this, ...DIR."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.checks import k8_operands
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import drift_rhs_and_vjp

    libs = {"this": build_k8(ROOT, "this")}
    for i, other in enumerate(others):
        libs[str(other)] = build_k8(other, f"other{i}")

    def run(which, args):
        with library_of("fused_rhs", libs[which]):
            return drift_rhs_and_vjp(*args)

    config = GATODEConfig(method="dopri5")
    main_args = None
    for n, z, nb in K8_SHAPES:
        model = build_model(dataclasses.replace(config, num_blocks=nb), 7, 8,
                            device=dev)
        init_params(model, torch.Generator().manual_seed(nb))
        args = k8_operands(model, n, z, dev, seed=n)
        main_args = main_args or args
        with torch.inference_mode():
            out = {w: k8_outputs(run(w, args)) for w in libs}
        for w in others:
            a, b = out["this"], out[str(w)]
            same = all(torch.equal(u, v) for (_, u), (_, v) in zip(a, b))
            diff = max((u - v).abs().max().item()
                       for (_, u), (_, v) in zip(a, b))
            print(f"K8 A/B N={n} Z={z} num_blocks={nb}: this against {w}: "
                  f"same bits {same} (max |d| {diff:.3e})", flush=True)
    times = {w: [] for w in libs}
    order = [str(w) for w in others]
    with torch.inference_mode():
        for w in order + ["this", "this"] + order[::-1]:
            times[w].append(cuda_ms(lambda: run(w, main_args), 20))
    for w, t in times.items():
        print(f"K8 A/B at N={K8_SHAPES[0][0]} Z={K8_SHAPES[0][1]}: {w} "
              f"{', '.join(f'{m:.3f}' for m in t)} ms per launch",
              flush=True)


def ab_dopri5(dev, this_log, handles):
    """``--ab-dopri5 DIR [DIR ...]``: the step K5 (float32 and bf16), the
    step VJP K7 (float32 and bf16) and the whole backward K6 (bf16 and
    float32 bodies) of this checkout against those of each checkout at DIR
    (``DIR+PROBE`` a probe variant, :data:`PROBES`; its
    ``csrc/fused_dopri5.cu`` and headers, built with the port's flags and C
    interface; ``handles`` from :func:`start_build`, started before phase
    2): ptxas's registers and spills per kernel, the bits at every shape of
    DOPRI5_SHAPES, then the per-launch times at the main path's operands
    (K6 on the recording of a rung-3 step at its own settings; K5 and K7 at
    phase 19's shape, which is rung 3's: 98,304 agents, Z = 64, 2 blocks;
    K5 with the error sum the controller reads) in the order DIR..., this,
    this, ...DIR."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import _build
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        K6_RECORD,
        dopri5_backward_operands,
        dopri5_operands,
        dopri5_step_outputs,
        dopri5_vjp_outputs,
    )

    print(f"build [this]: {ROOT / 'ananke_abm_tpu_torch/csrc/fused_dopri5.cu'}")
    for line in ptxas_lines(this_log):
        print(f"  {line}")
    libs = {"this": _build.load_library("fused_dopri5")}
    for h in handles:
        libs[str(h[2].parents[2])] = finish_build(h)
    others = [w for w in libs if w != "this"]

    def run(which, fn, *a, **kw):
        with library_of("fused_dopri5", libs[which]):
            return fn(*a, **kw)

    vjp, bwd = fd.dopri5_step_vjp_fused, fd.dopri5_backward_fused
    step = fd.dopri5_step_fused
    with torch.no_grad():
        for n, z, nb in DOPRI5_SHAPES:
            model = build_model(GATODEConfig(num_blocks=nb), 7, 8, device=dev)
            init_params(model, torch.Generator().manual_seed(nb))
            args, cot = dopri5_operands(model, n, z, dev, seed=n)
            cases = [("K5 f32", step, args, "f32"),
                     ("K5 bf16", step, args, "bf16"),
                     ("K7 f32", vjp, args + cot, "f32"),
                     ("K7 bf16", vjp, args + cot, "bf16")]
            for dt in (torch.bfloat16, torch.float32):
                bargs = dopri5_backward_operands(model, n, z, dev, n,
                                                 *K6_RECORD, ckpt_dtype=dt)
                cases += [(f"K6 {p} checkpoints {str(dt)[6:]}", bwd, bargs, p)
                          for p in ("bf16", "f32")]
            for label, fn, a, prec in cases:
                outputs = (dopri5_step_outputs if fn is step
                           else dopri5_vjp_outputs)
                out = {w: outputs(run(w, fn, *a, precision=prec))
                       for w in libs}
                for w in others:
                    x, y = out["this"], out[w]
                    same = same_bits(x, y)
                    diff = max((u - v).abs().max().item()
                               for (_, u), (_, v) in zip(x, y))
                    print(f"{label} A/B N={n} Z={z} num_blocks={nb}: this "
                          f"against {w}: same bits {same} (max |d| "
                          f"{diff:.3e})", flush=True)
                del out
    model, a, n_acc = rung3_recording(dev)
    args, cot = dopri5_operands(model, ADAPT_N, ADAPT_ZONES, dev, seed=1)
    pk = {p: fd.pack_operands(args[3], *args[5:11], precision=p)
          for p in ("f32", "bf16")}
    kpk = {p: fd.pack_operands(a[3], *a[11:], precision=p)
           for p in ("f32", "bf16")}
    err_stats = {"err_stats": (1e-5, 1e-5)}
    timed = [("K5 f32 at phase 19's shape", step, args, "f32", pk, 5,
              err_stats),
             ("K5 bf16 at rung 3's shape", step, args, "bf16", pk, 5,
              err_stats),
             (f"K6 bf16 on rung 3's recording ({n_acc} steps)", bwd, a,
              "bf16", kpk, 2),
             (f"K6 f32 on rung 3's recording ({n_acc} steps)", bwd, a, "f32",
              kpk, 2),
             ("K7 f32 at phase 19's shape", vjp, args + cot, "f32", pk, 5),
             ("K7 bf16 at rung 3's shape", vjp, args + cot, "bf16", pk, 5)]
    card = card_line()
    order = others + ["this", "this"] + others[::-1]
    with torch.no_grad():
        for label, fn, fa, prec, packs, reps, *kw in timed:
            kw = kw[0] if kw else {}
            times = {w: [] for w in libs}
            for w in order:
                times[w].append(cuda_ms(lambda: run(
                    w, fn, *fa, precision=prec, packed=packs[prec], **kw),
                    reps))
            print(f"{label} (N={ADAPT_N}, Z={ADAPT_ZONES}) A/B: "
                  + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                              for w, t in times.items())
                  + f" ms per launch [card {card}]", flush=True)


# Probes of ``--ab-train`` and ``--ab-dopri5``: a DIR written ``DIR+NAME``
# is DIR's ``ananke_abm_tpu_torch/csrc`` with NAME's substitutions (file,
# regular expression, replacement; each must match), built under
# ``OUT/variants/``. Each takes one cost out of the day kernels and the
# decode CE pair (of the stage code on csrc/drift_stage.cuh, K2b before it
# moved to stage_sm90.cuh, unless named) or out of the float32 DOPRI5 step
# K5 (``nofma``, ``constw``, ``onebar`` and ``nomath``: fused_dopri5.cu's
# ``mm``, K5's products before its redesign, which K7's and K6's float32
# body share); the results are wrong by design and only timed.
PROBES = {
    # no products: each mma.sync becomes one add that keeps its operands
    # (and the loads behind them) live
    "noproducts": [("mma_bf16.cuh",
                    r"(?s)asm volatile\(\s*\"mma\.sync.*?\"r\"\(b1\)\);",
                    "d[0] += __uint_as_float((a[0] ^ a[3] ^ b0 ^ b1) & "
                    "0x007fffffu);")],
    # the B fragments (and biases) read from device memory come from a
    # constant of their address instead
    "constb": [("mma_bf16.cuh",
                r"return __ldg\(reinterpret_cast<const unsigned int\*>"
                r"\(p\)\);",
                "return (uint32_t)reinterpret_cast<uintptr_t>(p) & "
                "0x3f803f80u;")],
    # no slab traffic: the gradient sums are neither read nor written
    "noslab": [("drift_stage.cuh", r"\*p = first \? v : \*p \+ v;",
                "if (v == 1.2345e-30f) *p = v;"),
               ("stage_sm90.cuh",
                r"(v[ab]) \? \*reinterpret_cast<const float2\*>"
                r"\(out \+ m[ab] \* N \+ c\) : z2", "z2"),
               ("stage_sm90.cuh",
                r"if \((v[ab])\)(\s*)\*reinterpret_cast<float2\*>\(out",
                r"if (\1 && acc[j][0] == 1.2345e-30f)\2"
                r"*reinterpret_cast<float2*>(out")],
    # no expf / tanhf: the identity in their place
    "nomath": [("mma_bf16.cuh", r"namespace ananke \{",
                "namespace ananke {\n__device__ __forceinline__ float "
                "probe_id(float x) { return x; }"),
               ("drift_stage.cuh", r"\b(expf|tanhf)\(", "probe_id("),
               ("stage_sm90.cuh", r"\b(expf|tanhf)\(", "probe_id("),
               ("fused_train.cu", r"\b(expf|tanhf)\(", "probe_id("),
               ("fused_dopri5.cu", r"\b(expf|tanhf)\(",
                "ananke::probe_id(")],
    # fused_dopri5.cu's float32 products: each fmaf of mm one add that
    # keeps both operands live
    "nofma": [("fused_dopri5.cu",
               r"acc\[i\]\[j\] = fmaf\(comp\(a\[i\], q\), b\[j\], "
               r"acc\[i\]\[j\]\);",
               "acc[i][j] += __uint_as_float((__float_as_uint(comp(a[i], q))"
               " ^ __float_as_uint(b[j])) & 0x007fffffu);")],
    # mm's weights from whatever the staging buffer holds: no cp.async copy
    # from L2
    "constw": [("fused_dopri5.cu",
                r"cp_async16\(dst \+ e, W \+ \(size_t\)\(c \* KC \+ kk\) "
                r"\* ldw \+ n\);", "(void)kk; (void)n;")],
    # K5's 3xTF32 products (its redesign): each mma.sync one add that keeps
    # its operands live
    "nomma": [("fused_dopri5.cu",
               r"(?s)asm\(\"mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32.*?"
               r"\"r\"\(b1\)\);",
               "d[0] += __uint_as_float((a[0] ^ a[3] ^ b0 ^ b1) & "
               "0x007fffffu);")],
    # K5's weight ring without its cp.async copies
    "nocopy": [("fused_dopri5.cu",
                r"cp_async16\(dst \+ r \* ds \+ 4 \* k, src \+ \(size_t\)r \* "
                r"ss \+ 4 \* k\);", "(void)src;")],
    # mm with one block barrier a weight chunk where it takes two (the
    # barrier before the epilogue kept): races by design
    "onebar": [("fused_dopri5.cu",
                r"__syncthreads\(\);\n  \}\n  ep\(acc\);",
                "}\n  __syncthreads();\n  ep(acc);")],
    # K2b's tile at 4 warps (64 rows) where it takes 6
    "w4": [("fused_train.cu", r"return nb <= 2 \? 6 : nb <= 5 \? 4 : 2;",
            "return nb <= 5 ? 4 : 2;")],
    # K2f in CTAs of one warpgroup, 3 an SM, where it takes 12 warps, 1
    "f4": [("fused_step.cu", r"__launch_bounds__\(32 \* W\)",
            "__launch_bounds__(32 * W, kWarps / W)"),
           ("fused_step.cu", r"launch<false, true>\(",
            "launch<false, true, 4>(")],
}


def ab_checkout(arg):
    """(a name, the checkout) of an ``--ab-train`` DIR: DIR itself, or for
    ``DIR+NAME`` a copy of DIR's kernel sources with probe NAME's
    substitutions under ``OUT/variants/``."""
    import re

    base, _, probe = str(arg).partition("+")
    base = Path(base).resolve()
    if not probe:
        return str(base), base
    if probe not in PROBES:
        fail(f"unknown probe {probe!r}: one of {sorted(PROBES)}")
    root = OUT / "variants" / f"{base.name}+{probe}"
    csrc = root / "ananke_abm_tpu_torch" / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(base / "ananke_abm_tpu_torch" / "csrc", csrc)
    for fname, pattern, repl in PROBES[probe]:
        path = csrc / fname
        text, n = re.subn(pattern, repl, path.read_text())
        if n == 0:
            fail(f"probe {probe}: no match of {pattern!r} in {path}")
        path.write_text(text)
    return f"{base}+{probe}", root


def ab_train(dev, built, handles):
    """``--ab-train DIR [DIR ...]``: the day kernels K2f and K2b and the
    decode CE pair K3f and K3b of this checkout against those of each
    checkout at DIR (``DIR+PROBE`` a probe variant, :data:`PROBES`; its
    ``fused_train.cu`` and ``fused_step.cu`` and headers, built with the
    port's flags and C interface; ``handles`` from :func:`start_build`,
    started before phase 2, two a DIR): ptxas's registers and spills per
    kernel, the bits of K2f's xs, K2b's ten outputs, K3f's nll and correct
    flags and K3b's three outputs at every shape of DAY_SHAPES and
    DEPTH_SHAPES (the first of DAY_SHAPES: the rung-2 operands of phases
    10 and 13a), then per-launch times of the four at the rung-2 operands
    in the order DIR..., this, this, ...DIR, beside K2b's tile rows, tiles
    and CTAs."""
    import ctypes

    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import NUM_SLABS

    for lib in ("fused_step", "fused_train"):
        print(f"build [this]: "
              f"{ROOT / 'ananke_abm_tpu_torch/csrc' / (lib + '.cu')}")
        for line in ptxas_lines(built[lib][1]):
            print(f"  {line}")
    libs = {"this": {lib: declare_entries(ctypes.CDLL(str(built[lib][0])))
                     for lib in ("fused_step", "fused_train")}}
    for so in libs["this"].values():
        so.ananke_cuda_error_string.argtypes = [ctypes.c_int]
        so.ananke_cuda_error_string.restype = ctypes.c_char_p
    for name, hs in handles:
        libs[name] = {h[4]: finish_build(h) for h in hs}
    for pair in libs.values():
        # K2f: in the serving kernels' library, or (before it moved there)
        # beside K2b
        pair["fused_step"] = next(
            so for so in (pair["fused_step"], pair["fused_train"])
            if hasattr(so, "ananke_day_forward"))
    others = [w for w in libs if w != "this"]

    def run(which, fn, args):
        with library_of("fused_step", libs[which]["fused_step"]), \
                library_of("fused_train", libs[which]["fused_train"]):
            return fn(*args)

    def max_d(a, b):
        return max((u - v).abs().max().item() for (_, u), (_, v) in zip(a, b))

    main = None
    with torch.inference_mode():
        for n, z, nb, num_times in DAY_SHAPES + DEPTH_SHAPES:
            model, fargs, g = training_operands(dev, n, z, nb, num_times, 0)
            xs_ref = ft.day_forward_reference(*fargs)
            gxs = torch.randn(xs_ref.shape, device=dev, generator=g)
            bargs = (xs_ref, gxs, *fargs[1:])
            # the decode CE pair on the day's carries, as phase 10 builds
            # its operands
            rows = xs_ref[::SUBSTEPS].transpose(0, 1).reshape(
                -1, model.agent_dim).contiguous()
            tgt = torch.randint(0, z, (rows.shape[0],), device=dev,
                                generator=g, dtype=torch.int32)
            cargs = (rows, tgt, model.decode_proj.weight.T.bfloat16(),
                     fargs[2])
            gnll = torch.rand(rows.shape[0], device=dev, generator=g) / (
                rows.shape[0])
            bcargs = (*cargs, gnll)
            main = main or (fargs, bargs, cargs, bcargs)
            xs = {w: run(w, ft.day_forward_fused, fargs) for w in libs}
            gr = {w: day_bwd_outputs(run(w, ft.day_backward_fused, bargs))
                  for w in libs}
            cf = {w: list(zip(("nll", "correct"),
                              run(w, ft.ce_forward_fused, cargs)))
                  for w in libs}
            cb = {w: list(zip(("gx", "gWd", "gze"),
                              run(w, ft.ce_backward_fused, bcargs)))
                  for w in libs}
            torch.cuda.synchronize()
            for w in others:
                print(f"K2f / K2b A/B N={n} Z={z} num_blocks={nb} "
                      f"T={num_times}: this against {w}: K2f xs same bits "
                      f"{torch.equal(xs['this'], xs[w])} (max |d| "
                      f"{(xs['this'] - xs[w]).abs().max().item():.3e}); K2b "
                      f"same bits {same_bits(gr['this'], gr[w])} (max |d| "
                      f"{max_d(gr['this'], gr[w]):.3e}); K3f same bits "
                      f"{same_bits(cf['this'], cf[w])} (max |d| "
                      f"{max_d(cf['this'][:1], cf[w][:1]):.3e}); K3b same "
                      f"bits {same_bits(cb['this'], cb[w])} (max |d| "
                      f"{max_d(cb['this'], cb[w]):.3e})", flush=True)
            del xs, gr, cf, cb
    card = card_line()
    order = others + ["this", "this"] + others[::-1]
    n, z, nb, num_times = DAY_SHAPES[0]
    with torch.inference_mode():
        for label, fn, args, reps in (("K2f", ft.day_forward_fused,
                                       main[0], 5),
                                      ("K2b", ft.day_backward_fused,
                                       main[1], 3),
                                      ("K3f", ft.ce_forward_fused,
                                       main[2], 10),
                                      ("K3b", ft.ce_backward_fused,
                                       main[3], 10)):
            times = {w: [] for w in libs}
            for w in order:
                times[w].append(cuda_ms(lambda: run(w, fn, args), reps))
            print(f"{label} at the rung-2 operands (N={n}, Z={z}, "
                  f"num_blocks={nb}, T={num_times}) A/B: "
                  + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                              for w, t in times.items())
                  + f" ms per launch [card {card}]", flush=True)
    for w in libs:
        rows = libs[w]["fused_train"].ananke_day_bwd_tile_rows(nb)
        tiles = -(-n // rows)
        print(f"K2b [{w}] at N={n}: tiles of {rows} rows, {tiles} tiles on "
              f"{min(NUM_SLABS, tiles)} CTAs", flush=True)


def serving_readings(dev):
    """``--readings serving``: K1 and K0 at checks.SERVING_EDGE_SHAPES and
    SERVING_READING_SHAPES, for seeds 0-2: each
    against its plain version (mean |d|, max |d| / max |ref|), and the
    kernel, the plain version and the bf16-product control each against the
    float64 witness (mean |d|); then, past 2 blocks, the largest ratio of
    the kernel's witness distance to the plain version's and the smallest
    of the control's (checks.SERVING_WITNESS_RATIO lies between). Nothing
    fails on a bound."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        SERVING_EDGE_SHAPES,
        bf16_control,
        float64_witness,
    )

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def mean_d(a, b):
        return (a.double() - b.double()).abs().mean().item()

    config = GATODEConfig()
    deep = {"K1": [], "K0": []}
    with torch.inference_mode():
        for seed in range(3):
            for n, z, nb in SERVING_EDGE_SHAPES + SERVING_READING_SHAPES:
                model = build_model(dataclasses.replace(config, num_blocks=nb),
                                    7, 8, device=dev)
                init_params(model,
                            torch.Generator().manual_seed(nb + 10 * seed))
                a1 = interval_operands(model, config, n, z, dev, n + seed)
                a0 = (*a1[:4], a1[5][:4].contiguous(), 0.125)
                for name, kern, ref, args in (
                        ("K1", fs.rk4_interval_decode_fused,
                         fs.rk4_interval_decode_reference, a1),
                        ("K0", fs.rk4_step_fused, fs.rk4_step_reference, a0)):
                    got, plain = first(kern(*args)), first(ref(*args))
                    control = first(bf16_control(ref, *args))
                    witness = first(float64_witness(ref, *args))
                    d = (got - plain).abs()
                    kw, pw, cw = (mean_d(t, witness)
                                  for t in (got, plain, control))
                    print(f"{name} N={n} Z={z} num_blocks={nb} seed={seed}: "
                          f"against the plain version mean "
                          f"{d.mean().item():.3e}, max / max|ref| "
                          f"{d.max().item() / plain.abs().max().item():.3e};"
                          f" against the float64 witness: kernel {kw:.3e},"
                          f" plain {pw:.3e}, control {cw:.3e}", flush=True)
                    if nb > 2:
                        deep[name].append((kw / pw, cw / pw))
    for name, r in deep.items():
        print(f"{name} past 2 blocks: kernel / plain witness distance <= "
              f"{max(k for k, _ in r):.3f}, control / plain >= "
              f"{min(c for _, c in r):.3f} [card {card_line()}]", flush=True)


def ab_step(dev, this_log, handles):
    """``--ab-step DIR [DIR ...]``: the serving kernels K1 and K0 of this
    checkout against those of each checkout at DIR (its
    ``csrc/fused_step.cu`` and headers, built with the port's flags and C
    interface; ``handles`` from :func:`start_build`, started before phase
    2): ptxas's registers and spills per kernel, the bits of x_new and the
    ids at every shape of KERNEL_SHAPES and checks.SERVING_EDGE_SHAPES and
    at the rung-1 operands, then the
    per-launch times of K1 and K0 at the rung-1 operands in the order
    DIR..., this, this, ...DIR."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import _build
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs
    from ananke_abm_tpu_torch.ops.cuda.checks import SERVING_EDGE_SHAPES

    print(f"build [this]: {ROOT / 'ananke_abm_tpu_torch/csrc/fused_step.cu'}")
    for line in ptxas_lines(this_log):
        print(f"  {line}")
    libs = {"this": _build.load_library("fused_step")}
    for h in handles:
        libs[str(h[2].parents[2])] = finish_build(h, sass=True)
    others = [w for w in libs if w != "this"]

    def run(which, fn, args):
        with library_of("fused_step", libs[which]):
            return fn(*args)

    config = GATODEConfig()
    cases = []
    for n, z, nb in KERNEL_SHAPES + SERVING_EDGE_SHAPES:
        model = build_model(dataclasses.replace(config, num_blocks=nb), 7, 8,
                            device=dev)
        init_params(model, torch.Generator().manual_seed(nb))
        cases.append((f"N={n} Z={z} num_blocks={nb}",
                      interval_operands(model, config, n, z, dev),
                      step_operands(model, n, z, dev, n)))
    # the rung-1 operands: phase 4's weights and agents, interval 0
    data = generate_agent_population(N_AGENTS, num_times=NUM_TIMES,
                                     seed=AGENT_SEED, num_zones=NUM_ZONES,
                                     world_seed=WORLD_SEED)
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    graph = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    agents = (on(data["person_feats"]), on(data["home_zone"], torch.long))
    main = rung1_operands(model, config.substeps, graph, agents)
    cases.append((f"at the rung-1 operands (N={N_AGENTS}, Z={NUM_ZONES})",
                  *main))
    del data
    with torch.inference_mode():
        for label, a1, a0 in cases:
            out = {w: (*run(w, fs.rk4_interval_decode_fused, a1),
                       run(w, fs.rk4_step_fused, a0)) for w in libs}
            torch.cuda.synchronize()
            for w in others:
                (x1, i1, x0), (y1, j1, y0) = out["this"], out[w]
                print(f"K1 A/B {label}: this against {w}: x_new same bits "
                      f"{torch.equal(x1, y1)} (max |d| "
                      f"{(x1 - y1).abs().max().item():.3e}), ids same "
                      f"{torch.equal(i1, j1)} (agree "
                      f"{(i1 == j1).float().mean().item():.6f}); K0 x_new "
                      f"same bits {torch.equal(x0, y0)} (max |d| "
                      f"{(x0 - y0).abs().max().item():.3e})", flush=True)
            del out
    card = card_line()
    order = others + ["this", "this"] + others[::-1]
    with torch.inference_mode():
        for name, fn, args in (("K1", fs.rk4_interval_decode_fused, main[0]),
                               ("K0", fs.rk4_step_fused, main[1])):
            times = {w: [] for w in libs}
            for w in order:
                times[w].append(cuda_ms(lambda: run(w, fn, args), 10))
            print(f"{name} at the rung-1 operands (N={N_AGENTS}, "
                  f"Z={NUM_ZONES}) A/B: "
                  + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                              for w, t in times.items())
                  + f" ms per launch [card {card}]", flush=True)


def fixed_step_phases(dev, card):
    """Phases 10-13: K2f, K2b, K3f and K3b against their plain versions,
    the fixed-step trainer at rung 2, the kernel trainer against the
    plain-version trainer, and times. Returns the four kernels' entries of
    the {"kernels": [...]} line and (model, config, static, batch,
    optimizer) of the rung-2 trainer."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_fused_loss_fn,
        build_model,
        init_params,
        make_fused_train_step,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft

    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused)
    encoder = (fg.gat_forward_fused, fg.gat_backward_fused)
    plains = (ft.day_forward_reference, ft.day_backward_reference,
              ft.ce_forward_reference, ft.ce_backward_reference)
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)

    # ---- 10. the four kernels against their plain versions ---------------
    errs = [0.0] * 4
    main = None
    for n, z, nb, num_times in DAY_SHAPES:
        e, operands = training_kernel_checks(dev, n, z, nb, num_times,
                                             seed=0, control=main is None)
        errs = [max(a, b) for a, b in zip(errs, e)]
        main = main or operands

    # ---- 13a. per-launch times at rung 2 (before the trainer, for its
    # kernel share) --------------------------------------------------------
    with torch.inference_mode():
        ms = [cuda_ms(lambda k=k, a=a: k(*a), 5)
              for k, a in zip(kernels, main)]
        plain_ms = [cuda_ms(lambda p=p, a=a: p(*a), 1)
                    for p, a in zip(plains, main)]

    # ---- 11. the fixed-step trainer at bench rung 2 -----------------------
    data = generate_agent_population(TRAIN_N, num_times=TRAIN_TIMES,
                                     seed=TRAIN_SEED, num_zones=TRAIN_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(TRAIN_WEIGHT_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    # optax.adamw(1e-3) as bench.py uses it: betas (0.9, 0.999), eps 1e-8,
    # decoupled weight decay 1e-4
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    step, _ = make_fused_train_step(model, opt, config, static)
    losses, walls = [], []
    for k in kernels + encoder:
        k.launches = 0
    for i in range(FIXED_STEPS):
        before = [k.launches for k in kernels + encoder]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        loss, acc = step(*batch)
        end.record()
        loss = loss.item()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end) / 1e3
        launched = [k.launches - b for k, b in zip(kernels + encoder,
                                                    before)]
        share = sum(ms) / 1e3 / wall
        print(f"fixed train step {i + 1}: loss {loss:.6f} acc "
              f"{acc.item():.4f}, wall {wall:.4f} s (CUDA events); launches "
              f"K2f/K2b/K3f/K3b/K4f/K4b {launched}; day and cross-entropy "
              f"kernel share {share:.1%} "
              f"({' + '.join(f'{m:.3f}' for m in ms)} ms) [card {card}]",
              flush=True)
        if launched != [1] * 6:
            fail(f"fixed step {i + 1} launched the kernels {launched} times, "
                 "expected once each")
        losses.append(loss)
        walls.append(wall)
    launches = [k.launches for k in kernels]
    print(f"fixed trainer: {TRAIN_N} agents x {TRAIN_ZONES} zones x "
          f"{TRAIN_TIMES} times, {n_params} parameters, {FIXED_STEPS} steps, "
          f"losses {losses}, launches {launches}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fixed-step training losses {losses}: not finite and falling")

    # ---- 12. kernel trainer against the plain-version trainer -------------
    sub = tuple(b[:CHECK_FIXED_AGENTS] for b in batch)
    results = []
    for plain in (False, True):
        fn = build_fused_loss_fn(model, config, *static, _plain=plain)
        model.zero_grad()
        loss, _ = fn(*sub)
        loss.backward()
        results.append((loss.item(), grads_of(model)))
    (lk, gk), (lp, gp) = results
    cos = (torch.dot(gk.double(), gp.double())
           / (gk.double().norm() * gp.double().norm())).item()
    rel = abs(lk - lp) / abs(lp)
    print(f"fixed trainer check at {CHECK_FIXED_AGENTS} agents: loss kernels "
          f"{lk:.7f} plain {lp:.7f} (rel {rel:.3e} <= {FIXED_LOSS_RTOL}); "
          f"gradient cosine {cos:.9f}, 1 - cosine {1 - cos:.3e} (cosine > "
          f"{FIXED_COS_MIN})", flush=True)
    if not (rel <= FIXED_LOSS_RTOL and cos > FIXED_COS_MIN):
        fail("the kernel trainer disagrees with the plain-version trainer")

    # ---- 13b. times ---------------------------------------------------------
    da, dz, dc, hd = (config.agent_dim, config.zone_dim, config.context_dim,
                      config.hidden_dim)
    S = (TRAIN_TIMES - 1) * SUBSTEPS
    M = TRAIN_N * TRAIN_TIMES
    fwd, bwd = stage_flops(da, dz, dc, hd, TRAIN_ZONES, config.num_blocks)
    # the functions' work: the day forward, its h-row product once per
    # agent (the kernels redo it in every stage; it is not the function's
    # work); the reverse sweep with one recompute of each stage (the kernel
    # runs 7 stage forwards per substep where this counts 4) and the h-row
    # product and its two VJP products once per agent; the decode once, and
    # its backward's three products on each side of it
    hrow = 2 * dc * hd
    flops = [TRAIN_N * (4 * S * (fwd - hrow) + hrow),
             TRAIN_N * (4 * S * (fwd - hrow + bwd - 2 * hrow) + 3 * hrow),
             M * 2 * (da * dz + dz * TRAIN_ZONES),
             M * 2 * 3 * (da * dz + dz * TRAIN_ZONES)]
    grads = 4 * (TRAIN_ZONES * dz + 4 * S * hd + da * dz + (da + dz) * hd
                 + dc * hd + config.num_blocks * (2 * hd * hd + 2 * hd)
                 + hd * da + da)
    nbytes = [TRAIN_N * 4 * (da + dc + (S + 1) * da),
              TRAIN_N * 4 * (2 * (S + 1) * da + 2 * dc + da) + grads,
              M * 4 * (da + 3),
              M * 4 * (2 * da + 2) + 4 * (TRAIN_ZONES + da) * dz]
    names = ("day_forward_fused", "day_backward_fused", "ce_forward_fused",
             "ce_backward_fused")
    for name, f, nb, m, p in zip(names, flops, nbytes, ms, plain_ms):
        b, by = bound(f, nb)
        print(f"{name} at rung 2: kernel {m:.3f} ms ({f / m / 1e9:.1f} "
              f"TFLOP/s, {b / m:.1%} of the {by} bound), plain version "
              f"{p:.3f} ms ({f / p / 1e9:.1f} TFLOP/s) of {f / 1e9:.1f} GFLOP "
              f"[card {card}]", flush=True)
    plain_loss = build_fused_loss_fn(model, config, *static, _plain=True)
    opt.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = plain_loss(*batch)
    loss.backward()
    opt.step()
    loss = loss.item()
    plain_wall = time.perf_counter() - t0
    print(f"fixed training step at rung 2: kernels {min(walls[1:]):.4f} s "
          f"(best of steps 2-{FIXED_STEPS}), plain versions {plain_wall:.4f} "
          f"s (one step, loss {loss:.6f}) [card {card}]", flush=True)
    replaced = ("fused_train.py:145", "fused_train.py:229",
                "fused_train.py:486", "fused_train.py:537")
    # K2f is the serving kernels' template's third instantiation
    sources = ("fused_step.cu", "fused_train.cu", "fused_train.cu",
               "fused_train.cu")
    entries = [kernel_entry(*a)
               for a in zip(names, sources, replaced, launches, errs, ms,
                            plain_ms, flops, nbytes)]
    return entries, (model, config, static, batch, opt)


# ---- the zone encoder's kernels K4f / K4b, train() and serve() ------------

# (zones, zone features, layers, isolated zone) of the encoder checks; the
# first is the main path's (rung 2's zone world), the last has a zone whose
# adjacency row is all zero (it attends uniformly over every zone)
GAT_SHAPES = ((500, 7, 2, None), (64, 7, 2, None), (2048, 7, 2, None),
              (37, 7, 1, 5))
# more shapes for the readings: depth, many zone features, one zone
GAT_READING_SHAPES = ((500, 7, 4, None), (1000, 16, 3, 7), (1, 7, 2, None),
                      (129, 64, 1, 0))
# train() at rung 2's widths: 2 steps per epoch
APP_AGENTS = 65_536
APP_BATCH = 32_768
APP_SEED = 1
APP_EPOCHS = 2
# a resumed run's history against the straight run's (the JAX test's bound)
HISTORY_RTOL = 1e-5


def encoder_flops(z, f, num_layers, nnz, d=64, heads=4):
    """(forward, VJP) arithmetic operations of the encoder at ``z`` zones
    whose masked softmax needs ``nnz`` scores per head (each zone's edges,
    and every zone for a zone with none). Forward per layer: the projection
    and e_src / e_dst, 5 per score and head (add, leaky-relu, subtract the
    max, exp, sum), 2 per score and feature (the weighted sum), ~11 per
    zone and feature (normalise, elu, residual, LayerNorm). VJP per layer:
    10 per score and head (the recomputed alpha, g_s, the mask's slope, the
    row and column sums), 4 per score and feature (g_out . Wh, g_Wh), two
    products of the projection, ~27 per zone and feature."""
    fwd = 2 * z * f * d + num_layers * (2 * z * d * d + 4 * z * d
                                        + 5 * nnz * heads + 2 * nnz * d
                                        + 11 * z * d)
    bwd = 2 * z * f * d + z * d + num_layers * (
        4 * z * d * d + 4 * nnz * d + 10 * nnz * heads + 27 * z * d)
    return fwd, bwd


def encoder_operands(dev, z, f, num_layers, isolated, seed):
    """``gat_operands`` at one shape; at the main path's shape, rung 2's own
    zone world."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.ops.cuda.checks import gat_operands

    graph = None
    if (z, f, isolated) == (TRAIN_ZONES, 7, None):
        world = generate_agent_population(1, num_times=TRAIN_TIMES,
                                          seed=TRAIN_SEED,
                                          num_zones=TRAIN_ZONES)
        graph = tuple(torch.as_tensor(world[k]) for k in ("zone_features",
                                                          "adj"))
    return gat_operands(z, f, num_layers, dev, seed, isolated, graph)


def encoder_kernel_checks(dev, z, f, num_layers, isolated, seed, control,
                          enforce=True, witness=False):
    """K4f and K4b against their plain versions at one shape, each run
    twice (the same bits), with the TF32 control where ``control``; with
    ``witness``, kernel and plain version each against a float64 run too.
    Returns (the largest |d| of each kernel, (operands, residuals,
    cotangent))."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        GAT_BWD_BOUNDS,
        GAT_FWD_BOUNDS,
        float64_encoder,
        gat_grad_outputs,
        kernel_kink_sides,
        on_kernel_sides,
        tf32_control,
    )

    args, g = encoder_operands(dev, z, f, num_layers, isolated, seed)
    tag = f"Z={z} F={f} layers={num_layers} isolated={isolated} seed={seed}"
    params = lambda grads: gat_grad_outputs(grads, num_layers)
    kind = "TF32 products"
    with torch.no_grad():
        out, res = fg.gat_forward_fused(*args)
        again, _ = fg.gat_forward_fused(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            fail(f"K4f repeat at {tag} is not bit-identical")
        want, _ = fg.gat_forward_reference(*args)
        ctl = ([("out", tf32_control(fg.gat_forward_reference, *args)[0])]
               if control else None)
        e_f = check(f"K4f {tag} (repeat bit-identical)", [("out", out)],
                    [("out", want)], GAT_FWD_BOUNDS, ctl, enforce, kind)
        bargs = (*args[:3], g, *args[3:])
        got = params(fg.gat_backward_fused(*bargs, res))
        again = params(fg.gat_backward_fused(*bargs, res))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"K4b repeat at {tag} is not bit-identical")
        # the plain versions on the kernel's side of each leaky-relu's kink
        sides = kernel_kink_sides(res, num_layers, args[3])
        plain = lambda *a: on_kernel_sides(sides, fg.gat_backward_reference,
                                           *a)
        want = params(plain(*bargs))
        ctl = params(tf32_control(plain, *bargs)) if control else None
        e_b = check(f"K4b {tag} (repeat bit-identical; kink sides of K4f)",
                    got, want, GAT_BWD_BOUNDS, ctl, enforce, kind)
        if witness:
            exact = params(float64_encoder(plain, *bargs))
            unaligned = params(fg.gat_backward_reference(*bargs))
            far = {side: worst_of(o, exact)[0]
                   for side, o in (("kernel", got), ("plain", want),
                                   ("plain on its own sides", unaligned))}
            print(f"K4b {tag} against the float64 witness: "
                  + "; ".join(f"{side} {describe_far(w)}"
                              for side, w in far.items()), flush=True)
    return (e_f, e_b), (args, res, g)


def encoder_readings(dev):
    """``--readings encoder``: K4f and K4b against their plain versions and
    the TF32 control at every shape of GAT_SHAPES and GAT_READING_SHAPES
    for seeds 0-2, printed against the bounds; nothing fails on a bound."""
    for seed in range(3):
        for z, f, num_layers, isolated in GAT_SHAPES + GAT_READING_SHAPES:
            encoder_kernel_checks(dev, z, f, num_layers, isolated, seed,
                                  control=True, enforce=False, witness=True)


@contextlib.contextmanager
def encoder_as_module(model):
    """The fused step with the encoder it ran before K4,
    ``model.encode_zones`` (the loss looks ``zone_gat_fused`` up at each
    call)."""
    from ananke_abm_tpu_torch.ops.cuda import fused_gat

    saved = fused_gat.zone_gat_fused
    fused_gat.zone_gat_fused = (
        lambda zf, adj, gat, **kw: model.encode_zones(zf, adj))
    try:
        yield
    finally:
        fused_gat.zone_gat_fused = saved


def encoder_phases(dev, card, rung2):
    """Phases 14-17: K4f and K4b against their plain versions, ``train()``
    at rung 2's widths with resume and accumulation, ``serve()`` of what it
    trained, and times. Returns K4f's and K4b's entries of the
    {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        build_fused_loss_fn,
        serve,
        train,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        rk4_interval_decode_fused,
    )
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    # ---- 14. the encoder kernels against their plain versions ------------
    errs = [0.0, 0.0]
    main = None
    for z, f, num_layers, isolated in GAT_SHAPES:
        e, operands = encoder_kernel_checks(dev, z, f, num_layers, isolated,
                                            seed=0, control=True)
        errs = [max(a, b) for a, b in zip(errs, e)]
        main = main or operands

    # ---- 15. train() on the card at rung 2's widths ------------------------
    model, config, static, batch, opt = rung2
    cfg = dataclasses.replace(config, batch_size=APP_BATCH,
                              epochs=APP_EPOCHS)
    kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
               ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused)
    kw = dict(n_agents=APP_AGENTS, num_times=TRAIN_TIMES, seed=APP_SEED,
              num_zones=TRAIN_ZONES, device=dev)
    steps = APP_AGENTS // APP_BATCH
    dirs = {k: OUT / f"train_{k}" for k in ("resumed", "straight", "accum")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    history = lambda res: load_checkpoint(res["ckpt"])["history"]
    for k in kernels:
        k.launches = 0
    first = train(str(dirs["resumed"]), config=cfg, ckpt_every=1, **kw)
    launches = [k.launches for k in kernels]
    losses = [h["loss"] for h in history(first)]
    print(f"train(): {APP_AGENTS} agents x {TRAIN_ZONES} zones x "
          f"{TRAIN_TIMES} times, batches of {APP_BATCH}, {APP_EPOCHS} epochs "
          f"in {first['seconds']:.3f} s; losses {losses}; launches "
          f"K4f/K4b/K2f/K2b/K3f/K3b {launches} [card {card}]", flush=True)
    if launches != [APP_EPOCHS * steps] * len(kernels):
        fail(f"train() launched the kernels {launches} times, expected "
             f"once each per step ({APP_EPOCHS * steps} steps)")
    if not all(np.isfinite(losses)):
        fail(f"train() losses {losses} are not finite")
    longer = dataclasses.replace(cfg, epochs=APP_EPOCHS + 1)
    resumed = train(str(dirs["resumed"]), config=longer, resume=True, **kw)
    straight = train(str(dirs["straight"]), config=longer, **kw)
    h_r, h_s = history(resumed), history(straight)
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(h_r, h_s))
    epoch_s = straight["seconds"] / longer.epochs
    print(f"train() resumed to {longer.epochs} epochs against a straight run: "
          f"losses {[h['loss'] for h in h_r]} vs {[h['loss'] for h in h_s]}, "
          f"largest relative difference {rel:.3e} (<= {HISTORY_RTOL}); "
          f"epoch wall {epoch_s:.4f} s (straight run, {steps} steps of "
          f"{APP_BATCH}) [card {card}]", flush=True)
    if len(h_r) != longer.epochs or not rel <= HISTORY_RTOL:
        fail("the resumed run does not reproduce the straight run")
    before = [k.launches for k in kernels]
    accum = train(str(dirs["accum"]), config=dataclasses.replace(
        cfg, epochs=1), accum_steps=steps, ckpt_every=1, **kw)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    updates = load_checkpoint(str(dirs["accum"] / "gatode_last.ckpt"))[
        "opt_state"]["step"]
    print(f"train(accum_steps={steps}): loss {accum['final_loss']:.6f}, "
          f"launches {launched}, optimizer updates {updates}", flush=True)
    if (updates != 1 or launched != [steps] * len(kernels)
            or not np.isfinite(accum["final_loss"])):
        fail("train(accum_steps) did not make one update of its microbatches")

    # ---- 16. serve the trained model ----------------------------------------
    rk4_interval_decode_fused.launches = 0
    info = serve(straight["ckpt"], str(OUT / "served_trained.npz"),
                 n_agents=APP_AGENTS, seed=AGENT_SEED, device=dev)
    k1_launches = rk4_interval_decode_fused.launches
    with np.load(OUT / "served_trained.npz") as served:
        ids = served["zone_ids"]
    print(f"serve() of the trained checkpoint: {info['n_agents']} agents x "
          f"{info['num_times']} times in {info['seconds']:.3f} s; K1 launches "
          f"{k1_launches}", flush=True)
    if k1_launches != TRAIN_TIMES - 1 or ids.shape != (APP_AGENTS,
                                                       TRAIN_TIMES):
        fail(f"serving the trained model: {k1_launches} K1 launches, ids "
             f"{ids.shape}")
    if ids.min() < 0 or ids.max() >= TRAIN_ZONES:
        fail(f"served ids out of [0, {TRAIN_ZONES})")

    # ---- 17. times ----------------------------------------------------------
    args, res, g = main
    bargs = (*args[:3], g, *args[3:])
    calls = [lambda: fg.gat_forward_fused(*args),
             lambda: fg.gat_backward_fused(*bargs, res),
             lambda: fg.gat_forward_reference(*args),
             lambda: fg.gat_backward_reference(*bargs)]
    with torch.no_grad():
        # device time (the kernels line); eager time, the host's enqueue
        # included, beside it
        device = [graph_ms(c, 50) for c in calls]
        eager = [cuda_ms(c, 20) for c in calls]
    ms, plain_ms = device[:2], device[2:]
    gat = model.zone_gat

    def encoder_k4():
        fg.zone_gat_fused(static[0], static[1], gat, heads=gat.heads,
                          num_layers=gat.num_layers).backward(g)

    def encoder_module():
        model.encode_zones(static[0], static[1]).backward(g)

    enc = {"module": cuda_ms(encoder_module, 20),
           "K4": cuda_ms(encoder_k4, 20)}
    loss_fn = build_fused_loss_fn(model, config, *static)

    def step():
        opt.zero_grad()
        loss, _ = loss_fn(*batch)
        loss.backward()
        opt.step()

    walls = {"module": [], "K4": []}
    for name in ("module", "K4", "K4", "module"):
        with (encoder_as_module(model) if name == "module"
              else contextlib.nullcontext()):
            walls[name].append(cuda_ms(step, 3))
    z, f = args[0].shape
    rows = args[1].gt(0).sum(dim=1)
    nnz = int(torch.where(rows > 0, rows, z).sum())
    flops = encoder_flops(z, f, args[4], nnz)
    n_params = sum(w.numel() for w in args[2])
    nbytes = [4 * (z * f + z * z + n_params + z * 64),
              4 * (z * f + z * z + 2 * n_params + z * 64)]
    names = ("gat_forward_fused", "gat_backward_fused")
    for i, (name, fl, nb) in enumerate(zip(names, flops, nbytes)):
        b, by = bound(fl, nb, PEAK_FP32_FLOPS)
        m, p = ms[i], plain_ms[i]
        print(f"{name} at Z={z}: kernel {m:.4f} ms device, {eager[i]:.4f} "
              f"ms eager ({b / m:.2%} of the FP32 {by} bound {b:.5f} ms: "
              f"{fl / 1e6:.1f} MFLOP, {nb / 1e6:.2f} MB), plain version "
              f"{p:.4f} ms device, {eager[i + 2]:.4f} ms eager [card {card}]",
              flush=True)
    print(f"encoder forward + backward at Z={z}: K4 {enc['K4']:.4f} ms, "
          f"model.encode_zones {enc['module']:.4f} ms [card {card}]",
          flush=True)
    k4_step, module_step = min(walls["K4"]), min(walls["module"])
    print(f"fixed training step at rung 2 ({TRAIN_N} agents): encoder K4 "
          f"{k4_step:.3f} ms (runs {walls['K4']}), model.encode_zones "
          f"{module_step:.3f} ms (runs {walls['module']}); encoder share "
          f"{enc['K4'] / k4_step:.2%} with K4, {enc['module'] / module_step:.2%}"
          f" before [card {card}]", flush=True)
    return [kernel_entry(name, "fused_gat.cu", src, n, e, m, p, fl, nb,
                         PEAK_FP32_FLOPS)
            for name, src, n, e, m, p, fl, nb in zip(
                names, ("fused_gat.py:235", "fused_gat.py:256"),
                launches[:2], errs, ms, plain_ms, flops, nbytes)]


# ---- the discrete-adjoint trainer and its kernels K5 / K7 -----------------

# (agents, zones, residual blocks) of the K5 / K7 checks: rung 3's operands,
# an N no tile divides with 500 zones and 1 block, and 8 blocks
DOPRI5_SHAPES = ((98_304, 64, 2), (1_000, 500, 1), (2_000, 64, 8))
# more shapes and seeds for the readings
DOPRI5_READING_SHAPES = ((4_096, 64, 4), (333, 7, 5), (8_192, 2_048, 2))
# the float64 witness's shape
DOPRI5_WITNESS_SHAPE = (1_000, 64, 2)
# the kernel trainer against the plain-version trainer (the same float32
# solve, sums in other orders) and against the continuous adjoint (the
# bounds of the reference's test_trainer_discrete_mode_matches_continuous)
DISCRETE_LOSS_RTOL = 1e-4
DISCRETE_COS_MIN = 0.9999
MODES_LOSS_RTOL = 2e-4
MODES_COS_MIN = 0.999
# train(method="dopri5"): 2 epochs of 2 steps
DOPRI5_APP_AGENTS = 32_768
DOPRI5_APP_BATCH = 16_384
# the repair check: train() at widths the kernels do not all take
REPAIR_AGENTS = 4_096
REPAIR_BATCH = 2_048
REPAIR_TIMES = 6


def dopri5_kernel_checks(dev, n, z, nb, seed, control, enforce=True,
                         witness=False):
    """K5 (with and without err_stats) and K7 against their plain versions
    at one shape, each run twice (the same bits), with the TF32-product
    control where ``control``; with ``witness`` kernel, plain version and
    control each against a float64 run too. Returns (the largest |d| of
    each kernel, the operands)."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BOUNDS,
        DOPRI5_VJP_BOUNDS,
        dopri5_operands,
        dopri5_step_outputs,
        dopri5_vjp_outputs,
        float64_operands,
        tf32_products,
        tf32x3_products,
    )

    model = build_model(GATODEConfig(num_blocks=nb), 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
    args, cot = dopri5_operands(model, n, z, dev, seed=n + seed)
    tag = f"N={n} Z={z} num_blocks={nb} seed={seed}"
    kind = "TF32 products"
    errs = [0.0, 0.0]
    with torch.no_grad():
        for stats in (None, (1e-5, 1e-5)):
            step = lambda *a: fd.dopri5_step_fused(*a, err_stats=stats)
            plain = lambda *a: fd.dopri5_step_reference(*a, err_stats=stats)
            got = dopri5_step_outputs(step(*args))
            again = dopri5_step_outputs(step(*args))
            torch.cuda.synchronize()
            if not same_bits(got, again):
                fail(f"K5 repeat at {tag} is not bit-identical")
            want = dopri5_step_outputs(plain(*args))
            ctl = (dopri5_step_outputs(tf32_products(plain, *args))
                   if control else None)
            check(f"K5 {tag} err_stats={stats} (repeat bit-identical)", got,
                  want, DOPRI5_STEP_BOUNDS, ctl, enforce, kind)
            # the largest |d| of the per-agent outputs (the error sum of
            # these random operands is ~1e9: its |d| says nothing)
            rows = [0, 1, 3] if stats else [0, 1, 2, 3]
            errs[0] = max(errs[0], worst_of([got[i] for i in rows],
                                            [want[i] for i in rows])[1])
        got = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        again = dopri5_vjp_outputs(fd.dopri5_step_vjp_fused(*args, *cot))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"K7 repeat at {tag} is not bit-identical")
        want = dopri5_vjp_outputs(fd.dopri5_step_vjp_reference(*args, *cot))
        ctl = (dopri5_vjp_outputs(tf32_products(
            fd.dopri5_step_vjp_reference, *args, *cot)) if control else None)
        errs[1] = check(f"K7 {tag} (repeat bit-identical)", got, want,
                        DOPRI5_VJP_BOUNDS, ctl, enforce, kind)
        if witness:
            a64, c64 = float64_operands(args), float64_operands(cot)
            for label, outs, fn, wargs, bounds in (
                    ("K5", dopri5_step_outputs, "dopri5_step", a64,
                     DOPRI5_STEP_BOUNDS),
                    ("K7", dopri5_vjp_outputs, "dopri5_step_vjp", a64 + c64,
                     DOPRI5_VJP_BOUNDS)):
                kernel = getattr(fd, f"{fn}_fused")
                plain = getattr(fd, f"{fn}_reference")
                fargs = args if label == "K5" else args + cot
                exact = outs(plain(*wargs))
                sides = [("kernel", kernel), ("plain", plain),
                         ("control", lambda *a: tf32_products(plain, *a))]
                if label == "K5":
                    # the plain version in K5's 3xTF32 arithmetic: the
                    # kernel's rounding class in the plain version's order
                    sides.append(("3xTF32 plain",
                                  lambda *a: tf32x3_products(plain, *a)))
                far = {side: worst_of(outs(f(*fargs)), exact)[0]
                       for side, f in sides}
                print(f"{label} {tag} against the float64 witness: "
                      + "; ".join(f"{side} {describe_far(w)}"
                                  for side, w in far.items()), flush=True)
                if enforce and not within(far["kernel"], bounds):
                    fail(f"{label} lies outside {bounds} of the float64 "
                         "witness")
                if enforce and within(far["control"], bounds):
                    fail(f"{label}'s witness check passes the TF32 control")
    return errs, (args, cot)


def dopri5_readings(dev):
    """``--readings dopri5``: K5 and K7 against their plain versions, the
    TF32 control and the float64 witness, then K6 and K7-bf16 and K5-bf16
    with their controls and the witness, at every shape of DOPRI5_SHAPES
    and DOPRI5_READING_SHAPES for seeds 0-2; nothing fails on a bound."""
    for seed in range(3):
        for n, z, nb in DOPRI5_SHAPES + DOPRI5_READING_SHAPES:
            dopri5_kernel_checks(dev, n, z, nb, seed, control=True,
                                 enforce=False, witness=n <= 4_096)
            backward_kernel_checks(dev, n, z, nb, seed, control=True,
                                   enforce=False, witness=n <= 4_096)
            k5_bf16_checks(dev, n, z, nb, seed, enforce=False,
                           witness=n <= 4_096)
        for n, z, nb in K5_BF16_READING_SHAPES:
            k5_bf16_checks(dev, n, z, nb, seed, enforce=False)


def dopri5_flops(config, num_zones):
    """(K5, K7) operations per agent as the functions need them: K5 six
    stage forwards, the h-row product once; K7 the six stage forwards again
    and six stage VJPs (stage_flops' VJP), the h-row product and its two
    VJP products once."""
    fwd, bwd = stage_flops(config.agent_dim, config.zone_dim,
                           config.context_dim, config.hidden_dim, num_zones,
                           config.num_blocks)
    hrow = 2 * config.context_dim * config.hidden_dim
    return (6 * (fwd - hrow) + hrow,
            6 * (fwd - hrow) + 6 * (bwd - 2 * hrow) + 3 * hrow)


def k5_elementwise(config, num_zones):
    """K5's operations per agent outside its products, each activation one
    operation: per stage Dense_0's bias and tanh, each block's two biases,
    residual add and two tanh, the attention's scale, clamp, exp and sum
    per zone and its normalisation, W3's bias; the tableau's combinations
    and the error's scaled square."""
    h, da = config.hidden_dim, config.agent_dim
    stage = (2 * h + 5 * h * config.num_blocks + 4 * num_zones
             + config.zone_dim + da)
    return 6 * stage + 2 * (21 + 6 + 7 + 5 + 7) * da


def k5_tf32_flops(config, num_zones):
    """K5's operations per agent as its route takes them, in TF32
    tensor-core operations: its products three times (3xTF32: each operand
    a TF32 part and its TF32 remainder), plus its elementwise operations
    scaled by the TF32 peak over the FP32 one; over PEAK_TF32_FLOPS the
    least time of its route."""
    products = dopri5_flops(config, num_zones)[0]
    return (3 * products
            + k5_elementwise(config, num_zones) * PEAK_TF32_FLOPS
            / PEAK_FP32_FLOPS)


def folded_stats(build):
    """``build_adjoint_loss_fn_g`` whose losses record, summed over every
    call, the forward's attempted and accepted steps and the backward's
    replays and VJPs (each call's stats are folded in at the next call and
    by ``totals()``)."""
    totals = {"n_steps": 0, "n_accepted": 0, "replays": 0, "vjps": 0,
              "ok": True}
    pending = []

    def fold():
        for st in pending:
            totals["n_steps"] += st["forward"]["n_steps"]
            totals["n_accepted"] += st["forward"]["n_accepted"]
            totals["ok"] &= bool(st["forward"]["ok"])
            totals["replays"] += st.get("replays", 0)
            totals["vjps"] += st.get("vjps", 0)
        pending.clear()

    def wrapped(*a, **kw):
        loss_fn_g = build(*a, **kw, stats=(st := {}))

        def loss(*b):
            fold()
            pending.append(st)
            return loss_fn_g(*b)

        return loss

    def read():
        fold()
        return dict(totals)

    return wrapped, read


def dopri5_phases(dev, card, continuous_wall):
    """Phases 18-22: K5 and K7 against their plain versions, the discrete
    trainer at rung 3, the kernel trainer against the plain-version trainer
    and the continuous adjoint, ``train(method="dopri5")``, the repair
    check of train()'s kernel gates, and times. Returns K5's and K7's
    entries of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed import train as tr
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft

    # ---- 18. K5 and K7 against their plain versions ----------------------
    errs, main = [0.0, 0.0], None
    for n, z, nb in DOPRI5_SHAPES:
        e, operands = dopri5_kernel_checks(
            dev, n, z, nb, seed=0, control=main is None,
            witness=(n, z, nb) == DOPRI5_WITNESS_SHAPE)
        errs = [max(a, b) for a, b in zip(errs, e)]
        main = main or operands
    n, z, nb = DOPRI5_WITNESS_SHAPE
    if (n, z, nb) not in DOPRI5_SHAPES:
        dopri5_kernel_checks(dev, n, z, nb, seed=0, control=False,
                             witness=True)

    # ---- 19. the discrete trainer at bench rung 3 ------------------------
    config = tr.GATODEConfig(method="dopri5")
    data = generate_agent_population(ADAPT_N, num_times=ADAPT_TIMES,
                                     seed=ADAPT_SEED, num_zones=ADAPT_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = tr.build_model(config, data["zone_features"].shape[-1],
                           data["person_feats"].shape[-1], device=dev)
    tr.init_params(model, torch.Generator().manual_seed(ADAPT_SEED))
    opt = tr.make_optimizer(model, config)
    step, _ = tr.make_adjoint_step_fns(model, opt, config, static,
                                       adjoint_mode="discrete")
    kernels = (fd.dopri5_step_fused, fd.dopri5_step_vjp_fused)
    for k in kernels:
        k.launches = 0
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        before = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = step(*batch)
        loss = loss.item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k7 = (k.launches - b for k, b in zip(kernels, before))
        st = step.stats
        fwd = st["forward"]
        want5 = fwd["n_steps"] + st["replays"]
        print(f"discrete train step {i + 1}: loss {loss:.6f} acc "
              f"{acc.item():.4f}, wall {wall:.3f} s (host clock, synced); "
              f"forward {fwd['n_steps']} steps ({fwd['n_accepted']} "
              f"accepted), backward {st['replays']} replays and "
              f"{st['vjps']} step VJPs; K5 launches {k5} (expected "
              f"{want5}), K7 launches {k7} (expected {fwd['n_accepted']}); "
              f"host syncs {fwd['n_steps'] + 3} [card {card}]", flush=True)
        if k7 != fwd["n_accepted"] or k5 != want5:
            fail(f"discrete step {i + 1} launched K5 {k5} and K7 {k7} "
                 f"times, expected {want5} and {fwd['n_accepted']}")
        if not fwd["ok"]:
            fail(f"discrete step {i + 1}: the solve ran out of steps")
        losses.append(loss)
        walls.append(wall)
    launches = [k.launches for k in kernels]
    print(f"discrete trainer: {ADAPT_N} agents x {ADAPT_ZONES} zones x "
          f"{ADAPT_TIMES} times, {TRAIN_STEPS} steps, losses {losses}, "
          f"launches K5/K7 {launches}; step wall {min(walls[1:]):.3f} s "
          f"(best of steps 2-{TRAIN_STEPS}) against the continuous "
          f"adjoint's {continuous_wall:.3f} s [card {card}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"discrete training losses {losses}: not finite and falling")
    with state_kept(model, opt):
        device_busy("phase 19 step (train()'s defaults, K5 and K7)",
                    lambda: step(*batch), card)

    # ---- 20. kernel trainer against plain versions and continuous mode ---
    sub = tuple(b[:CHECK_TRAIN_AGENTS] for b in batch)
    results = {}
    for name, kw in (
            ("kernels", dict(adjoint_mode="discrete")),
            ("plain", dict(adjoint_mode="discrete", use_fused=True,
                           _plain=True)),
            ("continuous", dict(adjoint_mode="continuous"))):
        stats = {}
        fn = tr.build_adjoint_loss_fn_g(model, config, static, stats=stats,
                                        **kw)
        model.zero_grad()
        loss, _ = fn(*sub, static)
        loss.backward()
        results[name] = (loss.item(), grads_of(model),
                         stats["forward"]["n_accepted"])
    lk, gk, ak = results["kernels"]
    for name, rtol, cmin in (("plain", DISCRETE_LOSS_RTOL, DISCRETE_COS_MIN),
                             ("continuous", MODES_LOSS_RTOL, MODES_COS_MIN)):
        lp, gp, ap = results[name]
        cos = (torch.dot(gk.double(), gp.double())
               / (gk.double().norm() * gp.double().norm())).item()
        rel = abs(lk - lp) / abs(lp)
        print(f"discrete trainer check at {CHECK_TRAIN_AGENTS} agents, "
              f"kernels against {name}: loss {lk:.7f} vs {lp:.7f} (rel "
              f"{rel:.3e} <= {rtol}); gradient cosine {cos:.9f} (> {cmin}); "
              f"accepted steps {ak} vs {ap}", flush=True)
        if not (rel <= rtol and cos > cmin):
            fail(f"the discrete kernel trainer disagrees with {name}")
        if name == "plain" and ak != ap:
            fail("the kernel solve took another accepted-step count than "
                 "the plain-version solve")

    # ---- 21. train(method="dopri5") on the card --------------------------
    build, totals = folded_stats(tr.build_adjoint_loss_fn_g)
    saved = tr.build_adjoint_loss_fn_g
    tr.build_adjoint_loss_fn_g = build
    before = [k.launches for k in kernels]
    out_dir = OUT / "train_dopri5"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        res = tr.train(str(out_dir), n_agents=DOPRI5_APP_AGENTS,
                       num_times=ADAPT_TIMES, seed=ADAPT_SEED,
                       num_zones=ADAPT_ZONES, device=dev,
                       config=dataclasses.replace(
                           config, batch_size=DOPRI5_APP_BATCH, epochs=2))
    finally:
        tr.build_adjoint_loss_fn_g = saved
    k5, k7 = (k.launches - b for k, b in zip(kernels, before))
    tot = totals()
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    hist = [h["loss"] for h in load_checkpoint(res["ckpt"])["history"]]
    print(f"train(method='dopri5'): {DOPRI5_APP_AGENTS} agents x "
          f"{ADAPT_ZONES} zones x {ADAPT_TIMES} times, batches of "
          f"{DOPRI5_APP_BATCH}, 2 epochs in {res['seconds']:.3f} s; losses "
          f"{hist}; forward steps {tot['n_steps']} ({tot['n_accepted']} "
          f"accepted), replays {tot['replays']}; K5 launches {k5} (expected "
          f"{tot['n_steps'] + tot['replays']}), K7 {k7} (expected "
          f"{tot['n_accepted']}) [card {card}]", flush=True)
    if (k5 != tot["n_steps"] + tot["replays"] or k7 != tot["n_accepted"]
            or tot["vjps"] != k7 or k7 == 0 or not tot["ok"]):
        fail("train(method='dopri5') did not run every step through K5/K7")
    if not all(np.isfinite(hist)):
        fail(f"train(method='dopri5') losses {hist} are not finite")

    # ---- 22. repair check: train() at widths some kernels do not take -----
    all_kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
                   ft.day_forward_fused, ft.day_backward_fused,
                   ft.ce_forward_fused, ft.ce_backward_fused)
    steps = REPAIR_AGENTS // REPAIR_BATCH
    for change, want in (({"gat_heads": 2}, [0, 0] + [steps] * 4),
                         ({"hidden_dim": 64}, [0] * 6)):
        before = [k.launches for k in all_kernels]
        d = OUT / "train_repair"
        shutil.rmtree(d, ignore_errors=True)
        res = tr.train(str(d), n_agents=REPAIR_AGENTS,
                       num_times=REPAIR_TIMES, seed=APP_SEED,
                       num_zones=ADAPT_ZONES, device=dev,
                       config=tr.GATODEConfig(batch_size=REPAIR_BATCH,
                                              epochs=1, **change))
        got = [k.launches - b for k, b in zip(all_kernels, before)]
        print(f"train({change}) on the card: loss {res['final_loss']:.6f}; "
              f"launches K4f/K4b/K2f/K2b/K3f/K3b {got} (expected {want})",
              flush=True)
        if got != want or not np.isfinite(res["final_loss"]):
            fail(f"train({change}) took the wrong kernel route")
    # serve() of the hidden_dim=64 checkpoint: K1 is not compiled for its
    # widths, so use_kernel="auto" serves through the float32 body
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs

    before = fs.rk4_interval_decode_fused.launches
    served = {}
    for use in ("auto", False):
        path = d / f"served_{use}.npz"
        tr.serve(res["ckpt"], str(path), n_agents=REPAIR_AGENTS,
                 seed=APP_SEED, use_kernel=use, device=dev)
        with np.load(path) as f:
            served[use] = f["zone_ids"]
    k1 = fs.rk4_interval_decode_fused.launches - before
    same = bool(np.array_equal(served["auto"], served[False]))
    print(f"serve() of the hidden_dim=64 checkpoint on the card: "
          f"{served['auto'].shape} ids, K1 launches {k1} (expected 0), ids "
          f"equal to the float32 body's {same}", flush=True)
    if k1 != 0 or not same:
        fail("serve() at hidden_dim=64 did not take the float32 body")

    # ---- 23. times -----------------------------------------------------------
    args, cot = main
    stats = (config.rtol, config.atol)
    # the kernels over operands packed once, as the trainer's hooks pack
    # them once per solve
    packed = fd.pack_operands(args[3], *args[5:11])
    with torch.no_grad():
        ms = [cuda_ms(lambda: fd.dopri5_step_fused(
                  *args, err_stats=stats, packed=packed), 10),
              cuda_ms(lambda: fd.dopri5_step_vjp_fused(
                  *args, *cot, packed=packed), 5)]
        plain_ms = [cuda_ms(lambda: fd.dopri5_step_reference(
                        *args, err_stats=stats), 3),
                    cuda_ms(lambda: fd.dopri5_step_vjp_reference(*args, *cot),
                            3)]
    flops = [f * ADAPT_N for f in dopri5_flops(config, ADAPT_ZONES)]
    da, dc = config.agent_dim, config.context_dim
    n_w = sum(w.numel() for w in args[5:8]) + sum(
        w.numel() for b in args[8] for w in b) + args[9].numel() + 32
    grads = 4 * (n_w + ADAPT_ZONES * config.zone_dim + 7 * config.hidden_dim)
    weights = 4 * (n_w + ADAPT_ZONES * config.zone_dim
                   + 7 * config.hidden_dim)
    # K5: read x, f0, h, write y1, f1, r5 (the error is one sum); K7: read
    # x, f0, h and the five cotangents, write gy0, gf0, gh and the summed
    # gradients
    nbytes = [ADAPT_N * 4 * (5 * da + dc) + weights,
              ADAPT_N * 4 * (9 * da + 2 * dc) + weights + grads]
    names = ("dopri5_step_fused", "dopri5_step_vjp_fused")
    for name, f, nb_, m, p in zip(names, flops, nbytes, ms, plain_ms):
        b, by = bound(f, nb_, PEAK_FP32_FLOPS)
        print(f"{name} at rung 3 (N={ADAPT_N}, Z={ADAPT_ZONES}): kernel "
              f"{m:.3f} ms ({f / m / 1e9:.1f} TFLOP/s, {b / m:.1%} of the "
              f"FP32 {by} bound {b:.3f} ms), plain version {p:.3f} ms "
              f"({f / p / 1e9:.1f} TFLOP/s) of {f / 1e9:.1f} GFLOP "
              f"[card {card}]", flush=True)
    # K5 takes its products in 3xTF32 on the tensor cores: its bound is
    # its route's (k5_tf32_flops at the TF32 peak), the FP32 one beside it
    f5 = k5_tf32_flops(config, ADAPT_ZONES) * ADAPT_N
    b, by = bound(f5, nbytes[0], PEAK_TF32_FLOPS)
    print(f"dopri5_step_fused's 3xTF32 bound: {b:.3f} ms ({by}; "
          f"{b / ms[0]:.1%} of it), against the FP32 bound "
          f"{bound(flops[0], nbytes[0], PEAK_FP32_FLOPS)[0]:.3f} ms "
          f"[card {card}]", flush=True)
    return [kernel_entry(names[0], "fused_dopri5.cu", "fused_dopri5.py:104",
                         launches[0], errs[0], ms[0], plain_ms[0], f5,
                         nbytes[0], PEAK_TF32_FLOPS),
            kernel_entry(names[1], "fused_dopri5.cu", "fused_dopri5.py:254",
                         launches[1], errs[1], ms[1], plain_ms[1], flops[1],
                         nbytes[1], PEAK_FP32_FLOPS)], min(walls[1:])


# ---- the whole discrete-adjoint backward K6 and K7's bf16 branch ----------

# bench rung 3's own settings of the discrete trainer (bench.py:250-266)
RUNG3 = dict(adjoint_mode="discrete", max_accepted=256, ckpt_every=1,
             bwd_precision="bf16")
# the per-step route at bf16: K7's bf16 branch for every accepted step
PER_STEP_BF16 = dict(adjoint_mode="discrete", ckpt_every=2,
                     bwd_precision="bf16")
# K6's route against the route on every plain version (K5's float32 sums
# in another order: the loss within phase 20's DISCRETE_LOSS_RTOL),
# against the per-step bf16 route (the reference's whole-versus-per-step
# bound, tests/test_ops_kernels.py:1112-1113) and against the float32 route
K6_PLAIN_COS_MIN = 0.999
WHOLE_COS_MIN = 0.9999
K6_F32_COS_MIN = 0.999


def backward_kernel_checks(dev, n, z, nb, seed, control, enforce=True,
                           witness=False):
    """K7 at bf16 and K6 at both precisions and checkpoint types against
    their plain versions at one shape, each run twice (the same bits), with
    the controls where ``control`` (bf16 products for the bf16 kernels, TF32
    products for K6 at float32); with ``witness`` kernel, plain version and
    control each against a float64 run. Returns (the largest |d| of K6, of
    K7 at bf16)."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_BWD_BF16_BOUNDS,
        DOPRI5_BWD_BOUNDS,
        DOPRI5_VJP_BF16_BOUNDS,
        K6_RECORD,
        bf16_control,
        day_bounds,
        dopri5_backward_operands,
        dopri5_operands,
        dopri5_vjp_outputs,
        float64_operands,
        float64_witness,
        tf32_products,
    )

    model = build_model(GATODEConfig(num_blocks=nb), 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
    args, cot = dopri5_operands(model, n, z, dev, seed=n + seed)
    tag = f"N={n} Z={z} num_blocks={nb} seed={seed}"
    at = lambda fn, prec: (lambda *a: fn(*a, precision=prec))  # noqa: E731
    exact32 = lambda fn: (lambda *a: fn(*float64_operands(a)))  # noqa: E731
    runs = [("K7 bf16", 1, at(fd.dopri5_step_vjp_fused, "bf16"),
             at(fd.dopri5_step_vjp_reference, "bf16"), args + cot,
             day_bounds(DOPRI5_VJP_BF16_BOUNDS, nb), bf16_control,
             "bf16-rounded products",
             lambda f: (lambda *a: float64_witness(f, *a)))]
    for prec, bounds, ctl, kind, exact in (
            ("bf16", day_bounds(DOPRI5_BWD_BF16_BOUNDS, nb), bf16_control,
             "bf16-rounded products",
             lambda f: (lambda *a: float64_witness(f, *a))),
            ("f32", DOPRI5_BWD_BOUNDS, tf32_products, "TF32 products",
             exact32)):
        for dt in (torch.bfloat16, torch.float32):
            bargs = dopri5_backward_operands(model, n, z, dev, n + seed,
                                             *K6_RECORD, ckpt_dtype=dt)
            runs.append((f"K6 {prec} checkpoints {str(dt)[6:]}", 0,
                         at(fd.dopri5_backward_fused, prec),
                         at(fd.dopri5_backward_reference, prec), bargs,
                         bounds, ctl, kind, exact))
    outs = dopri5_vjp_outputs
    errs = [0.0, 0.0]
    with torch.no_grad():
        for label, i, kernel, plain, a, bounds, ctl, kind, exact in runs:
            got = outs(kernel(*a))
            again = outs(kernel(*a))
            torch.cuda.synchronize()
            if not same_bits(got, again):
                fail(f"{label} repeat at {tag} is not bit-identical")
            want = outs(plain(*a))
            c = outs(ctl(plain, *a)) if control else None
            errs[i] = max(errs[i], check(
                f"{label} {tag} (repeat bit-identical)", got, want, bounds,
                c, enforce, kind))
            if not witness:
                continue
            ref = outs(exact(plain)(*a))
            far = {side: worst_of(outs(f(*a)), ref)[0] for side, f in (
                ("kernel", kernel), ("plain", plain),
                ("control", lambda *b: ctl(plain, *b)))}
            print(f"{label} {tag} against the float64 witness: "
                  + "; ".join(f"{side} {describe_far(w)}"
                              for side, w in far.items()), flush=True)
            if enforce and not within(far["kernel"], bounds):
                fail(f"{label} lies outside {bounds} of the float64 witness")
            if enforce and within(far["control"], bounds):
                fail(f"{label}'s witness check passes its control")
    return errs


def rung3_trainer(dev):
    """(config, a freshly seeded model, static, batch) of bench rung 3's
    adaptive trainer: 98,304 agents x 64 zones x 12 times, seed 7."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed import train as tr

    config = tr.GATODEConfig(method="dopri5")
    data = generate_agent_population(ADAPT_N, num_times=ADAPT_TIMES,
                                     seed=ADAPT_SEED, num_zones=ADAPT_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = tr.build_model(config, data["zone_features"].shape[-1],
                           data["person_feats"].shape[-1], device=dev)
    tr.init_params(model, torch.Generator().manual_seed(ADAPT_SEED))
    return config, model, static, batch


def recording_operands(model, recorded):
    """K6's operands (``dopri5_backward_fused``'s, without the precision)
    from what a discrete backward passed to ``step_vjp.backward_all``
    (``stats["backward_all"]``): the recording, the output rows'
    cotangents, the time table of its steps and the drift's weights."""
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        flax_leaf_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import split_drift_params

    (ckpts, ckpt_f, rec_t0, rec_h, n_acc, g, out_step, ts,
     (params, hc, ze)) = recorded
    (Wq, W1xc, W1h, W1t, b1, blocks, W3, b3) = split_drift_params(
        dict(zip([p for p, _ in flax_leaf_params(model)], params)))
    return (ckpts, ckpt_f, hc, ze,
            fd.stage_time_table(rec_t0, rec_h, W1t, b1), rec_t0, rec_h,
            n_acc, g, out_step, ts, Wq, W1xc, W1h, blocks, W3, b3)


def rung3_recording(dev):
    """(model, K6's operands, accepted steps) of one training step at bench
    rung 3's own settings (RUNG3) from a freshly seeded model."""
    from ananke_abm_tpu_torch.models.gnn_embed import train as tr

    config, model, static, batch = rung3_trainer(dev)
    step, _ = tr.make_adjoint_step_fns(
        model, tr.make_optimizer(model, config), config, static, **RUNG3)
    step.stats["keep_backward_all"] = True
    step(*batch)
    a = recording_operands(model, step.stats.pop("backward_all"))
    return model, a, a[7]


def backward_all_phases(dev, card, discrete_wall):
    """Phases 24-27: K6 and K7 at bf16 against their plain versions, the
    discrete trainer at bench rung 3's own settings, the K6 route against
    the plain versions' route, the per-step bf16 route and the float32
    route, K6 against its plain version on the operands of rung 3's last
    step, and times. Returns K6's and K7-bf16's entries of the
    {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.models.gnn_embed import train as tr
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_BWD_BF16_BOUNDS,
        day_bounds,
        dopri5_operands,
        dopri5_vjp_outputs,
    )

    # ---- 24. K6 and K7-bf16 against their plain versions -----------------
    errs = [0.0, 0.0]
    for n, z, nb in DOPRI5_SHAPES:
        e = backward_kernel_checks(
            dev, n, z, nb, seed=0, control=(n, z, nb) == DOPRI5_SHAPES[0],
            witness=(n, z, nb) == DOPRI5_WITNESS_SHAPE)
        errs = [max(a, b) for a, b in zip(errs, e)]
    if DOPRI5_WITNESS_SHAPE not in DOPRI5_SHAPES:
        backward_kernel_checks(dev, *DOPRI5_WITNESS_SHAPE, seed=0,
                               control=False, witness=True)

    # ---- 25. the discrete trainer at bench rung 3's own settings ---------
    config, model, static, batch = rung3_trainer(dev)
    opt = tr.make_optimizer(model, config)
    step, _ = tr.make_adjoint_step_fns(model, opt, config, static, **RUNG3)
    kernels = fd.KERNELS
    for k in kernels:
        k.launches = 0
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        # the last step's backward keeps the operands it gives K6, for
        # phase 27
        step.stats["keep_backward_all"] = i == TRAIN_STEPS - 1
        before = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = step(*batch)
        loss = loss.item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k7, k6 = (k.launches - b for k, b in zip(kernels, before))
        st = step.stats
        fwd = st["forward"]
        print(f"rung 3 train step {i + 1} (max_accepted 256, ckpt_every 1, "
              f"bf16 backward): loss {loss:.6f} acc {acc.item():.4f}, wall "
              f"{wall:.3f} s (host clock, synced); forward {fwd['n_steps']} "
              f"steps ({fwd['n_accepted']} accepted), backward "
              f"{st['replays']} replays and {st['vjps']} step VJPs; launches "
              f"K5 {k5} (expected {fwd['n_steps']}), K7 {k7} (expected 0), "
              f"K6 {k6} (expected 1) [card {card}]", flush=True)
        if (k6, k7, k5) != (1, 0, fwd["n_steps"]) or st["replays"] or st[
                "vjps"]:
            fail(f"rung-3 step {i + 1} launched K5 {k5}, K7 {k7} and K6 {k6}"
                 f" times, expected {fwd['n_steps']}, 0 and 1")
        if not fwd["ok"]:
            fail(f"rung-3 step {i + 1}: the solve ran out of steps")
        losses.append(loss)
        walls.append(wall)
    launches = [k.launches for k in kernels]
    recorded = step.stats.pop("backward_all")
    step_wall = min(walls[1:])
    print(f"rung 3 at its own settings: {ADAPT_N} agents x {ADAPT_ZONES} "
          f"zones x {ADAPT_TIMES} times, {TRAIN_STEPS} steps, losses "
          f"{losses}, launches K5/K7/K6 {launches}; step wall {step_wall:.3f}"
          f" s (best of steps 2-{TRAIN_STEPS}) against phase 19's "
          f"{discrete_wall:.3f} s (train()'s defaults, float32 K7) "
          f"[card {card}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"rung-3 training losses {losses}: not finite and falling")
    step.stats["keep_backward_all"] = False
    with state_kept(model, opt):
        device_busy("phase 25 step (rung 3 at its own settings, K5 and K6)",
                    lambda: step(*batch), card)

    # ---- 26. the K6 route against the plain, per-step and float32 routes --
    sub = tuple(b[:CHECK_TRAIN_AGENTS] for b in batch)
    results = {}
    for name, kw in (("K6", RUNG3),
                     ("plain", dict(RUNG3, use_fused=True, _plain=True)),
                     ("per-step bf16", PER_STEP_BF16),
                     ("float32 per-step", dict(adjoint_mode="discrete"))):
        stats = {}
        fn = tr.build_adjoint_loss_fn_g(model, config, static, stats=stats,
                                        **kw)
        before = [k.launches for k in kernels]
        model.zero_grad()
        loss, _ = fn(*sub, static)
        loss.backward()
        counts = [k.launches - b for k, b in zip(kernels, before)]
        results[name] = (loss.item(), grads_of(model),
                         stats["forward"]["n_accepted"], counts)
        print(f"{name} route at {CHECK_TRAIN_AGENTS} agents: loss "
              f"{loss.item():.9f}, {stats['forward']['n_accepted']} accepted"
              f" steps, launches K5/K7/K6 {counts}", flush=True)
    lk, gk, ak, ck = results["K6"]
    if ck[1:] != [0, 1]:
        fail(f"the K6 route launched K7/K6 {ck[1:]} times, expected 0 / 1")
    k7_bf16_launches = results["per-step bf16"][3][1]
    if (results["per-step bf16"][3][1:] != [results["per-step bf16"][2], 0]
            or results["plain"][3] != [0, 0, 0]):
        fail("the per-step bf16 route or the plain route took the wrong "
             "kernels")
    for name, cmin in (("plain", K6_PLAIN_COS_MIN),
                       ("per-step bf16", WHOLE_COS_MIN),
                       ("float32 per-step", K6_F32_COS_MIN)):
        lp, gp, ap, _ = results[name]
        cos = (torch.dot(gk.double(), gp.double())
               / (gk.double().norm() * gp.double().norm())).item()
        print(f"K6 route check at {CHECK_TRAIN_AGENTS} agents against the "
              f"{name} route: loss {lk:.9f} vs {lp:.9f} (rel "
              f"{abs(lk - lp) / abs(lp):.3e}); gradient cosine {cos:.9f} (> "
              f"{cmin}); accepted steps {ak} vs {ap}", flush=True)
        if not cos > cmin:
            fail(f"the K6 route's gradient disagrees with the {name} route")
        if name == "plain" and (abs(lk - lp) > DISCRETE_LOSS_RTOL * abs(lp)
                                or ak != ap):
            fail("the K6 route's loss or accepted steps differ from the "
                 "plain versions'")

    # ---- 27. K6 on the main path's own operands, and times ---------------
    # the operands the hooks formed from the last rung-3 step's recording
    a = recording_operands(model, recorded)
    ckpts, n_acc = a[0], a[7]
    kw = dict(precision="bf16",
              packed=fd.pack_operands(a[3], *a[11:], precision="bf16"))
    tag = (f"on rung 3's last recording ({n_acc} of {ckpts.shape[0]} steps,"
           f" {str(ckpts.dtype)[6:]} checkpoints, N={ADAPT_N})")
    with torch.no_grad():
        got = dopri5_vjp_outputs(fd.dopri5_backward_fused(*a, **kw))
        again = dopri5_vjp_outputs(fd.dopri5_backward_fused(*a, **kw))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"K6 {tag}: a repeat is not bit-identical")
        want = dopri5_vjp_outputs(fd.dopri5_backward_reference(
            *a, precision="bf16"))
        errs[0] = check(f"K6 bf16 {tag} (repeat bit-identical)", got, want,
                        day_bounds(DOPRI5_BWD_BF16_BOUNDS,
                                   config.num_blocks))
        del got, again, want
        args, cot = dopri5_operands(model, ADAPT_N, ADAPT_ZONES, dev, seed=1)
        packed = fd.pack_operands(args[3], *args[5:11], precision="bf16")
        ms = [cuda_ms(lambda: fd.dopri5_backward_fused(*a, **kw), 3),
              cuda_ms(lambda: fd.dopri5_step_vjp_fused(
                  *args, *cot, precision="bf16", packed=packed), 5)]
        plain_ms = [cuda_ms(lambda: fd.dopri5_backward_reference(
                        *a, precision="bf16"), 1),
                    cuda_ms(lambda: fd.dopri5_step_vjp_reference(
                        *args, *cot, precision="bf16"), 3)]
    k7_flop = dopri5_flops(config, ADAPT_ZONES)[1] * ADAPT_N
    flops = [n_acc * k7_flop, k7_flop]
    da, dc, hd = config.agent_dim, config.context_dim, config.hidden_dim
    n_w = sum(w.numel() for w in args[5:8]) + sum(
        w.numel() for b in args[8] for w in b) + args[9].numel() + da
    zones = ADAPT_ZONES * config.zone_dim
    T = a[8].shape[0]
    # K6: read each accepted step's two checkpoints, the output rows'
    # cotangents, h and each step's time rows, the bf16 weights and zones;
    # write gy0, gf0, gh and the summed gradients (7 time rows a step). K7:
    # as phase 23 counts it, with bf16 weights
    nbytes = [n_acc * ADAPT_N * da * 2 * a[0].element_size()
              + 4 * ADAPT_N * (T * da + dc) + 4 * n_acc * 7 * hd
              + 2 * (n_w + zones) + 4 * ADAPT_N * (2 * da + dc)
              + 4 * (n_w + zones + 7 * n_acc * hd),
              ADAPT_N * 4 * (9 * da + 2 * dc) + 2 * (n_w + zones)
              + 4 * (n_w + zones + 7 * hd)]
    names = ("dopri5_backward_fused", "dopri5_step_vjp_fused (bf16)")
    for name, f, nb_, m, p in zip(names, flops, nbytes, ms, plain_ms):
        b, by = bound(f, nb_)
        print(f"{name} at rung 3 (N={ADAPT_N}, Z={ADAPT_ZONES}"
              + (f", {n_acc} accepted steps" if name == names[0] else "")
              + f"): kernel {m:.3f} ms ({f / m / 1e9:.1f} TFLOP/s, {b / m:.1%}"
              f" of the bf16 {by} bound {b:.3f} ms), plain version {p:.3f} ms"
              f" of {f / 1e9:.1f} GFLOP [card {card}]", flush=True)
    print(f"rung-3 step at its own settings: {step_wall:.3f} s, K6 "
          f"{ms[0]:.3f} ms of it ({ms[0] / 1e3 / step_wall:.1%}) [card "
          f"{card}]", flush=True)
    # K6's float32 body on the same recording (no main path launches it:
    # rung 3 takes the bf16 body; checked in phase 24), at the FP32 peak
    kw32 = dict(precision="f32",
                packed=fd.pack_operands(a[3], *a[11:], precision="f32"))
    with torch.no_grad():
        m32 = cuda_ms(lambda: fd.dopri5_backward_fused(*a, **kw32), 2)
        p32 = cuda_ms(lambda: fd.dopri5_backward_reference(
            *a, precision="f32"), 1)
    b, by = bound(flops[0], nbytes[0], PEAK_FP32_FLOPS)
    print(f"dopri5_backward_fused (f32 body) on the same recording: kernel "
          f"{m32:.3f} ms ({b / m32:.1%} of the FP32 {by} bound {b:.3f} ms),"
          f" plain version {p32:.3f} ms [card {card}]", flush=True)
    return [kernel_entry(name, "fused_dopri5.cu", src, n_, e, m, p, f, nb_)
            for name, src, n_, e, m, p, f, nb_ in zip(
                names, ("fused_dopri5.py:474", "fused_dopri5.py:254"),
                (launches[2], k7_bf16_launches), errs, ms, plain_ms, flops,
                nbytes)]


# ---- sparse zone graphs: the CSR edge kernel pair ---------------------------

# the sparse world of serve_ladder.py's sparse point, at GATODEConfig()'s
# widths
SPARSE_ZONES = 32_768
SPARSE_SERVE_AGENTS = 65_536
SPARSE_SERVE_TIMES = 48
# served again with the encoder's plain version: over the whole 48-time
# day, where a flipped id carries into later intervals, the two read
# 0.999992 and 0.999995 agreement (H100 80GB HBM3, 700 W; PERF.md)
SPARSE_CHECK_AGENTS = 8_192
SPARSE_IDS_MIN = 0.999
# train(sparse_world=True): 12 times (48 would put 25.8 GB in the logits
# alone), 2 epochs of 2 steps of 4,096
SPARSE_TRAIN_AGENTS = 8_192
SPARSE_TRAIN_TIMES = 12
SPARSE_EPOCHS = 2
# the discrete-adjoint trainer on a sparse graph, small enough for K5 / K7
SPARSE_DOPRI5_ZONES = 4_096
SPARSE_DOPRI5_AGENTS = 4_096
# the dense plain step timed with and without remat (phase 33): past
# FUSED_MAX_ZONES, where train() takes that step
REMAT_DENSE_ZONES = 4_096
# the sparse encoder against the dense one (tests/test_gnn_embed.py's bounds)
ENCODER_FWD_TOL = (2e-5, 2e-5)
ENCODER_GRAD_TOL = (5e-4, 5e-5)


def edge_counts():
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es

    return [es.gat_edge_csr_forward.launches,
            es.gat_edge_csr_backward.launches]


@contextlib.contextmanager
def edge_plain():
    """The encoder's edge attention through the CSR kernels' plain
    versions (``gat_edge_csr`` looks its pair up at each call)."""
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es

    saved, es.KERNELS = es.KERNELS, es.PLAIN
    try:
        yield
    finally:
        es.KERNELS = saved


def edge_sizes(wh, e_recv, layout):
    """(Zs, Zr, Zd, H, HD, E) of one edge-kernel call."""
    Zs, H, d = wh.shape
    return (Zs, e_recv.shape[0], layout.num_nodes, H, H * d,
            layout.src.numel())


def edge_work(wh, e_recv, layout):
    """(forward, backward) operations and bytes the functions need. Forward:
    6 per edge and head (add, leaky-relu, max, subtract, exp, sum), 2 per
    edge and feature (the weighted sum); it reads Wh, both logit tables and
    the CSR layout once and writes out and lse. Backward: 10 per edge and
    head (alpha, ds, the two sums), 4 per edge and feature (<g, Wh>, the
    weighted sum of g); it reads g, Wh, the logit tables, lse, corr and
    both orders of the layout, and writes the three gradients."""
    Zs, Zr, Zd, H, HD, E = edge_sizes(wh, e_recv, layout)
    flop = (E * (6 * H + 2 * HD), E * (10 * H + 4 * HD))
    nbytes = (4 * (Zs * HD + Zr * H + Zs * H + Zd + 1 + E + Zd * HD + Zd * H),
              4 * (Zd * HD + Zs * HD + Zr * H + Zs * H + 2 * Zd * H
                   + Zd + 1 + E + Zs + 1 + E + Zs * HD + Zr * H + Zs * H))
    return flop, nbytes


def edge_kernel_checks(dev, kind, z, heads, d, seed, control=True,
                       enforce=True):
    """The CSR forward and backward against their plain versions at one
    shape (``checks.edge_operands``), each run twice (the same bits), with
    the bf16-feature control. Returns (the largest |d| of each kernel,
    (operands, lse, corr, cotangent))."""
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        EDGE_BWD_BOUNDS,
        EDGE_FWD_BOUNDS,
        bf16_features,
        edge_operands,
    )

    (wh, er, esd, lay), g = edge_operands(kind, z, heads, d, dev, seed)
    tag = (f"{kind} Zs={z} num_nodes={lay.num_nodes} E={lay.src.numel()} "
           f"H={heads} d={d} seed={seed}")
    kind_c = "bf16-rounded features"
    with torch.no_grad():
        out, lse = es.gat_edge_csr_forward(wh, er, esd, lay)
        again = es.gat_edge_csr_forward(wh, er, esd, lay)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"CSR forward repeat at {tag} is not bit-identical")
        want, _ = es.gat_edge_csr_forward_reference(wh, er, esd, lay)
        ctl = ([("out", es.gat_edge_csr_forward_reference(
            bf16_features(wh), er, esd, lay)[0])] if control else None)
        e_f = check(f"CSR forward {tag} (repeat bit-identical)",
                    [("out", out)], [("out", want)], EDGE_FWD_BOUNDS, ctl,
                    enforce, kind_c)
        corr = torch.sum(g * out, dim=-1)
        names = ("d_wh", "d_recv", "d_send")
        bargs = (g, wh, er, esd, lse, corr, lay)
        got = list(zip(names, es.gat_edge_csr_backward(*bargs)))
        again = list(zip(names, es.gat_edge_csr_backward(*bargs)))
        torch.cuda.synchronize()
        if not same_bits(got, again):
            fail(f"CSR backward repeat at {tag} is not bit-identical")
        want = list(zip(names, es.gat_edge_csr_backward_reference(*bargs)))
        ctl = (list(zip(names, es.gat_edge_csr_backward_reference(
            g, bf16_features(wh), *bargs[2:])))
            if control else None)
        e_b = check(f"CSR backward {tag} (repeat bit-identical)", got, want,
                    EDGE_BWD_BOUNDS, ctl, enforce, kind_c)
    return (e_f, e_b), ((wh, er, esd, lay), lse, corr, g)


def edge_readings(dev):
    """``--readings edge``: the CSR kernels against their plain versions
    and the bf16-feature control at every shape of EDGE_SHAPES for seeds
    0-2, printed against the bounds; nothing fails on a bound."""
    from ananke_abm_tpu_torch.ops.cuda.checks import EDGE_SHAPES

    for seed in range(3):
        for shape in EDGE_SHAPES:
            edge_kernel_checks(dev, *shape, seed, enforce=False)


def close(name, got, want, tol):
    """Fail unless |got - want| <= atol + rtol |want| everywhere; returns
    the largest |got - want|."""
    rtol, atol = tol
    d = (got - want).abs()
    err = d.max().item() if d.numel() else 0.0
    if not bool((d <= atol + rtol * want.abs()).all()):
        fail(f"{name}: |d| up to {err:.3e} outside rtol {rtol}, atol {atol}")
    return err


def edge_phases(dev, card):
    """Phases 28-33: the CSR edge kernels against their plain versions, the
    sparse encoder against the dense one, ``serve()`` of a sparse-world
    checkpoint at Z=32,768, ``train(sparse_world=True)`` at that world and
    with ``method="dopri5"`` at Z=4,096, and times. Returns the two
    kernels' entries of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        load_flax_params,
        to_flax_params,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        make_decoded_rollout,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _cross_entropy,
        build_model,
        init_params,
        make_optimizer,
        make_step_fns,
        serve,
        train,
    )
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.checks import EDGE_SHAPES
    from ananke_abm_tpu_torch.ops.segment import edges_from_adj
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint, \
        save_checkpoint

    config = GATODEConfig()
    layers = config.gat_layers
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)

    # ---- 28. the CSR kernels against their plain versions -----------------
    errs = [0.0, 0.0]
    main = None
    for shape in EDGE_SHAPES:
        e, operands = edge_kernel_checks(dev, *shape, seed=0)
        errs = [max(a, b) for a, b in zip(errs, e)]
        main = main or operands

    # ---- 29. the sparse encoder against the dense one, rung 2's world -----
    model = build_model(config, 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    world = generate_agent_population(1, num_times=TRAIN_TIMES,
                                      seed=TRAIN_SEED, num_zones=TRAIN_ZONES)
    zf, adj = on(world["zone_features"]), on(world["adj"])
    ei = tuple(on(e, torch.long) for e in edges_from_adj(world["adj"]))
    params = list(model.zone_gat.parameters())
    cot = torch.randn(TRAIN_ZONES, config.zone_dim, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    outs = {}
    for name, args in (("sparse", (None, ei)), ("dense", (adj,))):
        before = edge_counts()
        out = model.encode_zones(zf, *args)
        grads = torch.autograd.grad(out, params, cot)
        outs[name] = (out.detach(), grads,
                      [a - b for a, b in zip(edge_counts(), before)])
    (sp, gs, ls), (de, gd, _) = outs["sparse"], outs["dense"]
    e_out = close("sparse encoder against dense", sp, de, ENCODER_FWD_TOL)
    e_grad = max(close(f"sparse encoder gradient {i}", a, b,
                       ENCODER_GRAD_TOL) for i, (a, b) in
                 enumerate(zip(gs, gd)))
    print(f"sparse encoder (CSR kernels, launches fwd/bwd {ls}) against the "
          f"dense encoder at rung 2's world (Z={TRAIN_ZONES}, "
          f"E={ei[0].numel()}): output |d| <= {e_out:.3e} (rtol/atol "
          f"{ENCODER_FWD_TOL}), parameter gradients |d| <= {e_grad:.3e} "
          f"(rtol/atol {ENCODER_GRAD_TOL})", flush=True)
    if ls != [layers, layers]:
        fail(f"the sparse encoder launched the CSR kernels {ls} times, "
             f"expected {layers} each")

    # ---- 30. serve() of a sparse-world checkpoint at Z=32,768 -------------
    main_counts = [0, 0]  # the slice's main path: phases 30-32

    def driven(fn, *a, **kw):
        """``fn(*a, **kw)`` with the CSR counts set to 0 just before and
        read just after (added to the main path's counts)."""
        es.gat_edge_csr_forward.launches = 0
        es.gat_edge_csr_backward.launches = 0
        res = fn(*a, **kw)
        counts = edge_counts()
        for i, c in enumerate(counts):
            main_counts[i] += c
        return res, counts

    ckpt = OUT / "gatode_sparse_random.ckpt"
    model = build_model(config, 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    save_checkpoint({
        "params": to_flax_params(model),
        "config": dataclasses.asdict(config),
        "num_zones": SPARSE_ZONES,
        "num_times": SPARSE_SERVE_TIMES,
        "history": [],
        "world_seed": WORLD_SEED,
        "sparse_world": True,
    }, str(ckpt))
    torch.cuda.reset_peak_memory_stats()
    info, counts = driven(serve, str(ckpt), str(OUT / "served_sparse.npz"),
                          n_agents=SPARSE_SERVE_AGENTS, seed=AGENT_SEED,
                          device=dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve() sparse world: {info['n_agents']} agents x "
          f"{info['num_times']} times x {SPARSE_ZONES} zones in "
          f"{info['seconds']:.3f} s ({info['n_agents'] / info['seconds']:.0f}"
          f" agents/s, host clock around the rollout); CSR launches fwd/bwd "
          f"{counts}; peak device memory {peak:.2f} GB [card {card}]",
          flush=True)
    if counts != [layers, 0]:
        fail(f"the sparse serve launched the CSR kernels {counts} times, "
             f"expected [{layers}, 0]")
    with np.load(OUT / "served_sparse.npz") as served:
        ids = served["zone_ids"]
    if ids.shape != (SPARSE_SERVE_AGENTS, SPARSE_SERVE_TIMES):
        fail(f"served ids {ids.shape}")
    if ids.min() < 0 or ids.max() >= SPARSE_ZONES:
        fail(f"served ids out of [0, {SPARSE_ZONES})")
    data = generate_agent_population(
        SPARSE_SERVE_AGENTS, num_times=SPARSE_SERVE_TIMES, seed=AGENT_SEED,
        num_zones=SPARSE_ZONES, sparse_world=True, world_seed=WORLD_SEED)
    served_model = build_model(config, 7, 8, device=dev)
    load_flax_params(served_model, load_checkpoint(str(ckpt))["params"])
    sparse_ei = tuple(on(e, torch.long) for e in data["edge_index"])
    with edge_plain():
        plain = make_decoded_rollout(
            served_model, config, on(data["zone_features"]), None,
            on(data["times"]), edge_index=sparse_ei)
        ref = plain(on(data["person_feats"][:SPARSE_CHECK_AGENTS]),
                    on(data["home_zone"][:SPARSE_CHECK_AGENTS], torch.long))
    agree = float(np.mean(ref.cpu().numpy() == ids[:SPARSE_CHECK_AGENTS]))
    print(f"sparse serve check: ids[:{SPARSE_CHECK_AGENTS}] against the "
          f"rollout with the encoder's plain version: agree {agree:.6f} (>= "
          f"{SPARSE_IDS_MIN})", flush=True)
    if agree < SPARSE_IDS_MIN:
        fail("the sparse serve disagrees with the encoder's plain version")

    # ---- 31. train(sparse_world=True) at Z=32,768 --------------------------
    dense_kernels = (fg.gat_forward_fused, fg.gat_backward_fused,
                     ft.day_forward_fused, ft.day_backward_fused,
                     ft.ce_forward_fused, ft.ce_backward_fused)
    before = [k.launches for k in dense_kernels]
    cfg = dataclasses.replace(config, epochs=SPARSE_EPOCHS)
    steps = SPARSE_EPOCHS * (SPARSE_TRAIN_AGENTS // cfg.batch_size)
    shutil.rmtree(OUT / "train_sparse", ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    res, counts = driven(train, str(OUT / "train_sparse"),
                         n_agents=SPARSE_TRAIN_AGENTS,
                         num_times=SPARSE_TRAIN_TIMES, config=cfg,
                         seed=WORLD_SEED, num_zones=SPARSE_ZONES,
                         sparse_world=True, device=dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    dense = [k.launches - b for k, b in zip(dense_kernels, before)]
    losses = [h["loss"] for h in load_checkpoint(res["ckpt"])["history"]]
    # without remat a plain RK4 step keeps two (batch, Z) float32 tensors
    # per stage evaluation: 4 stages x substeps x intervals
    no_remat = (2 * 4 * cfg.substeps * (SPARSE_TRAIN_TIMES - 1)
                * cfg.batch_size * SPARSE_ZONES * 4 / 1e9)
    step_s = res["seconds"] / steps
    print(f"train(sparse_world=True): {SPARSE_TRAIN_AGENTS} agents x "
          f"{SPARSE_TRAIN_TIMES} times x {SPARSE_ZONES} zones, batches of "
          f"{cfg.batch_size}, {SPARSE_EPOCHS} epochs ({steps} steps) in "
          f"{res['seconds']:.3f} s, {step_s:.3f} s a step; losses {losses}; "
          f"CSR launches fwd/bwd {counts}; K4f/K4b/K2f/K2b/K3f/K3b {dense}; "
          f"peak device memory {peak:.2f} GB with remat (the no-remat "
          f"estimate of the stage activations alone: {no_remat:.1f} GB) "
          f"[card {card}]", flush=True)
    if counts != [layers * steps] * 2:
        fail(f"train(sparse_world=True) launched the CSR kernels {counts} "
             f"times, expected {layers} each a step")
    if any(dense):
        fail(f"train(sparse_world=True) launched a dense kernel: {dense}")
    if not all(np.isfinite(losses)):
        fail(f"train(sparse_world=True) losses {losses} are not finite")
    info, counts = driven(serve, res["ckpt"],
                          str(OUT / "served_sparse_trained.npz"),
                          n_agents=SPARSE_CHECK_AGENTS, seed=AGENT_SEED,
                          device=dev)
    with np.load(OUT / "served_sparse_trained.npz") as served:
        ids = served["zone_ids"]
    print(f"serve() of the sparse-trained checkpoint: {info['n_agents']} "
          f"agents x {info['num_times']} times in {info['seconds']:.3f} s; "
          f"CSR launches fwd/bwd {counts}", flush=True)
    if counts != [layers, 0] or ids.shape != (SPARSE_CHECK_AGENTS,
                                             SPARSE_TRAIN_TIMES):
        fail(f"serving the sparse-trained model: CSR launches {counts}, ids "
             f"{ids.shape}")
    if ids.min() < 0 or ids.max() >= SPARSE_ZONES:
        fail(f"served ids out of [0, {SPARSE_ZONES})")

    # ---- 32. train(sparse_world=True, method="dopri5") at Z=4,096 ----------
    k57 = (fd.dopri5_step_fused, fd.dopri5_step_vjp_fused)
    before = [k.launches for k in k57]
    cfg = dataclasses.replace(config, method="dopri5", epochs=1)
    shutil.rmtree(OUT / "train_sparse_dopri5", ignore_errors=True)
    res, counts = driven(train, str(OUT / "train_sparse_dopri5"),
                         n_agents=SPARSE_DOPRI5_AGENTS,
                         num_times=SPARSE_TRAIN_TIMES, config=cfg,
                         seed=WORLD_SEED, num_zones=SPARSE_DOPRI5_ZONES,
                         sparse_world=True, device=dev)
    k57_counts = [k.launches - b for k, b in zip(k57, before)]
    steps = SPARSE_DOPRI5_AGENTS // cfg.batch_size
    print(f"train(sparse_world=True, method='dopri5'): "
          f"{SPARSE_DOPRI5_AGENTS} agents x {SPARSE_TRAIN_TIMES} times x "
          f"{SPARSE_DOPRI5_ZONES} zones, {steps} step in "
          f"{res['seconds']:.3f} s; loss {res['final_loss']:.6f}; CSR "
          f"launches fwd/bwd {counts}; K5/K7 launches {k57_counts} "
          f"[card {card}]", flush=True)
    if counts != [layers * steps] * 2:
        fail(f"the sparse discrete-adjoint trainer launched the CSR kernels "
             f"{counts} times, expected {layers} each a step")
    if not (k57_counts[0] > 0 and k57_counts[1] > 0):
        fail(f"the sparse discrete-adjoint trainer did not run K5 / K7: "
             f"{k57_counts}")
    if not np.isfinite(res["final_loss"]):
        fail("the sparse discrete-adjoint trainer's loss is not finite")

    # ---- 33. times ---------------------------------------------------------
    (wh, er, esd, lay), lse, corr, g = main
    bargs = (g, wh, er, esd, lse, corr, lay)
    calls = [lambda: es.gat_edge_csr_forward(wh, er, esd, lay),
             lambda: es.gat_edge_csr_backward(*bargs),
             lambda: es.gat_edge_csr_forward_reference(wh, er, esd, lay),
             lambda: es.gat_edge_csr_backward_reference(*bargs)]
    with torch.no_grad():
        device = [graph_ms(c, 50) for c in calls]
        eager = [cuda_ms(c, 20) for c in calls]
    ms, plain_ms = device[:2], device[2:]
    flops, nbytes = edge_work(wh, er, lay)
    names = ("gat_edge_csr_forward", "gat_edge_csr_backward")
    Zs, _, _, _, _, E = edge_sizes(wh, er, lay)
    for i, (name, fl, nb) in enumerate(zip(names, flops, nbytes)):
        b, by = bound(fl, nb, PEAK_FP32_FLOPS)
        print(f"{name} at Z={Zs}, E={E}: kernel {ms[i]:.4f} ms device "
              f"({eager[i]:.4f} ms eager; {b / ms[i]:.2%} of the {by} bound "
              f"{b:.5f} ms: {fl / 1e6:.1f} MFLOP, {nb / 1e6:.2f} MB), plain "
              f"version {plain_ms[i]:.4f} ms device ({eager[i + 2]:.4f} ms "
              f"eager) [card {card}]", flush=True)
    # the sparse training step, encoder through the kernels and through
    # their plain versions
    data = generate_agent_population(
        config.batch_size, num_times=SPARSE_TRAIN_TIMES, seed=WORLD_SEED,
        num_zones=SPARSE_ZONES, sparse_world=True)
    static = (on(data["zone_features"]), None, on(data["times"]),
              tuple(on(e, torch.long) for e in data["edge_index"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    step, _ = make_step_fns(model, make_optimizer(model, config), config,
                            static)
    walls = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        with (edge_plain() if name == "plain" else contextlib.nullcontext()):
            walls[name].append(cuda_ms(lambda: step(*batch), 2))
    print(f"sparse training step ({config.batch_size} agents x "
          f"{SPARSE_TRAIN_TIMES} times x {SPARSE_ZONES} zones, remat): "
          f"encoder through the CSR kernels {min(walls['kernels']):.3f} ms "
          f"(runs {walls['kernels']}), through their plain versions "
          f"{min(walls['plain']):.3f} ms (runs {walls['plain']}) [card "
          f"{card}]", flush=True)
    # what remat costs a dense plain step: train() takes that step past
    # FUSED_MAX_ZONES; make_step_fns runs GATODE.forward at checkpoint=True
    data = generate_agent_population(
        config.batch_size, num_times=SPARSE_TRAIN_TIMES, seed=WORLD_SEED,
        num_zones=REMAT_DENSE_ZONES)
    zf, adj, ts = (on(data[k]) for k in ("zone_features", "adj", "times"))
    pf, hz, tg = (on(data["person_feats"]), on(data["home_zone"], torch.long),
                  on(data["zone_ids"], torch.long))
    model = build_model(config, 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, config)

    def dense_step(remat):
        opt.zero_grad()
        logits, _ = model(zf, adj, pf, hz, ts, ode_method="rk4",
                          substeps=config.substeps, checkpoint=remat)
        _cross_entropy(logits, tg)[0].backward()
        opt.step()

    walls, peaks = {False: [], True: []}, {False: 0.0, True: 0.0}
    for remat in (False, True, True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls[remat].append(cuda_ms(lambda: dense_step(remat), 2))
        peaks[remat] = max(peaks[remat],
                           torch.cuda.max_memory_allocated() / 1e9)
    print(f"dense plain step ({config.batch_size} agents x "
          f"{SPARSE_TRAIN_TIMES} times x {REMAT_DENSE_ZONES} zones, no "
          f"kernel): checkpoint=True {min(walls[True]):.3f} ms (runs "
          f"{walls[True]}, peak {peaks[True]:.2f} GB), checkpoint=False "
          f"{min(walls[False]):.3f} ms (runs {walls[False]}, peak "
          f"{peaks[False]:.2f} GB): remat x"
          f"{min(walls[True]) / min(walls[False]):.3f} [card {card}]",
          flush=True)
    return [kernel_entry(name, "edge_segment.cu", src, n, e, m, p, fl, nb,
                         PEAK_FP32_FLOPS)
            for name, src, n, e, m, p, fl, nb in zip(
                names, ("edge_segment.py:428", "edge_segment.py:610"),
                main_counts, errs, ms, plain_ms, flops, nbytes)]


# ---- the last four TPU kernels: K0, K8a, K5's bf16 branch, K9e ------------

# the continuous adjoint over the fused pair: held at the config's rtol =
# atol = 1e-5, or at FUSED_PAIR_LOOSE_TOL where its bf16 forward takes more
# than FUSED_PAIR_STEP_RATIO times the steps of phase 7's float32 one (it
# took 186 against 16 at 1e-5: the bf16 stage noise floors the
# controller). There the kernels' route is held against the same pair on
# the plain versions at TRAIN_LOSS_RTOL / TRAIN_COS_MIN, and against phase
# 7's route at FUSED_PAIR_LOSS_RTOL / TRAIN_COS_MIN: its forward rounds the
# drift's weights and activations to bf16 where phase 7's is float32, a
# model apart by the bf16 rounding (loss rel read 2.9e-3 at 1e-5 and
# 3.1e-3 at 1e-3, cosine 0.99992; H100 80GB HBM3, 700 W)
FUSED_PAIR_STEP_RATIO = 2
FUSED_PAIR_LOOSE_TOL = 1e-3
FUSED_PAIR_LOSS_RTOL = 1e-2
# the discrete adjoint with a bf16 forward: the loose tolerance the
# reference keeps that branch for (rtol >= ~1e-3)
K5_BF16_TOL = 1e-3
# K5-bf16's readings also at the deepest drifts, where its bounds are
# widest (checks.DOPRI5_STEP_BF16_BOUNDS)
K5_BF16_READING_SHAPES = ((98_304, 64, 8), (8_192, 64, 7))


def step_operands(model, n, z, dev, seed):
    """The operands of ``rk4_step_fused`` for a model: random states,
    context and bf16 zones from ``seed``, the step of 0.125 at 6.5."""
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        interval_stage_times,
        pack_weights_bf16,
        time_feature_table,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    w = pack_weights_bf16(model)
    x = torch.randn(n, model.agent_dim, device=dev, generator=g)
    h = torch.randn(n, w[2].shape[0], device=dev, generator=g)
    ze = torch.randn(z, model.zone_dim, device=dev, generator=g).bfloat16()
    tf = time_feature_table(torch.from_numpy(
        interval_stage_times(6.5, 0.125, 1)).to(dev), w[3], w[4])
    return x, h, ze, w, tf, 0.125


def k0_check(label, args, control=True, enforce=True):
    """K0 against its plain version on ``args`` (run twice: the same
    bits), the bf16-product control where ``control``. Returns the
    largest |d|."""
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs
    from ananke_abm_tpu_torch.ops.cuda.checks import bf16_product_dot

    with torch.inference_mode():
        got = fs.rk4_step_fused(*args)
        again = fs.rk4_step_fused(*args)
        torch.cuda.synchronize()
        if enforce and not torch.equal(got, again):
            fail(f"K0 {label}: a repeat is not bit-identical")
        want = fs.rk4_step_reference(*args)
        r = compare((got, None), (want, None))
        print(f"K0 {label}: {describe(r)}; repeat bit-identical",
              flush=True)
        if enforce and not agrees(r):
            fail(f"K0 disagrees with its plain version at {label}")
        if control:
            plain_dot, fs._dot = fs._dot, bf16_product_dot
            try:
                c = compare((fs.rk4_step_reference(*args), None),
                            (want, None))
            finally:
                fs._dot = plain_dot
            print(f"K0 {label} control (bf16-rounded products): "
                  f"{describe(c)}", flush=True)
            if enforce and agrees(c):
                fail("the K0 check passes the bf16-product control")
    return r["max"]


def k0_readings(dev):
    """``--readings k0``: K0 against its plain version and the control at
    KERNEL_SHAPES for seeds 0-2; nothing fails on a bound."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )

    for seed in range(3):
        for n, z, nb in KERNEL_SHAPES:
            model = build_model(GATODEConfig(num_blocks=nb), 7, 8,
                                device=dev)
            init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
            k0_check(f"N={n} Z={z} num_blocks={nb} seed={seed}",
                     step_operands(model, n, z, dev, n + seed),
                     enforce=False)


def serving_step_phases(dev, card, served_model, graph, agents, served_ids,
                        k1_rate, main):
    """Phases 34-35: K0 against its plain version (``main``: its rung-1
    operands, substep 0 of phase 4's day), and the per-step rollout
    ``make_pallas_rollout(fuse_decode=False)`` at rung 1 against phase 4's
    K1 rollout and its own plain body. Returns K0's entry of the
    {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        _per_step_body,
        make_pallas_rollout,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs

    # ---- 34. K0 against its plain version --------------------------------
    config = GATODEConfig()
    max_err = 0.0
    for n, z, nb in KERNEL_SHAPES:
        model = build_model(dataclasses.replace(config, num_blocks=nb), 7, 8,
                            device=dev)
        init_params(model, torch.Generator().manual_seed(nb))
        max_err = max(max_err, k0_check(
            f"N={n} Z={z} num_blocks={nb}", step_operands(model, n, z, dev,
                                                          n),
            control=(n, z, nb) == KERNEL_SHAPES[0]))
    max_err = max(max_err, k0_check(
        f"at the main path's operands (N={N_AGENTS}, Z={NUM_ZONES}, "
        f"substep 0)", main))

    # ---- 35. the per-step rollout at rung 1 ------------------------------
    rollout = make_pallas_rollout(served_model, *graph,
                                  substeps=config.substeps)
    fs.rk4_step_fused.launches = 0
    fs.rk4_interval_decode_fused.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = rollout(*agents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fs.rk4_step_fused.launches
    k1_launches = fs.rk4_interval_decode_fused.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = (NUM_TIMES - 1) * config.substeps
    t0 = time.perf_counter()
    rollout(*agents)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    print(f"per-step rollout: {N_AGENTS} agents x {NUM_TIMES} times x "
          f"{NUM_ZONES} zones, K0 launches {launches} (expected {want}), K1 "
          f"launches {k1_launches} (expected 0); wall {wall:.4f} s, again "
          f"{wall2:.4f} s, {N_AGENTS / min(wall, wall2):.0f} agents/s "
          f"against phase 5's K1 rollout {k1_rate:.0f} agents/s; peak "
          f"device memory {peak:.2f} GB [card {card}]", flush=True)
    if launches != want or k1_launches != 0:
        fail(f"the per-step rollout launched K0 {launches} and K1 "
             f"{k1_launches} times, expected {want} and 0")
    if ids.shape != (N_AGENTS, NUM_TIMES) or ids.dtype != torch.int32:
        fail(f"per-step ids {tuple(ids.shape)} {ids.dtype}")
    got = ids.cpu().numpy()
    agree = float(np.mean(got == served_ids))
    print(f"per-step rollout ids vs phase 4's K1 rollout (the same weights "
          f"and agents): agree {agree:.6f} (>= {IDS_MIN})", flush=True)
    if agree < IDS_MIN:
        fail("the per-step rollout disagrees with the interval rollout")
    with torch.inference_mode():
        ref = _per_step_body(served_model, config.substeps,
                             fs.rk4_step_reference)(
            *graph, *(a[:CHECK_AGENTS] for a in agents))
    agree = float(np.mean(ref.cpu().numpy() == got[:CHECK_AGENTS]))
    print(f"per-step rollout ids[:{CHECK_AGENTS}] vs its body on the plain "
          f"step: agree {agree:.6f} (>= {SLICE_IDS_MIN})", flush=True)
    if agree < SLICE_IDS_MIN:
        fail("the per-step rollout disagrees with its plain-step body")
    with torch.inference_mode():
        ms = cuda_ms(lambda: fs.rk4_step_fused(*main), 20)
        plain_ms = cuda_ms(lambda: fs.rk4_step_reference(*main), 3)
    fwd, _ = stage_flops(config.agent_dim, config.zone_dim,
                         config.context_dim, config.hidden_dim, NUM_ZONES,
                         config.num_blocks)
    hrow = 2 * config.context_dim * config.hidden_dim
    flop = (4 * (fwd - hrow) + hrow) * N_AGENTS
    nbytes = N_AGENTS * 4 * (2 * config.agent_dim + config.context_dim)
    print(f"K0 at N={N_AGENTS}: kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} "
          f"TFLOP/s), plain version {plain_ms:.3f} ms [card {card}]",
          flush=True)
    # per agent: read x and h, write x
    return kernel_entry("rk4_step_fused", "fused_step.cu",
                        "fused_step.py:291", launches, max_err, ms, plain_ms,
                        flop, nbytes)


def k8a_checks(dev, n, z, nb, seed, control, enforce=True):
    """K8a against its plain version at one shape (run twice: the same
    bits), the bf16-product control where ``control``. Returns (the
    largest |d|, the operands)."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        bf16_control,
        k8_bounds,
        k8_operands,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
        drift_rhs_fused,
        drift_rhs_reference,
    )

    model = build_model(GATODEConfig(method="dopri5", num_blocks=nb), 7, 8,
                        device=dev)
    init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
    args = k8_operands(model, n, z, dev, seed=n + seed)[:-1]
    tag = f"N={n} Z={z} num_blocks={nb} seed={seed}"
    with torch.inference_mode():
        got = drift_rhs_fused(*args)
        again = drift_rhs_fused(*args)
        torch.cuda.synchronize()
        if enforce and not torch.equal(got, again):
            fail(f"K8a repeat at {tag} is not bit-identical")
        want = drift_rhs_reference(*args)
        ctl = ([("f", bf16_control(drift_rhs_reference, *args))]
               if control else None)
        err = check(f"K8a {tag} (repeat bit-identical)", [("f", got)],
                    [("f", want)], k8_bounds(nb), ctl, enforce)
    return err, args


def k8a_readings(dev):
    """``--readings k8a``: K8a against its plain version and the control
    at K8_SHAPES for seeds 0-2; nothing fails on a bound."""
    for seed in range(3):
        for n, z, nb in K8_SHAPES:
            k8a_checks(dev, n, z, nb, seed, control=True, enforce=False)


def fused_pair_phases(dev, card):
    """Phase 36: K8a against its plain version, then the continuous
    adjoint over the fused pair (K8a forward, K8 backward) at rung 3's
    shape against phase 7's route (``model.rhs`` forward, K8 backward).
    Returns K8a's entry of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _adjoint_loss_fn,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_rhs import (
        drift_rhs_and_vjp,
        drift_rhs_and_vjp_reference,
        drift_rhs_fused,
        drift_rhs_reference,
        make_fused_adjoint_rhs,
    )

    # ---- 36. K8a against its plain version -------------------------------
    max_err, main_args = 0.0, None
    for n, z, nb in K8_SHAPES:
        err, args = k8a_checks(dev, n, z, nb, seed=0,
                               control=(n, z, nb) == K8_SHAPES[0])
        max_err = max(max_err, err)
        main_args = main_args or args

    # ---- 36. the continuous adjoint over the fused pair at rung 3 --------
    config = GATODEConfig(method="dopri5")
    data = generate_agent_population(ADAPT_N, num_times=ADAPT_TIMES,
                                     seed=ADAPT_SEED, num_zones=ADAPT_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(ADAPT_SEED))
    pairs = {"fused pair": make_fused_adjoint_rhs(model),
             "phase 7's route": (None, make_fused_adjoint_rhs(model)[1]),
             "the fused pair on the plain versions": make_fused_adjoint_rhs(
                 model, drift_rhs_and_vjp_reference, drift_rhs_reference)}
    launches = None
    tols = [config.rtol]
    for tol in tols:
        cfg = dataclasses.replace(config, rtol=tol, atol=tol)
        runs = {}
        for name, (fwd, vjp) in pairs.items():
            if "plain" in name:
                # held here, or at FUSED_PAIR_LOOSE_TOL where the bf16
                # forward's steps outnumber phase 7's route's
                held = (tol != config.rtol
                        or runs["fused pair"][2]["n_steps"]
                        <= FUSED_PAIR_STEP_RATIO
                        * runs["phase 7's route"][2]["n_steps"])
                if not held:
                    tols.append(FUSED_PAIR_LOOSE_TOL)
                    break
            stats = {}
            fn = _adjoint_loss_fn(model, cfg, vjp, stats, rhs=fwd)
            drift_rhs_fused.launches = drift_rhs_and_vjp.launches = 0
            model.zero_grad()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = fn(*batch, static)
            loss.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (drift_rhs_fused.launches, drift_rhs_and_vjp.launches)
            fwd_st, bwd_st = stats["forward"], stats["backward"]
            want = ((2 + 6 * fwd_st["n_steps"]) if name == "fused pair"
                    else 0,
                    0 if "plain" in name else sum(2 + 6 * s["n_steps"]
                                                  for s in bwd_st))
            runs[name] = (loss.item(), grads_of(model), fwd_st)
            print(f"{name} at rung 3, rtol = atol = {tol:g}: loss "
                  f"{loss.item():.7f}, forward {fwd_st['n_steps']} steps "
                  f"({fwd_st['n_accepted']} accepted), backward "
                  f"{sum(s['n_steps'] for s in bwd_st)} steps; launches K8a "
                  f"{counts[0]}, K8 {counts[1]} (expected {want[0]}, "
                  f"{want[1]}); loss and gradient wall {wall:.3f} s (host "
                  f"clock, synced) [card {card}]", flush=True)
            if counts != want:
                fail(f"{name} launched K8a / K8 {counts} times, "
                     f"expected {want}")
            if not (np.isfinite(loss.item()) and fwd_st["ok"]
                    and all(s["ok"] for s in bwd_st)):
                fail(f"{name} at rtol {tol:g}: a solve failed")
            if launches is None and name == "fused pair":
                launches = counts[0]
        lf, gf, sf = runs["fused pair"]
        for name, rtol in (("the fused pair on the plain versions",
                            TRAIN_LOSS_RTOL),
                           ("phase 7's route", FUSED_PAIR_LOSS_RTOL)):
            if name not in runs:
                continue
            lp, gp, sp = runs[name]
            cos = (torch.dot(gf.double(), gp.double())
                   / (gf.double().norm() * gp.double().norm())).item()
            rel = abs(lf - lp) / abs(lp)
            print(f"fused pair against {name} at rtol {tol:g}: loss rel "
                  f"{rel:.3e} (<= {rtol}), gradient cosine {cos:.9f} (> "
                  f"{TRAIN_COS_MIN}); attempted forward steps "
                  f"{sf['n_steps']} against {sp['n_steps']}"
                  + ("" if held else f" (> {FUSED_PAIR_STEP_RATIO} x: held "
                     f"at rtol {FUSED_PAIR_LOOSE_TOL:g} below)"), flush=True)
            if held and not (rel <= rtol and cos > TRAIN_COS_MIN):
                fail(f"the fused pair's loss or gradient disagrees with "
                     f"{name}")
    with torch.inference_mode():
        ms = cuda_ms(lambda: drift_rhs_fused(*main_args), 20)
        plain_ms = cuda_ms(lambda: drift_rhs_reference(*main_args), 5)
    fwd, _ = stage_flops(config.agent_dim, config.zone_dim,
                         config.context_dim, config.hidden_dim, ADAPT_ZONES,
                         config.num_blocks)
    flop = fwd * ADAPT_N
    print(f"K8a at N={ADAPT_N} Z={ADAPT_ZONES}: kernel {ms:.3f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain version {plain_ms:.3f} ms "
          f"[card {card}]", flush=True)
    # per agent: read x and h, write f
    nbytes = ADAPT_N * 4 * (2 * config.agent_dim + config.context_dim)
    return kernel_entry("drift_rhs_fused", "fused_rhs.cu", "fused_rhs.py:119",
                        launches, max_err, ms, plain_ms, flop, nbytes)


def k5_bf16_checks(dev, n, z, nb, seed, enforce=True, witness=False):
    """K5's bf16 branch against its plain version at one shape (y1, f1, r5
    and the error sum; run twice: the same bits), K5's float32 kernel on
    the same operands as the control (it rounds no stage); with
    ``witness`` kernel, plain version and control against a float64 run.
    Returns (the largest |d| of y1, f1 and r5, the operands)."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        DOPRI5_STEP_BF16_BOUNDS,
        day_bounds,
        dopri5_operands,
        float64_witness,
    )

    model = build_model(GATODEConfig(num_blocks=nb), 7, 8, device=dev)
    init_params(model, torch.Generator().manual_seed(nb + 10 * seed))
    args, _ = dopri5_operands(model, n, z, dev, seed=n + seed)
    tag = f"N={n} Z={z} num_blocks={nb} seed={seed}"
    bounds = day_bounds(DOPRI5_STEP_BF16_BOUNDS, nb)
    stats = (K5_BF16_TOL, K5_BF16_TOL)

    def outs(fn, precision="bf16", on=args):
        y1, f1, sq, r5 = fn(*on, precision=precision, err_stats=stats)
        return [("y1", y1), ("f1", f1), ("r5", r5), ("err_sum", sq)]

    with torch.no_grad():
        got = outs(fd.dopri5_step_fused)
        again = outs(fd.dopri5_step_fused)
        torch.cuda.synchronize()
        if enforce and not same_bits(got, again):
            fail(f"K5-bf16 repeat at {tag} is not bit-identical")
        want = outs(fd.dopri5_step_reference)
        ctl = outs(fd.dopri5_step_fused, "f32")
        check(f"K5-bf16 {tag} err_stats={stats} (repeat bit-identical)", got,
              want, bounds, ctl, enforce, "K5's float32 kernel")
        err = worst_of(got[:3], want[:3])[1]
        if witness:
            exact = outs(lambda *a, **kw: float64_witness(
                lambda *b: fd.dopri5_step_reference(*b, **kw), *a))
            far = {side: worst_of(o, exact)[0] for side, o in (
                ("kernel", got), ("plain", want), ("control", ctl))}
            print(f"K5-bf16 {tag} against the float64 witness: "
                  + "; ".join(f"{side} {describe_far(w)}"
                              for side, w in far.items()), flush=True)
            if enforce and not within(far["kernel"], bounds):
                fail(f"K5-bf16 lies outside {bounds} of the float64 witness")
            if enforce and within(far["control"], bounds):
                fail("K5-bf16's witness check passes its control")
    return err, args


def bf16_forward_phases(dev, card):
    """Phase 37: K5's bf16 branch against its plain version, then the
    discrete adjoint with a bf16 forward at rung 3's shape and its
    recording (max_accepted 256, ckpt_every 1, the bf16 backward K6) at
    rtol = atol = 1e-3, against the float32-forward route at the same
    tolerance. Returns K5-bf16's entry of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _adjoint_loss_fn,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda.checks import dopri5_operands

    # ---- 37. K5-bf16 against its plain version ---------------------------
    max_err = 0.0
    for n, z, nb in DOPRI5_SHAPES:
        err, _ = k5_bf16_checks(dev, n, z, nb, seed=0,
                                witness=(n, z, nb) == DOPRI5_WITNESS_SHAPE)
        max_err = max(max_err, err)
    if DOPRI5_WITNESS_SHAPE not in DOPRI5_SHAPES:
        k5_bf16_checks(dev, *DOPRI5_WITNESS_SHAPE, seed=0, witness=True)

    # ---- 37. the discrete adjoint with a bf16 forward at rung 3 ----------
    config = GATODEConfig(method="dopri5", rtol=K5_BF16_TOL,
                          atol=K5_BF16_TOL)
    data = generate_agent_population(ADAPT_N, num_times=ADAPT_TIMES,
                                     seed=ADAPT_SEED, num_zones=ADAPT_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(ADAPT_SEED))
    runs, launches = {}, None
    for precision in ("bf16", "f32"):
        stats = {}
        step_impl, step_vjp = fd.make_fused_dopri5_hooks(
            model, precision=precision, bwd_precision="bf16",
            err_stats=(config.rtol, config.atol))
        fn = _adjoint_loss_fn(model, config, None, stats, dict(
            max_accepted=256, ckpt_every=1, store_f="bf16",
            ckpt_dtype="bf16", step_impl=step_impl, step_vjp=step_vjp))
        for k in fd.KERNELS:
            k.launches = 0
        model.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = fn(*batch, static)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in fd.KERNELS]
        fwd = stats["forward"]
        runs[precision] = (loss.item(), grads_of(model), fwd)
        print(f"discrete adjoint with a {precision} forward at rung 3, rtol "
              f"= atol = {K5_BF16_TOL:g} (max_accepted 256, ckpt_every 1, "
              f"bf16 backward): loss {loss.item():.7f}, forward "
              f"{fwd['n_steps']} steps ({fwd['n_accepted']} accepted); "
              f"launches K5/K7/K6 {counts} (expected [{fwd['n_steps']}, 0, "
              f"1]); loss and gradient wall {wall:.3f} s (host clock, "
              f"synced) [card {card}]", flush=True)
        if counts != [fwd["n_steps"], 0, 1]:
            fail(f"the {precision}-forward route launched K5/K7/K6 {counts}")
        if not (np.isfinite(loss.item()) and fwd["ok"]):
            fail(f"the {precision}-forward route: the solve failed")
        if launches is None:
            launches = counts[0]
    (lb, gb, sb), (lf, gf, sf) = runs["bf16"], runs["f32"]
    cos = (torch.dot(gb.double(), gf.double())
           / (gb.double().norm() * gf.double().norm())).item()
    print(f"bf16 forward against the float32 forward at rtol "
          f"{K5_BF16_TOL:g}: loss {lb:.7f} vs {lf:.7f} (rel "
          f"{abs(lb - lf) / abs(lf):.3e}), gradient cosine {cos:.9f} (> "
          f"{TRAIN_COS_MIN}); accepted forward steps {sb['n_accepted']} "
          f"against {sf['n_accepted']}", flush=True)
    if not cos > TRAIN_COS_MIN:
        fail("the bf16-forward gradient disagrees with the float32 forward")
    with torch.no_grad():
        args, _ = dopri5_operands(model, ADAPT_N, ADAPT_ZONES, dev, seed=1)
        kw = dict(precision="bf16", err_stats=(K5_BF16_TOL, K5_BF16_TOL))
        packed = fd.pack_operands(args[3], *args[5:11], precision="bf16")
        ms = cuda_ms(lambda: fd.dopri5_step_fused(*args, packed=packed, **kw),
                     20)
        plain_ms = cuda_ms(lambda: fd.dopri5_step_reference(*args, **kw), 3)
    flop = dopri5_flops(config, ADAPT_ZONES)[0] * ADAPT_N
    da, dc = config.agent_dim, config.context_dim
    # per agent: read x, f0 and h, write y1, f1 and r5 (the error sum is
    # one float)
    nbytes = ADAPT_N * 4 * (5 * da + dc)
    print(f"K5-bf16 at N={ADAPT_N} Z={ADAPT_ZONES}: kernel {ms:.3f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain version {plain_ms:.3f} ms "
          f"[card {card}]", flush=True)
    return kernel_entry("dopri5_step_fused_bf16", "fused_dopri5.cu",
                        "fused_dopri5.py:104", launches, max_err, ms,
                        plain_ms, flop, nbytes)


def segment_checks(dev, kind, e, d, z, seed, enforce=True):
    """K9e against its plain version on one case (int64 ids, and int32 ids
    for the same bits), the unrounded sum as the control. Returns the
    largest |d|."""
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        SEGMENT_BOUNDS,
        segment_operands,
    )

    vals, ids, z = segment_operands(kind, e, d, z, dev, seed)
    tag = f"{kind} E={e} D={d} Z={z} seed={seed}"
    got = es.segment_sum(vals, ids, z)
    again = es.segment_sum(vals, ids.int(), z)
    torch.cuda.synchronize()
    if enforce and not torch.equal(got, again):
        fail(f"K9e repeat at {tag} (int32 ids) is not bit-identical")
    want = es.segment_sum_reference(vals, ids, z)
    kept = (ids >= 0) & (ids < z)
    ctl = torch.zeros_like(want).index_add_(0, ids[kept], vals[kept])
    empty = torch.ones(z, dtype=torch.bool, device=dev)
    empty[ids[kept]] = False
    if enforce and not (got[empty] == 0).all():
        fail(f"K9e at {tag}: an empty segment is not 0")
    return check(f"K9e {tag} ({int(empty.sum())} empty segments, "
                 f"{int((~kept).sum())} ids dropped; repeat bit-identical)",
                 [("out", got)], [("out", want)], SEGMENT_BOUNDS,
                 [("out", ctl)], enforce, "unrounded values")


def segment_readings(dev):
    """``--readings segment``: K9e against its plain version and the
    control at SEGMENT_SHAPES for seeds 0-2; nothing fails on a bound."""
    from ananke_abm_tpu_torch.ops.cuda.checks import SEGMENT_SHAPES

    for seed in range(3):
        for shape in SEGMENT_SHAPES:
            segment_checks(dev, *shape, seed=seed, enforce=False)


def segment_phases(dev, card):
    """Phase 38: K9e against its plain version at SEGMENT_SHAPES, then the
    segment sum at rung 1's and rung 2's sizes, and times. Returns K9e's
    entry of the {"kernels": [...]} line."""
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        SEGMENT_SHAPES,
        segment_operands,
    )

    max_err = max(segment_checks(dev, *shape, seed=0)
                  for shape in SEGMENT_SHAPES)
    sizes = [segment_operands(*shape, dev, seed=1)
             for shape in SEGMENT_SHAPES[:2]]
    es.segment_sum.launches = 0
    outs = [es.segment_sum(v, i, z) for v, i, z in sizes]
    torch.cuda.synchronize()
    launches = es.segment_sum.launches
    for (v, i, z), out in zip(sizes, outs):
        if not torch.isfinite(out).all() or out.shape != (z, v.shape[1]):
            fail("the segment sum is not finite or misshapen")
    if launches != len(sizes):
        fail(f"the segment sums launched K9e {launches} times")
    v, i, z = sizes[0]
    e, d = v.shape
    i32 = i.int()
    kept = (i >= 0) & (i < z)
    kept_ids, kept16 = i[kept], v[kept].bfloat16().float()
    out = torch.zeros(z, d, device=dev)
    ms = graph_ms(lambda: es.segment_sum(v, i32, z), 50)
    plain_ms = cuda_ms(lambda: es.segment_sum_reference(v, i, z), 10)
    library_ms = graph_ms(lambda: out.index_add_(0, kept_ids, kept16), 50)
    nbytes = e * d * 4 + e * 4 + z * d * 4
    print(f"K9e at rung 1 (E={e}, D={d}, Z={z}, int32 ids): kernel "
          f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, device time of a "
          f"CUDA-graph replay), plain version {plain_ms:.4f} ms, index_add_ "
          f"on the same bf16-rounded kept rows {library_ms:.4f} ms [card "
          f"{card}]", flush=True)
    return kernel_entry("segment_sum", "edge_segment.cu",
                        "edge_segment.py:844", launches, max_err, ms,
                        plain_ms, e * d, nbytes, PEAK_FP32_FLOPS,
                        library_ms)


if __name__ == "__main__":
    main()
