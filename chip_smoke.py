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
(K9e); and the schedule-VAE population pipeline (no hand-written kernel):
synthesize, rasterize, fit, sample, the CRF, evaluate, the metric tables
over the native host counters, ``compare_samples`` and the
``rgen_schedule`` CLI; the traj_syn family (the purposes catalog, the
buffer grid, the semi-CRF, the TrajEmbed VAE's train -> generate ->
validate) and the ``ananke`` CLI; the trajectory-ODE families (the
Euler-Maruyama solver, latent_ode's train -> infer -> evaluate, mode_sep's
on the mock world's CSVs). Phases 39-60, which launch no hand-written
kernel, run right after phase 1, on the card and the host while phase 2's
nvcc processes compile (57-60 in a process of their own); the kernel
phases 3-38 follow the build, then phase 56 (the ``ananke`` CLI's GAT-ODE
commands).

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
   (attempted steps) kernel launches per backward interval; each step's
   wall and the best of steps 2-3; then a fourth step under
   ``torch.profiler`` (as every profiled step, device activity alone:
   ``device_busy``): the device's busy and idle share of its wall time
   and its device time by kernel name (the model and optimizer put back
   after it);
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
    with a zone whose adjacency row is all zero) and GAT_GRAPH_SHAPES (a
    dense adjacency; rows without an entry at Z > 64): the output and every
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
    heads of 32 and of 48, which straddle lanes; one head of 64) and
    EDGE_HUB_SHAPE (a hub of 128 edges each way, destinations and sources
    of no edge) within EDGE_FWD_BOUNDS / EDGE_BWD_BOUNDS, repeats that
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
    FUSED_PAIR_STEP_RATIO times phase 7's forward steps; K8a's time (the
    device's, each call captured in a CUDA graph, and per call eager);
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
39. schedule data: ``generate_population_activities(42_817)`` (VISTA's
    person count), its CSV, ``prepare_from_csv`` at a 5-minute grid (L =
    288, P = 7) and ``compute_pds``, each on the host clock;
40. one VAE step at the phase1 and phase2 widths (SCHEDULE_CONFIGS: z 16,
    emb 256, channels [64, 64], kernel 5; phase2 auto_pds with its
    calibration terms) on SCHED_STEP_ROWS rows, dropout off, the same
    carried weights and injected noise on the card and on the CPU: every
    loss component within SCHED_STEP_RTOL, every parameter's gradient at
    cosine > SCHED_STEP_COS_MIN;
41. ``train()`` of phase1 for SCHED_EPOCHS epochs on the card (finite
    losses, ``last.ckpt`` and ``best_val.ckpt``, seconds an epoch, peak
    memory); with PyTorch's deterministic algorithms (cuDNN's too), a run
    of SCHED_EPOCHS - 1 epochs resumed for one more against a straight
    run's last epoch (every log column equal); an
    epoch's wall and one step under torch.profiler; phase2 for one epoch
    (tod, presence and share finite and positive);
42. ``sample()`` of SCHED_SAMPLES schedules by argmax with
    ``reject_all_home`` (agents/s, peak memory, no all-home row); the decode
    ids of the same SCHED_CHECK_Z latents on the card and on the CPU agree
    on >= SCHED_IDS_MIN of entries;
43. ``prepare_crf_data`` over every row, then ``train_crf`` at
    crf_config's batch 32, lr 1e-3, weight decay 1e-4 for CRF_EPOCHS epochs
    on the first CRF_TRAIN_ROWS training rows (cut by the time limit), and
    one of its steps under torch.profiler;
44. ``crf_log_partition`` and the two Viterbi decodes on CRF_CHECK_ROWS
    validation rows, card against CPU: log Z and the paths' scores
    (``crf_path_score``) within CRF_RTOL, no all-home constrained row;
45. ``sample(decode_mode="crf", enforce_nonhome=True)`` of CRF_SAMPLES
    schedules (agents/s, every row holds a non-home state);
46. ``evaluate()`` of phase 42's samples against the grid: the report's
    keys and host seconds;
47. the native host counters (``ops/native.py``, ``csrc/ananke_host.cpp``
    built with g++): ``available()`` required; on phase 39's grid and
    phase 42's 1,048,576 samples every entry point equal to its numpy
    branch (integers and shapes; ``rasterize_fill`` rebuilding the grid
    from its own segments, ``rasterize_frame`` of phase 39's activities
    on both branches equal to the grid), and both walls of each at 1M;
48. ``metric_tables``: all 14 registered metric functions (24 CSVs) over
    the million samples against the grid through the native counters
    (wall, peak RSS), then at TABLES_CHECK_ROWS rows the same CSVs
    byte-equal through the numpy branches (those in a process of their
    own, beside the million's tables: host work off the smoke's longest
    path);
49. ``compare_samples`` of phase 42's and phase 45's samples (two report
    JSONs, the aggregate CSV's two rows); whether matplotlib and click are
    installed; with matplotlib, its plots, ``plot_overview`` and
    ``visualize`` and their PNGs (without it the plot calls are not run);
50. ``python -m ananke_abm_tpu_torch.cli.rgen_schedule`` as subprocesses:
    ``--help`` lists the eleven commands; ``prepare`` of phase 39's CSV
    equal to phase 39's grid and splits; ``compute-pds``, ``fit`` (phase1,
    1 epoch), ``sample-population`` (CLI_SAMPLES), ``eval-population``,
    ``metric-tables``; ``fit --data-parallel`` in one process on the one
    card is the single-device run (fit's train loss within
    MESH_ENTRY_RTOL); each command's wall;
51. the traj_syn family's host copies on phase 39's activities: the
    purposes catalog (``build_purposes_catalog``: LEAD_COLUMNS, 7
    purposes) and the 5-minute buffer grid over 1800 minutes (42,817 x
    360, the last bin Home) through the native and the numpy rasterizer,
    equal; their walls;
52. the semi-CRF at TrajEmbedConfig's full width, card against CPU on
    TRAJ_CHECK_ROWS rows of that grid (P = 7, D = 60; seeded unaries,
    durations and transitions): log Z at both ``allow_self``, the gold
    marginal, the path score and ``semicrf_nll`` (both modes) within
    SEMI_RTOL, the NLL's gradients into the unaries, the durations and A
    at cosine > SEMI_COS_MIN, the decoded labels at both ``allow_self``
    agreeing at SEMI_LABELS_MIN with their path scores within SEMI_RTOL,
    no run longer than Dmax without ``allow_self``; each call's time on
    the card;
53. ``train_traj_embed`` at full width (L = 360, z 16, emb 128, CNN (64,
    64), batch 32), ``semi`` with ``exact_long`` and ``linear``, for
    TRAJ_EPOCHS epochs on the first TRAJ_TRAIN_ROWS persons (a cut of
    depth): finite losses, ``ckpt_best.ckpt`` written, the epoch walls;
    one step of each mode under ``torch.profiler`` (busy share, device
    operations);
54. from phase 53's checkpoints: ``generate_trajectories`` (schedules a
    second) and ``gen_n_val_traj`` of TRAJ_GEN schedules in each decode
    mode (semi, linear, none) against the activities; one chunk decoded
    on the card and on the CPU with the same z (labels at
    SEMI_LABELS_MIN); ``synthesize_vae`` and ``analyze_vae``;
55. ``python -m ananke_abm_tpu_torch.cli.main`` as subprocesses: ``--help``
    lists the seven commands, ``make-purposes`` equal to phase 51's
    catalog, ``traj-embed`` (semi, 1 epoch on the cut) then ``gval-traj``,
    ``traj-embed --data-parallel`` (one process: the single-device run)
    writes its checkpoint,
    ``visualize-combined-traj`` (its PNGs, or a non-zero exit naming
    matplotlib where it is absent), ``info``; each command's wall; then
    each schedule phase's wall;
56. (after the build) ``ananke gatode-train`` (GATODE_CLI_EPOCHS epochs,
    its other options at their defaults) and ``gatode-serve --use-pallas
    on`` / ``off`` as subprocesses of the CLI's main that print their
    kernel launches (K2f, K2b, K3f, K3b, K4f, K4b once a step; K1 47 times
    on, none off); each served grid bit-equal to ``serve()`` in this
    process; the kernel's ids against its plain version's body at
    SLICE_IDS_MIN, and against the float32 body (off) printed;
57. (phases 57-60: the trajectory-ODE families, no hand-written kernel,
    in a process of their own, ``--trajectory-ode``, beside phases 39-55
    and the build; their output printed after phase 55) the GenerativeODE
    at ``GenerativeODEConfig()`` on the two personas, one
    loss-and-gradient through the fixed-grid Euler-Maruyama solver (2,401
    steps, one injected noise tensor) on the card and the CPU: the loss
    components within ODE_RTOL, the positions, mu and logvar's difference
    printed, every parameter's gradient at cosine above ODE_COS_MIN, the
    decoded zone, purpose and mode ids agreeing at ODE_IDS_MIN (on a
    failure, the float64 CPU witness printed);
58. latent_ode ``train()`` at its defaults, LODE_ITERS iterations in calls
    of LODE_STEPS_PER_CALL (a cut of depth): finite totals, the
    checkpoint, the wall an iteration; one more step under
    ``torch.profiler``: busy share and device operations;
59. ``BatchedInferenceEngine``: ``predict_trajectories`` (LODE_SAMPLES
    samples on LODE_EVAL_POINTS times), ``benchmark_performance`` at
    LODE_BATCH_SIZES persons (people/s, ``projected_1M_people_hours``),
    ``evaluate()`` at its defaults;
60. mode_sep on the mock world's CSV family (``write_mock_world_csvs``):
    one ``ModeSepModel`` loss-and-gradient at ``ModeSepConfig()`` card
    against CPU at phase 57's bounds, the travel-margin component within
    ODE_RTOL of the travel points' distances (MODESEP_SCALED), the float64
    witness printed beside it; ``train()`` MODESEP_EPOCHS epochs (RK4) and
    MODESEP_SDE_EPOCHS of the SDE variant (cuts of depth);
    ``run_inference`` and ``evaluate``; the walls.
61. (after phase 56) the GAT-ODE under a one-rank NCCL mesh
    (``init_process_group("nccl")`` at a ``file://`` rendezvous, world 1):
    ``make_sharded_fused_train_step`` against ``make_fused_train_step`` at
    rung 2, two steps each: the single device's loss, accuracy and
    parameters bit for bit, K2f/K2b/K3f/K3b/K4f/K4b once each a step, the
    steps' walls with and without the mesh; ``make_pallas_rollout(mesh)``
    (interval kernel and per-step kernel) and ``make_decoded_rollout(mesh)``
    at rung 1: the single device's ids, K1 47 launches (K0 94), walls;
    ``make_sharded_train_step`` (rk4, and one dopri5 step at
    MESH_DOPRI5_TOL) at SHARDED_N agents against ``make_step_fns`` /
    ``make_adjoint_step_fns``: loss within MESH_LOSS_RTOL, gradient cosine
    above MESH_COS_MIN, the same DOPRI5 steps; ``make_sharded_rollout``
    against ``GATODE.forward``'s argmax (>= IDS_MIN);
62. two processes share the card (``--parallel-rank``), gloo reducing
    their CUDA tensors (probed first: where gloo refuses them the phase
    says so and is left out): the data-parallel fused step on 2 x 16,384
    rows against this process's step on the same 32,768: loss within
    P62_LOSS_RTOL, every parameter's gradient cosine above P62_COS_MIN,
    the accuracy equal, each rank's kernels launched once; the control
    (rank 1's gradient left out of the reduction) must fail them;
63. (in the schedule process, after phase 55) the schedule trainer (one
    epoch of phase1), ``sample`` (CRF_SAMPLES), ``train_crf`` (one epoch
    on CRF_TRAIN_ROWS), ``train_traj_embed`` (linear, one epoch on the
    cut) and ``BatchedInferenceEngine`` (one sample) with ``mesh=`` under a
    one-rank NCCL mesh against their single-device calls: the trainer's
    train columns within MESH_ENTRY_RTOL, the samples' ids equal, the NLL
    and the loss within MESH_ENTRY_RTOL, the engine's ids equal.
64. (in phases 57-60's process, after phase 60, beside the build: the
    schedule process is the smoke's longest path) VISTA cleaning at the real
    survey's population: a seeded raw stops table in VISTA's columns
    (``vista_raw_tables``: VISTA_RAW_PERSONS persons, every cleaning rule
    dropping or changing some), written with ``csv``; ``clean_vista_csv``
    with the persons table (the cleaned CSV's sha256 equal to
    VISTA_CLEAN_SHA256, the JAX package's output, and at least
    VISTA_KEPT_MIN persons kept; the persons each rule drops or changes,
    by the generator's kinds and traits, printed and checked),
    ``sample_population`` at VISTA_FRACS, ``prepare_from_csv`` on the
    288-bin grid and ``sample_coverage_table`` over the nine samples, each
    step's wall;
65. (the same process) ``load_mock_data`` and ``analyze_transitions``
    (their digests equal to MOCK_DATA_SHA256 and TRANSITIONS_SHA256, the
    JAX package's) and the mock-data and coverage plots where matplotlib
    is installed (a line saying they did not run where it is not);
66. (last) the profiling layer on the kernel paths: ``throughput`` of the
    rung-1 rollout (K1) alternated with CUDA events (within
    THROUGHPUT_RTOL of the events' best), ``trace`` of one rollout (the
    Chrome trace holds K1's 47 launches), ``debug_nan_mode`` raising on
    ``torch.log(-1)``, on a NaN gradient and on K0's output for a state
    with one NaN, rung 2's fixed step off, off and under the mode from one
    state with the same bits (walls, the mode's overhead) inside
    ``PhaseTimes`` and logged by ``JsonlLogger``, and an
    ``AsyncCheckpointer`` save of the trainer's parameters and AdamW
    moments with the next step launched before ``wait()``: the file holds
    the state at save, bit for bit.

``python3 chip_smoke.py --parallel`` runs phase 1, builds the kernels and
runs phases 63 (on inputs of its own at PARALLEL_PERSONS persons), 61 and
62 only.

``python3 chip_smoke.py --host-tools`` runs phase 1, builds the kernels
and runs phases 64-66 only.

``python3 chip_smoke.py --schedule`` runs phase 1 and phases 39-60 and
63-65 only, with no CUDA kernel build (their path launches no
hand-written kernel): 57-60 and 64-65 in their own process after 39-55
and 63, so that each set's walls and busy shares are read with the card
and the host to itself (in the whole smoke that process runs beside
39-55 and the build, and both sets' walls and busy shares are read on a
shared card and host); ``--trajectory-ode`` phase 1 and phases 57-60 and
64-65 alone.
``python3 chip_smoke.py --readings`` runs phases 1-2 and then only the
training kernels' checks of phase 10, at DAY_SHAPES and DEPTH_SHAPES for 3
seeds with the control everywhere, printing the readings the bounds were
set from and failing on none of them; then, at WITNESS_SHAPES, the day
kernels, their plain versions and the control each against a float64
witness. ``python3 chip_smoke.py --readings encoder`` prints the same
readings of K4f and K4b, at GAT_SHAPES, GAT_READING_SHAPES and
GAT_GRAPH_SHAPES for 3 seeds, and K4b and its plain version each against a
float64 run;
``--readings dopri5`` those of K5, K7, K6 and K7-bf16 at DOPRI5_SHAPES
and DOPRI5_READING_SHAPES for 3 seeds, with their controls and the float64
witness; ``--readings edge`` those of the CSR edge kernels at EDGE_SHAPES
and EDGE_HUB_SHAPE for 3 seeds with their bf16-feature control;
``--readings dopri5`` also K5-bf16's against K5's float32 kernel and the
float64 witness;
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
``python3 chip_smoke.py --ab-gat DIR [DIR ...]`` builds only the
zone-graph kernels' libraries (``fused_gat.cu``: K4f, K4b;
``edge_segment.cu``: the CSR forward, K9c, K9e), each DIR's beside them
(``DIR+PROBE`` a probe variant, as for ``--ab-train``: K9c's or the CSR
forward's gathers, the forward's max walk, K9e's table adds or the
dependence of its loads on the ids, K4b's walk, every K4b grid's work,
K4f's walk or its epilogue's projection, or ``expf`` taken out), then
prints ptxas's registers and spills of every build, the bits of K4f's
output and every residual, K4b's every gradient, the CSR forward's out and
lse, K9c's three gradients and K9e's sums at GAT_SHAPES, GAT_GRAPH_SHAPES,
EDGE_SHAPES, EDGE_HUB_SHAPE and SEGMENT_SHAPES against this checkout, the
device time of one call of each (a CUDA-graph replay; K4f and K4b also at
a dense adjacency, K4b eager) on rung 2's world and the Z=32,768 sparse
world in the order DIR..., this, this, ...DIR, and this checkout's K4f,
K4b, K9c and K9e grid by grid under ``torch.profiler``. ``--readings
encoder``, ``edge`` and ``segment`` build only these two libraries too.
``python3 chip_smoke.py --ab-k8 DIR [DIR ...]`` builds only K8's library
(``fused_rhs.cu``) and the serving kernels' (``fused_step.cu``, where K8a
lives), each DIR's beside them (``DIR+PROBE`` a probe variant, as for
``--ab-train``), then prints ptxas's registers and spills of every build
(SASS counts of each DIR's K8), the bits of K8's per-row outputs, its
summed gradients and K8a's f at K8_SHAPES against this checkout, and the
per-launch times of K8 and K8a at rung 3's operands in the order DIR...,
this, this, ...DIR. ``python3 chip_smoke.py --ab-dopri5 DIR [DIR ...]``
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
import concurrent.futures
import contextlib
import csv
import dataclasses
import hashlib
import io
import json
import multiprocessing
import os
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
    """One call of ``fn`` (a training step) under torch.profiler, recording
    the device activity alone: prints the device's busy and idle share of
    its wall time (the sum of the device time of its kernels, copies and
    fills, one stream, over the host clock around the synced call) and the
    device time by kernel name, largest first; "not measured" where the
    profiler saw no device time. Returns (busy ms, wall ms, device
    operations), or None where not measured. The device events are summed
    from the profiler's raw results: ``key_averages()`` over a step of
    ~10^5 eager operations takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    torch.cuda.synchronize()
    by_name = {}
    t0 = time.perf_counter()
    if ProfilerActivity.CUDA not in supported_activities():
        # a PyTorch without CUDA: the profiler cannot see a device
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    else:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        raw = getattr(prof.profiler, "kineto_results", None)
        if raw is None:
            fail(f"device busy share, {label}: this PyTorch's profiler has "
                 f"no kineto_results to read the device events from")
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                ms, n = by_name.get(e.name(), (0.0, 0))
                by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    if busy == 0:
        print(f"device busy share, {label}: not measured (the profiler "
              f"recorded no device time in a {wall:.3f} ms step) "
              f"[card {card}]", flush=True)
        return None
    print(f"device busy share, {label}: {busy:.3f} ms of device time in a "
          f"{wall:.3f} ms step (host clock, profiled): busy {busy / wall:.1%}"
          f", idle {1 - busy / wall:.1%} [card {card}]", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"device time by kernel, {label}: " + "; ".join(
        f"{name[:48]} {ms:.3f} ms x{n}" for name, (ms, n) in top[:10]),
        flush=True)
    return busy, wall, launches


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
                        help="compare and time K8 and K8a against those of "
                        "the checkouts at DIR (DIR+PROBE: a probe variant "
                        "of DIR's sources)")
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
    parser.add_argument("--schedule", action="store_true",
                        help="run phase 1 and the host and schedule phases "
                        "39-60 and 63-65 only (no CUDA kernel build)")
    parser.add_argument("--trajectory-ode", action="store_true",
                        help="run phase 1, the trajectory-ODE phases 57-60 "
                        "and the host-tool phases 64-65 only (no CUDA "
                        "kernel build); the smoke and --schedule run them "
                        "so, in a process of their own beside phases "
                        "39-55")
    parser.add_argument("--parallel", action="store_true",
                        help="run phase 1 and the mesh phases 61-63 only")
    parser.add_argument("--host-tools", action="store_true",
                        help="run phase 1, the build and the host-tool and "
                        "profiling phases 64-66 only")
    parser.add_argument("--parallel-rank", nargs=2, metavar=("RANK", "DIR"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--ab-gat", metavar="DIR", nargs="+",
                        help="compare and time the zone-graph kernels "
                        "(K4f, K4b, the CSR pair, K9e) against those of "
                        "the checkouts at DIR (DIR+PROBE: a probe variant "
                        "of DIR's sources)")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this runs on a CUDA card")
    if not (ROOT / "ananke_abm_tpu_torch" / "csrc").is_dir():
        fail(f"no ananke_abm_tpu_torch/csrc beside {Path(__file__).name}: "
             f"run it from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    if args.parallel_rank:
        parallel_rank(int(args.parallel_rank[0]), Path(args.parallel_rank[1]))
        return
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

    if args.trajectory_ode:
        # the phases' CPU runs are batch-2 operations: one thread keeps
        # them off the cores of the process and the build beside them
        torch.set_num_threads(1)
        trajectory_ode_phases(dev, card, OUT, {})
        # the host tools' phases, host work with slack in this process
        root = OUT / "host_tools"
        if root.exists():
            shutil.rmtree(root)
        host_tool_phases(card, root, {})
        return
    if args.schedule:
        # one set after the other: the readings of each alone on the card
        schedule_phases(dev, card)
        finish_trajectory_ode(start_trajectory_ode())
        return
    if args.host_tools:
        # phases 64-65 beside the build of the libraries phase 66 launches
        t0 = time.perf_counter()
        root = OUT / "host_tools"
        if root.exists():
            shutil.rmtree(root)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            building = pool.submit(_build.build_all, HOST_TOOLS_LIBS)
            host_tool_phases(card, root, {})
            built = building.result()
        for name in built:
            _build.load_library(name)
        print(f"build: {len(built)} libraries, "
              f"{time.perf_counter() - t0:.1f} s since it started",
              flush=True)
        profiling_phase(dev, card, rung1_setup(dev), None)
        print(f"--host-tools: phases 1, 64-66 in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if args.parallel:
        t0 = time.perf_counter()
        built = _build.build_all(_build.NAMES)
        for name in built:
            _build.load_library(name)
        print(f"build: {len(built)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        mesh_entry_phase(dev, card, mesh_entry_inputs(dev, OUT / "parallel"))
        mesh_phases(dev, card)
        two_rank_phase(dev, card)
        print(f"--parallel: phases 1, 61-63 in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    # the other checkouts' DOPRI5 or serving kernels compile beside this
    # one's; an A/B of the serving kernels builds only their library
    others = [start_build(Path(d).resolve(), f"other{i}", "fused_step")
              for i, d in enumerate(args.ab_step or ())]
    dopri5_others = []
    for i, d in enumerate(args.ab_dopri5 or ()):
        name, checkout = ab_checkout(d)
        dopri5_others.append((name, [start_build(checkout, f"dopri5{i}", lib)
                                     for lib in DOPRI5_LIBS]))
    k8_others = []
    for i, d in enumerate(args.ab_k8 or ()):
        name, checkout = ab_checkout(d)
        k8_others.append((name, [start_build(checkout, f"k8{i}", lib)
                                 for lib in K8_LIBS]))
    train_others = []
    for i, d in enumerate(args.ab_train or ()):
        name, checkout = ab_checkout(d)
        train_others.append((name, [start_build(checkout, f"train{i}", lib)
                                    for lib in ("fused_step",
                                                "fused_train")]))
    gat_others = []
    for i, d in enumerate(args.ab_gat or ()):
        name, checkout = ab_checkout(d)
        gat_others.append((name, [start_build(checkout, f"gat{i}", lib)
                                  for lib in GAT_LIBS]))
    names = (
        ("fused_step",) if args.ab_step or args.readings == "serving"
        else ("fused_step", "fused_train") if args.ab_train
        else GAT_LIBS + ("fused_step", "fused_train") if args.ab_gat
        else GAT_LIBS if args.readings in ("encoder", "edge", "segment")
        else K8_LIBS if args.ab_k8
        else _build.NAMES)
    smoke = not (args.readings or args.ab_k8 or args.ab_dopri5
                 or args.ab_step or args.ab_train or args.ab_gat)

    def build():
        t = time.perf_counter()
        return _build.build_all(names), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        if smoke:
            # phases 39-60 launch no hand-written kernel: they run on the
            # card and the host while nvcc compiles, 57-60 in a process of
            # their own
            t_sched = time.perf_counter()
            ode = start_trajectory_ode()
            schedule_phases(dev, card)
            print(f"schedule phases 39-55 in "
                  f"{time.perf_counter() - t_sched:.1f} s, beside the build",
                  flush=True)
            finish_trajectory_ode(ode)
            print(f"phases 39-60 in {time.perf_counter() - t_sched:.1f} s, "
                  f"beside the build", flush=True)
        built, t_build = building.result()
    print(f"build: {len(built)} libraries in {t_build:.1f} s (nvcc in "
          f"parallel); {time.perf_counter() - t0:.1f} s since it started")
    for name, (path, log, seconds) in built.items():
        print(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
        for line in ptxas_lines(log):
            print(f"  {line}")
        if not (args.ab_train or args.ab_k8):  # these load their own
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
        ab_k8(dev, built, k8_others)
        return
    if args.ab_dopri5:
        ab_dopri5(dev, built, dopri5_others)
        return
    if args.ab_step:
        ab_step(dev, built["fused_step"][1], others)
        return
    if args.ab_train:
        ab_train(dev, built, train_others)
        return
    if args.ab_gat:
        ab_gat(dev, gat_others)
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
    gatode_cli_phase(card)
    mesh_phases(dev, card, rung1=(served_model, graph, agents))
    two_rank_phase(dev, card)
    profiling_phase(dev, card, (served_model, graph, agents), k1_rate)
    print(f"smoke: phases 1-66 in {time.perf_counter() - t_start:.1f} s, "
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


def rung3_continuous(dev):
    """Phase 7's trainer: a seeded model at GATODEConfig(method="dopri5"),
    its optimizer and ``make_adjoint_step_fns``'s step with its defaults
    (the continuous adjoint, ``use_fused="auto"``) on bench rung 3's data.
    Returns (model, optimizer, step, static, batch)."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
        make_adjoint_step_fns,
        make_optimizer,
    )

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
    opt = make_optimizer(model, config)
    step, _ = make_adjoint_step_fns(model, opt, config, static,
                                    adjoint_mode="continuous",
                                    use_fused="auto")
    return model, opt, step, static, batch


def adjoint_phases(dev, card):
    """Phases 6-9: K8 against its plain version, the trainer at rung 3,
    the kernel trainer against the plain-version trainer, and times.
    Returns K8's entry of the {"kernels": [...]} line and the best wall
    time of a rung-3 training step."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        _adjoint_loss_fn,
        build_model,
        init_params,
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
    model, opt, step, static, batch = rung3_continuous(dev)
    n_params = sum(p.numel() for p in model.parameters())
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
    print(f"continuous step wall: steps "
          f"{', '.join(f'{w:.3f}' for w in walls)} s, best of steps "
          f"2-{TRAIN_STEPS} {min(walls[1:]):.3f} s (host clock, synced) "
          f"[card {card}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses {losses}: not finite and falling")
    with state_kept(model, opt):
        device_busy("phase 7 step (the continuous adjoint, K8)",
                    lambda: step(*batch), card)

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
            # the name without its parameter list (template arguments may
            # hold parentheses: an enum's value prints as "(Kind)4")
            d = d.replace("(anonymous namespace)::", "")
            r[0] = d[:d.rindex("(")] if d.endswith(")") else d
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


# the libraries ``--ab-k8`` builds of every checkout: K8's, and the serving
# kernels', where K8a lives since it moved beside K1, K0 and K2f
K8_LIBS = ("fused_rhs", "fused_step")
# slab counts (CTAs) at which ``--ab-k8`` also times this checkout's K8,
# beside fused_rhs.NUM_SLABS
K8_SLAB_COUNTS = (99, 66)


def k8_libraries(built, handles):
    """{name: {"k8": library, "k8a": library}} of ``--ab-k8``: this
    checkout's from ``built`` (phase 2's build of K8_LIBS), each DIR's from
    its :func:`start_build` handles. K8a is the
    library of each checkout that defines ``ananke_drift_rhs``: the
    serving kernels' here, K8's in a checkout from before K8a moved."""
    import ctypes

    libs = {"this": {}}
    for lib in K8_LIBS:
        so = declare_entries(ctypes.CDLL(str(built[lib][0])))
        so.ananke_cuda_error_string.argtypes = [ctypes.c_int]
        so.ananke_cuda_error_string.restype = ctypes.c_char_p
        libs["this"][lib] = so
    for name, hs in handles:
        libs[name] = {h[4]: finish_build(h, sass=h[4] == "fused_rhs")
                      for h in hs}
    return {name: {"k8": pair["fused_rhs"],
                   "k8a": next(so for so in pair.values()
                               if hasattr(so, "ananke_drift_rhs"))}
            for name, pair in libs.items()}


def ab_k8(dev, built, handles):
    """``--ab-k8 DIR [DIR ...]``: K8 and K8a of this checkout against those
    of each checkout at DIR (``DIR+PROBE`` a probe variant, :data:`PROBES`;
    its ``fused_rhs.cu``, ``fused_step.cu`` and headers, built with the
    port's flags and C interface beside phase 2; ``handles`` from
    :func:`start_build`, two a DIR): ptxas's registers and spills per
    kernel, the bits of K8's per-row outputs (f, gx, gh), its summed
    gradients and K8a's f at every shape of K8_SHAPES, then the per-launch
    times of K8 and K8a at the first shape (rung 3's: 98,304 agents, Z =
    64, 2 blocks) in the order DIR..., this, this, ...DIR (the device's
    time, each launch captured in a CUDA graph, then per call with the
    host's packing and enqueue), this checkout's K8 on K8_SLAB_COUNTS
    CTAs, and the wall of phase 7's continuous step with each checkout's
    K8 in the same order."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_rhs as fr
    from ananke_abm_tpu_torch.ops.cuda.checks import k8_operands

    libs = k8_libraries(built, handles)
    others = [w for w in libs if w != "this"]

    def run(which, kernel, args):
        lib = libs[which][kernel]
        if kernel == "k8":
            with library_of("fused_rhs", lib):
                return fr.drift_rhs_and_vjp(*args)
        with library_of("fused_rhs", lib), library_of("fused_step", lib):
            return fr.drift_rhs_fused(*args[:-1])

    def max_d(a, b):
        return max((u - v).abs().max().item() for (_, u), (_, v) in zip(a, b))

    config = GATODEConfig(method="dopri5")
    main_args = None
    with torch.inference_mode():
        for n, z, nb in K8_SHAPES:
            model = build_model(dataclasses.replace(config, num_blocks=nb), 7,
                                8, device=dev)
            init_params(model, torch.Generator().manual_seed(nb))
            args = k8_operands(model, n, z, dev, seed=n)
            main_args = main_args or args
            k8 = {w: k8_outputs(run(w, "k8", args)) for w in libs}
            k8a = {w: run(w, "k8a", args) for w in libs}
            torch.cuda.synchronize()
            for w in others:
                a, b = k8["this"], k8[w]
                rows = "; ".join(
                    f"{name} {torch.equal(u, v)}"
                    for (name, u), (_, v) in zip(a[:3], b[:3]))
                print(f"K8 / K8a A/B N={n} Z={z} num_blocks={nb}: this "
                      f"against {w}: K8 per-row same bits: {rows} (max |d| "
                      f"{max_d(a[:3], b[:3]):.3e}); summed gradients same "
                      f"bits {same_bits(a[3:], b[3:])} (max |d| "
                      f"{max_d(a[3:], b[3:]):.3e}); K8a f same bits "
                      f"{torch.equal(k8a['this'], k8a[w])} (max |d| "
                      f"{(k8a['this'] - k8a[w]).abs().max().item():.3e})",
                      flush=True)
            del k8, k8a
    card = card_line()
    order = others + ["this", "this"] + others[::-1]
    n, z, nb = K8_SHAPES[0]
    with torch.inference_mode():
        for label, kernel, reps in (("K8", "k8", 20), ("K8a", "k8a", 50)):
            for how, timer in (("device time, CUDA graph", graph_ms),
                               ("per call, eager", cuda_ms)):
                times = {w: [] for w in libs}
                for w in order:
                    times[w].append(timer(
                        lambda: run(w, kernel, main_args), reps))
                print(f"{label} at rung 3's operands (N={n}, Z={z}, "
                      f"num_blocks={nb}) A/B ({how}): "
                      + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                                  for w, t in times.items())
                      + f" ms per launch [card {card}]", flush=True)
        # this checkout's K8 on fewer CTAs: fewer slabs in L2, fewer SMs
        kept, times = fr.NUM_SLABS, []
        counts = (kept, *K8_SLAB_COUNTS, kept)
        try:
            for c in counts:
                fr.NUM_SLABS = c
                times.append(cuda_ms(lambda: run("this", "k8", main_args),
                                     20))
        finally:
            fr.NUM_SLABS = kept
        print(f"K8 [this] at rung 3's operands by slab count (CTAs): "
              + ", ".join(f"{c} {m:.3f}" for c, m in zip(counts, times))
              + f" ms per launch [card {card}]", flush=True)
    # phase 7's step with each checkout's K8, every one from the same
    # parameters and optimizer state
    model, opt, step, _, batch = rung3_continuous(dev)
    step(*batch)  # warm-up
    walls = {w: [] for w in libs}
    for w in order:
        with state_kept(model, opt), library_of("fused_rhs", libs[w]["k8"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batch)[0].item()
            walls[w].append(time.perf_counter() - t0)
    print(f"phase 7's continuous step at rung 3 A/B: "
          + "; ".join(f"{w} {', '.join(f'{t:.3f}' for t in ts)}"
                      for w, ts in walls.items())
          + f" s (host clock, synced) [card {card}]", flush=True)


# the libraries ``--ab-dopri5`` builds of every checkout: the discrete
# adjoint's, and the serving kernels', where K5-bf16 lives since it moved
# onto their template
DOPRI5_LIBS = ("fused_dopri5", "fused_step")


class K5Bf16Before:
    """A checkout's ``fused_dopri5`` library from before K5-bf16 moved to
    the serving kernels' library, as this checkout's K5 wrapper calls it:
    the count of K5-bf16's CTAs, which the wrapper asks the library for,
    from that library's own tile rows (one CTA an SM at most, as its
    wrapper sized them); everything else is the library's."""

    def __init__(self, so, num_blocks):
        self.so, self.num_blocks = so, num_blocks

    def __getattr__(self, name):
        return getattr(self.so, name)

    def ananke_dopri5_step_bf16_ctas(self, n):
        from ananke_abm_tpu_torch.ops.cuda.fused_dopri5 import VJP_CTAS

        rows = self.so.ananke_dopri5_tile_rows(self.num_blocks, 3)
        return min(VJP_CTAS, -(-n // rows))


def ab_dopri5(dev, built, handles):
    """``--ab-dopri5 DIR [DIR ...]``: the step K5 (float32 and bf16), the
    step VJP K7 (float32 and bf16) and the whole backward K6 (bf16 and
    float32 bodies) of this checkout against those of each checkout at DIR
    (``DIR+PROBE`` a probe variant, :data:`PROBES`; its
    ``csrc/fused_dopri5.cu`` and ``csrc/fused_step.cu`` and headers, built
    with the port's flags and C interface; ``handles`` from
    :func:`start_build`, started before phase 2; K5-bf16 from whichever of
    a checkout's two libraries exports it): ptxas's registers and spills
    per kernel, the bits at every shape of DOPRI5_SHAPES, then the
    per-launch times at the main path's operands (K6 on the recording of a
    rung-3 step at its own settings; K5 and K7 at phase 19's shape, which
    is rung 3's: 98,304 agents, Z = 64, 2 blocks; K5 with the error sum
    the controller reads) in the order DIR..., this, this, ...DIR."""
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

    for lib in DOPRI5_LIBS:
        print(f"build [this]: "
              f"{ROOT / 'ananke_abm_tpu_torch/csrc' / (lib + '.cu')}")
        for line in ptxas_lines(built[lib][1]):
            print(f"  {line}")
    libs = {"this": {lib: _build.load_library(lib) for lib in DOPRI5_LIBS}}
    for name, hs in handles:
        libs[name] = {h[4]: finish_build(h) for h in hs}
    others = [w for w in libs if w != "this"]

    def run(which, nb, fn, *a, **kw):
        pair = libs[which]
        k5 = pair["fused_step"]
        if not hasattr(k5, "ananke_dopri5_step_bf16"):
            k5 = K5Bf16Before(pair["fused_dopri5"], nb)
        with library_of("fused_dopri5", pair["fused_dopri5"]), \
                library_of("fused_step", k5):
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
                out = {w: outputs(run(w, nb, fn, *a, precision=prec))
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
    nb = len(args[8])
    with torch.no_grad():
        for label, fn, fa, prec, packs, reps, *kw in timed:
            kw = kw[0] if kw else {}
            times = {w: [] for w in libs}
            for w in order:
                times[w].append(cuda_ms(lambda: run(
                    w, nb, fn, *fa, precision=prec, packed=packs[prec], **kw),
                    reps))
            print(f"{label} (N={ADAPT_N}, Z={ADAPT_ZONES}) A/B: "
                  + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                              for w, t in times.items())
                  + f" ms per launch [card {card}]", flush=True)


# Probes of ``--ab-train``, ``--ab-dopri5``, ``--ab-k8`` and ``--ab-gat``:
# a DIR written
# ``DIR+NAME`` is DIR's ``ananke_abm_tpu_torch/csrc`` with NAME's
# substitutions (file, regular expression, replacement; each must match),
# built under ``OUT/variants/``. Each but ``k3f1`` takes one
# cost out of the kernels it reaches, and their results are wrong by design
# and only timed. What each reaches in this checkout:
# - ``noproducts``, ``constb``: mma_bf16.cuh's mma.sync and its __ldg
#   loads. ``noproducts`` reaches the products of every mma.sync kernel
#   (stage_sm90.cuh's K2b, K6/K7-bf16 and K8; K3f and K3b), not the
#   serving template's wgmma (K1, K0, K2f, K8a, K5-bf16). ``constb``
#   reaches K3b's d and gx products and the bias reads of stage_sm90.cuh
#   and of the serving template: no kernel's weight boxes any more. In a
#   checkout from before a kernel's redesign both reach its per-warp
#   L2-fed products (drift_stage.cuh's stage forward: K5-bf16 before it
#   moved to fused_step.cu; K3f's first design).
# - ``noslab``: the slab traffic of the summed gradients (K2b, K6/K7-bf16,
#   K8; K3b's zones past its resident ones).
# - ``nomath``: the expf / tanhf of stage_sm90.cuh, fused_train.cu (K3f,
#   K3b) and fused_dopri5.cu's float32 bodies (K5, K7, K6 at "f32"); in a
#   checkout from before K5-bf16's move also drift_stage.cuh's.
# - ``nofma``, ``constw``, ``onebar``: fused_dopri5.cu's ``mm``, K5's
#   products before its redesign, which K7's and K6's float32 body share;
#   ``nomma``, ``nocopy``: K5's 3xTF32 products and its ring's copies.
# - ``w4``: K2b at 4 warps; ``f4``: K2f in 4-warp CTAs.
# - ``k3f1``: K3f on one CTA an SM where it takes three. A design
#   alternative, right by design.
# - ``k9nogather``, ``k4chunk``, ``k4empty``, ``noexp`` (``--ab-gat``):
#   K9c's dependent gathers, K4b's walk past 64 rows or entries, every K4b
#   grid's work, and the expf of fused_gat.cu and edge_segment.cu (K4f,
#   K4b, the CSR pair).
# - ``k9fnogather``, ``k9fonepass`` (``--ab-gat``): the CSR forward's
#   dependent gathers (each edge's source row and scalars) and its max pass
#   over a row's edges.
# - ``k9enoadd``, ``k9epred`` (``--ab-gat``): K9e's adds into its
#   shared-memory tables, and the dependence of its value loads on the ids
#   (taken out before its redesign, put back since).
# - ``k4fchunk``, ``k4fnoproj`` (``--ab-gat``): K4f's attention walks past
#   their first 64 columns (before its redesign) or its sums' walk past 64
#   entries of each 32-word group (since), and the next layer's projection
#   in its attention grid's epilogue.
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
           ("fused_step.cu", r"launch<(false, true|Kind::kDay)>\(",
            r"launch<\1, 4>(")],
    # K3f on one CTA an SM where it takes three
    "k3f1": [("fused_train.cu",
              r"constexpr int kCeFwdCtas = 3 \* kCeCtas;",
              "constexpr int kCeFwdCtas = kCeCtas;")],
    # K9c gathers row 0's features and scalars in place of each edge's
    # other end: what its dependent gathers cost
    # (before its redesign: each edge's index; since: each batch's)
    "k9nogather": [("edge_segment.cu",
                    r"(const long [ij] = )b\.(?:src|dst_by_src)\[p\];|"
                    r"(const long e = )__shfl_sync\(kFull, batch, [^;]*;",
                    r"\g<1>\g<2>0;")],
    # K4b's row and column passes walk their first 64 rows (before its
    # redesign) or 64 entries of each 32-word group of a list (since)
    "k4chunk": [("fused_gat.cu",
                 r"(?:(al_neg\[NH\] = \{[^}]*\};\s*for \(int j0 = 0; "
                 r"j0 < )(p\.z)|(for \(int i0 = 0; i0 < )(p\.z)|"
                 r"(t0 < )(walk\.total))(;)",
                 r"\g<1>\g<3>\g<5>min(\g<2>\g<4>\g<6>, 64)\g<7>")],
    # every grid of K4b returns on entry: the floor of its launches (its
    # slab sum on reduce_slabs.cuh since its redesign)
    "k4empty": [("fused_gat.cu",
                 r"((?:gat_bwd_\w+|gat_reduce)_kernel\([^)]*\) \{)",
                 "\\g<1>\n  return;"),
                ("reduce_slabs.cuh", r"(void reduce_slabs\([^)]*\) \{)",
                 "\\g<1>\n  return;")],
    # the CSR forward gathers source row 0's scalars and features in place
    # of each edge's source: what its dependent gathers cost (before its
    # redesign each edge's index load went too; since, the batch's stays)
    "k9fnogather": [("edge_segment.cu",
                     r"(const long j = )(?:src\[p\]|"
                     r"__shfl_sync\(kFull, idx, [^;]*\));", r"\g<1>0;")],
    # the CSR forward without its max pass (m = 0): what its first walk
    # over a row's edges costs
    "k9fonepass": [("edge_segment.cu", r"m\[k\] = -INFINITY;", "m[k] = 0.f;"),
                   ("edge_segment.cu",
                    r"m\[k\] = fmaxf\(m\[k\], lrelu\(er\[k\] \+ "
                    r"(?:e_send\[j \* H \+ ln\.h\[k\]\]|sc\[u\]\[k\])\)\);",
                    "(void)0;")],
    # K9e's table adds become a register sum that keeps the loads live:
    # what its shared-memory read-modify-writes cost
    "k9enoadd": [("edge_segment.cu",
                  r"(float v\[kSegUnroll\];|const unsigned rel = "
                  r"min\(\(unsigned\)b\.id[^;]*;)",
                  r"\g<1> float probe_sum = 0.f;"),
                 ("edge_segment.cu",
                  r"mine\[ru \* d \+ col\] \+= (v\[u\]|x);",
                  r"probe_sum += \g<1>;" "\n"
                  r"        if (probe_sum == 1.2345e-30f) mine[col] = "
                  r"probe_sum;")],
    # what the id -> value dependence of K9e's loads costs: before its
    # redesign, the values loaded whatever their id; since, each value's
    # load waits for its row's id, as it did before (either way a design
    # alternative, right by design)
    "k9epred": [("edge_segment.cu", r"b\.v\[u\] = cv && u < left \?",
                 "b.v[u] = (__shfl_sync(kFull, b.id, u) != -2) & cv && "
                 "u < left ?")],
    # K4f's attention grid walks the first 64 columns of each row (before
    # its redesign: both passes over all Z) or its sums' walk over 64
    # entries of each 32-word group of its list (since)
    "k4fchunk": [("fused_gat.cu",
                  r"(?:(for \(int j = lane & 15; j < |"
                  r"for \(int j0 = 0; j0 < )(p\.z)|"
                  r"(max\(0, min\(32, )(walk\.total))(;| - t0\))",
                  r"\g<1>\g<3>min(\g<2>\g<4>, 64)\g<5>")],
    # K4f's attention grid does not project its output for the next layer:
    # what the epilogue's project_row costs (its W still copied)
    "k4fnoproj": [("fused_gat.cu",
                   r"(if \()(?:has_next|row_ok)(\)\s*project_row\(p, "
                   r"k \+ 1)",
                   r"\g<1>false\g<2>")],
    # no expf in the zone-graph kernels (edge_segment.cu, fused_gat.cu):
    # the identity in its place
    "noexp": [(f, pattern, repl) for f in ("edge_segment.cu", "fused_gat.cu")
              for pattern, repl in (
                  (r"namespace \{", "namespace {\n__device__ "
                   "__forceinline__ float probe_id(float x) { return x; }"),
                  (r"\bexpf\(", "probe_id("))],
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


def gat_fwd_outputs(out, res, num_layers, z):
    """(name, tensor) of K4f's output and every residual it writes
    (``gat_forward_fused``'s): each layer's input H, WH, ST (e_src, e_dst,
    row max, row sum), GX (attention output, normalised x) and RS's first
    ``num_layers * z`` floats (1 / std; the rest is the forward's lists of
    the graph's entries, which a checkout from before them leaves
    unwritten)."""
    return [("out", out), ("H", res[1]), ("WH", res[2]), ("ST", res[3]),
            ("GX", res[4]), ("RS", res[5].reshape(-1)[:num_layers * z])]


# the libraries ``--ab-gat`` builds of every checkout: the dense zone
# encoder's (K4f, K4b) and the CSR edge kernels' with the segment sum (the
# CSR forward, K9c, K9e)
GAT_LIBS = ("fused_gat", "edge_segment")


def ab_gat(dev, handles):
    """``--ab-gat DIR [DIR ...]``: the zone-graph kernels of this checkout
    against those of each checkout at DIR (``DIR+PROBE`` a probe variant,
    :data:`PROBES`; its ``fused_gat.cu`` and ``edge_segment.cu`` and
    headers, built with the port's flags and C interface; ``handles`` from
    :func:`start_build`, two a DIR): ptxas's registers and spills per
    kernel, the bits of K4f's output and every residual
    (:func:`gat_fwd_outputs`) and K4b's every gradient at GAT_SHAPES and
    GAT_GRAPH_SHAPES, of the CSR forward and of K9c's d_wh,
    d_recv and d_send (fed this checkout's forward) at checks.EDGE_SHAPES
    and the hub graph, and of K9e at checks.SEGMENT_SHAPES; then the
    device time of one call (a CUDA-graph replay) of K4f and K4b on rung
    2's zone world (Z = 500, 2 layers; both also at a dense adjacency, K4b
    also eager), of the CSR forward and K9c on the sparse world (Z =
    32,768) and of K9e at rung 1, in the order DIR..., this, this,
    ...DIR; then this checkout's K4f, K4b, K9c and K9e under
    torch.profiler, device time by kernel name; then phase 17's rung-2
    training step and phase 33's sparse training step with each
    checkout's kernels, in the same order (the rung-2 step also runs this
    checkout's day and decode kernels, whose libraries build beside the
    others)."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_fused_loss_fn,
    )
    from ananke_abm_tpu_torch.ops.cuda import _build
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        EDGE_HUB_SHAPE,
        EDGE_SHAPES,
        SEGMENT_SHAPES,
        edge_operands,
        gat_grad_outputs,
        segment_operands,
    )

    libs = {"this": {lib: _build.load_library(lib) for lib in GAT_LIBS}}
    for name, hs in handles:
        libs[name] = {h[4]: finish_build(h) for h in hs}
    others = [w for w in libs if w != "this"]

    def run(which, fn, *a):
        with library_of("fused_gat", libs[which]["fused_gat"]), \
                library_of("edge_segment", libs[which]["edge_segment"]):
            return fn(*a)

    def report(label, outs):
        for w in others:
            x, y = outs["this"], outs[w]
            differ = [n for (n, u), (_, v) in zip(x, y)
                      if not torch.equal(u, v)]
            diff = max((u - v).abs().max().item()
                       for (_, u), (_, v) in zip(x, y))
            which = f" (not: {', '.join(differ)})" if differ else ""
            print(f"{label}: this against {w}: same bits {not differ}"
                  f"{which} (max |d| {diff:.3e})", flush=True)

    def encoder(z, f, num_layers, isolated, density):
        return encoder_operands(dev, z, f, num_layers, isolated, 0, density)

    with torch.no_grad():
        for z, f, num_layers, isolated, *dens in (
                [(*s, 0.1) for s in GAT_SHAPES] + list(GAT_GRAPH_SHAPES)):
            args, g = encoder(z, f, num_layers, isolated, dens[0])
            bargs = (*args[:3], g, *args[3:])
            fwd = {w: run(w, fg.gat_forward_fused, *args) for w in libs}
            tag = (f"Z={z} F={f} layers={num_layers} isolated={isolated} "
                   f"density={dens[0]}")
            report(f"K4f A/B {tag}", {w: gat_fwd_outputs(o, r, num_layers, z)
                                      for w, (o, r) in fwd.items()})
            report(f"K4b A/B {tag}", {
                w: gat_grad_outputs(run(w, fg.gat_backward_fused, *bargs,
                                        fwd[w][1]), num_layers)
                for w in libs})
            del fwd
        names = ("d_wh", "d_recv", "d_send")
        for kind, z, heads, d in EDGE_SHAPES + (EDGE_HUB_SHAPE,):
            (wh, er, esd, lay), g = edge_operands(kind, z, heads, d, dev, 0)
            tag = (f"{kind} Zs={z} E={lay.src.numel()} H={heads} d={d}")
            fwd = {w: run(w, es.gat_edge_csr_forward, wh, er, esd, lay)
                   for w in libs}
            report(f"CSR forward A/B {tag}",
                   {w: [("out", o), ("lse", l)] for w, (o, l) in fwd.items()})
            out, lse = fwd["this"]
            bargs = (g, wh, er, esd, lse, torch.sum(g * out, dim=-1), lay)
            report(f"K9c A/B {tag}", {
                w: list(zip(names, run(w, es.gat_edge_csr_backward, *bargs)))
                for w in libs})
        for shape in SEGMENT_SHAPES:
            v, i, z = segment_operands(*shape, dev, seed=0)
            report(f"K9e A/B {shape[0]}", {
                w: [("out", run(w, es.segment_sum, v, i, z))] for w in libs})
        torch.cuda.synchronize()

    card = card_line()
    order = others + ["this", "this"] + others[::-1]
    main_args, main_g = encoder(TRAIN_ZONES, 7, 2, None, 0.1)
    dense_args, dense_g = encoder(*GAT_GRAPH_SHAPES[0])
    (wh, er, esd, lay), g = edge_operands("world", SPARSE_ZONES, 4, 16, dev,
                                          0)
    with torch.no_grad():
        out, lse = es.gat_edge_csr_forward(wh, er, esd, lay)
        ebargs = (g, wh, er, esd, lse, torch.sum(g * out, dim=-1), lay)
        seg = segment_operands(*SEGMENT_SHAPES[0], dev, seed=1)
        res = {w: {key: run(w, fg.gat_forward_fused, *a)[1]
                   for key, a in (("main", main_args), ("dense", dense_args))}
               for w in libs}
        bwd = lambda a, cot, r: (*a[:3], cot, *a[3:], r)
        timed = [
            ("K4f on rung 2's world (Z=500, 2 layers)", graph_ms,
             lambda w: run(w, fg.gat_forward_fused, *main_args), 50),
            ("K4f at a dense adjacency (Z=500, 2 layers)", graph_ms,
             lambda w: run(w, fg.gat_forward_fused, *dense_args), 20),
            ("K4b on rung 2's world (Z=500, 2 layers)", graph_ms,
             lambda w: run(w, fg.gat_backward_fused,
                           *bwd(main_args, main_g, res[w]["main"])), 50),
            ("K4b on rung 2's world, eager", cuda_ms,
             lambda w: run(w, fg.gat_backward_fused,
                           *bwd(main_args, main_g, res[w]["main"])), 20),
            ("K4b at a dense adjacency (Z=500, 2 layers)", graph_ms,
             lambda w: run(w, fg.gat_backward_fused,
                           *bwd(dense_args, dense_g, res[w]["dense"])), 20),
            (f"CSR forward on the sparse world (Z={SPARSE_ZONES}, "
             f"E={lay.src.numel()})", graph_ms,
             lambda w: run(w, es.gat_edge_csr_forward, wh, er, esd, lay), 50),
            (f"K9c on the sparse world (Z={SPARSE_ZONES}, "
             f"E={lay.src.numel()})", graph_ms,
             lambda w: run(w, es.gat_edge_csr_backward, *ebargs), 50),
            (f"K9e at rung 1 ({SEGMENT_SHAPES[0][1]} rows)", graph_ms,
             lambda w: run(w, es.segment_sum, *seg), 50),
        ]
        for label, timer, call, reps in timed:
            times = {w: [] for w in libs}
            for w in order:
                times[w].append(timer(lambda: call(w), reps))
            print(f"{label} A/B: "
                  + "; ".join(f"{w} {', '.join(f'{m:.4f}' for m in t)}"
                              for w, t in times.items())
                  + f" ms a call [card {card}]", flush=True)
        # this checkout's grids one by one: device time by kernel name
        for label, _, call, _ in (timed[0], timed[2], timed[6], timed[7]):
            device_busy(f"{label}, 10 calls [this]",
                        lambda: [call("this") for _ in range(10)], card)
    # end to end, each checkout's zone-graph kernels in turn: phase 17's
    # fixed training step at rung 2 (K4f and K4b inside the fused step) and
    # phase 33's sparse training step (the CSR pair), CUDA events around
    # 3 and 2 steps after a warm-up
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)
    model, opt, static, batch = rung2_trainer(dev, config)
    loss_fn = build_fused_loss_fn(model, config, *static)

    def rung2_step():
        opt.zero_grad()
        loss_fn(*batch)[0].backward()
        opt.step()

    sparse_config = GATODEConfig()
    sparse_step, sparse_batch = sparse_trainer(dev, sparse_config)
    for label, fn, reps in (
            (f"phase 17's fixed training step at rung 2 ({TRAIN_N} agents)",
             rung2_step, 3),
            (f"phase 33's sparse training step ({sparse_config.batch_size} "
             f"agents x {SPARSE_TRAIN_TIMES} times x {SPARSE_ZONES} zones)",
             lambda: sparse_step(*sparse_batch), 2)):
        run("this", fn)  # warm-up
        walls = {w: [] for w in libs}
        for w in order:
            walls[w].append(run(w, cuda_ms, fn, reps))
        print(f"{label} A/B: "
              + "; ".join(f"{w} {', '.join(f'{m:.3f}' for m in t)}"
                          for w, t in walls.items())
              + f" ms a step [card {card}]", flush=True)


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


def rung2_trainer(dev, config):
    """(model, optimizer, static, batch) of the fixed-step trainer at bench
    rung 2 (phases 11-13 and 17): 32,768 agents x 500 zones x 12 times,
    seeded weights, AdamW as bench.py's optax.adamw(1e-3) (betas (0.9,
    0.999), eps 1e-8, decoupled weight decay 1e-4)."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        build_model,
        init_params,
    )

    data = generate_agent_population(TRAIN_N, num_times=TRAIN_TIMES,
                                     seed=TRAIN_SEED, num_zones=TRAIN_ZONES)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    static = (on(data["zone_features"]), on(data["adj"]), on(data["times"]))
    batch = (on(data["person_feats"]), on(data["home_zone"], torch.long),
             on(data["zone_ids"], torch.long))
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(TRAIN_WEIGHT_SEED))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    return model, opt, static, batch


def fixed_step_phases(dev, card):
    """Phases 10-13: K2f, K2b, K3f and K3b against their plain versions,
    the fixed-step trainer at rung 2, the kernel trainer against the
    plain-version trainer, and times. Returns the four kernels' entries of
    the {"kernels": [...]} line and (model, config, static, batch,
    optimizer) of the rung-2 trainer."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_fused_loss_fn,
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
    model, opt, static, batch = rung2_trainer(dev, config)
    n_params = sum(p.numel() for p in model.parameters())
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
# the encoder checks past GAT_SHAPES, with the graph's density: rung 2's
# zone count with every adjacency entry on (the lists of K4b's passes full
# length), and rows without an entry at Z > 64 (every column walks them)
GAT_GRAPH_SHAPES = ((500, 7, 2, None, 1.0), (300, 7, 2, (0, 17, 150), 0.1))
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


def encoder_operands(dev, z, f, num_layers, isolated, seed, density=0.1):
    """``gat_operands`` at one shape (``isolated``: a row or a tuple of
    rows); at the main path's shape, rung 2's own zone world."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.ops.cuda.checks import gat_operands

    graph = None
    if isinstance(isolated, tuple):
        isolated = list(isolated)
    elif (z, f, isolated, density) == (TRAIN_ZONES, 7, None, 0.1):
        world = generate_agent_population(1, num_times=TRAIN_TIMES,
                                          seed=TRAIN_SEED,
                                          num_zones=TRAIN_ZONES)
        graph = tuple(torch.as_tensor(world[k]) for k in ("zone_features",
                                                          "adj"))
    return gat_operands(z, f, num_layers, dev, seed, isolated, graph,
                        density)


def encoder_kernel_checks(dev, z, f, num_layers, isolated, seed, control,
                          enforce=True, witness=False, density=0.1):
    """K4f and K4b against their plain versions at one shape (a graph of
    ``density``), each run twice (the same bits), with the TF32 control
    where ``control``; with ``witness``, kernel and plain version each
    against a float64 run too. Returns (the largest |d| of each kernel,
    (operands, residuals, cotangent))."""
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

    args, g = encoder_operands(dev, z, f, num_layers, isolated, seed,
                               density)
    tag = (f"Z={z} F={f} layers={num_layers} isolated={isolated} "
           f"density={density} seed={seed}")
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
    the TF32 control at every shape of GAT_SHAPES, GAT_READING_SHAPES and
    GAT_GRAPH_SHAPES (a dense graph, rows without an entry at Z > 64) for
    seeds 0-2, printed against the bounds; nothing fails on a bound."""
    for seed in range(3):
        for z, f, num_layers, isolated, *density in (
                GAT_SHAPES + GAT_READING_SHAPES + GAT_GRAPH_SHAPES):
            encoder_kernel_checks(dev, z, f, num_layers, isolated, seed,
                                  control=True, enforce=False, witness=True,
                                  density=density[0] if density else 0.1)


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
    for z, f, num_layers, isolated, *density in (GAT_SHAPES
                                                 + GAT_GRAPH_SHAPES):
        e, operands = encoder_kernel_checks(
            dev, z, f, num_layers, isolated, seed=0, control=True,
            density=density[0] if density else 0.1)
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
                       enforce=True, witness=False):
    """The CSR forward and backward against their plain versions at one
    shape (``checks.edge_operands``), each run twice (the same bits), with
    the bf16-feature control; with ``witness``, kernel and plain version
    each against the plain version in float64 on the same operands too.
    Returns (the largest |d| of each kernel, (operands, lse, corr,
    cotangent))."""
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
        want_f, want_lse = es.gat_edge_csr_forward_reference(wh, er, esd,
                                                              lay)
        # the control moves out only: lse reads no feature
        ctl = ([("out", es.gat_edge_csr_forward_reference(
            bf16_features(wh), er, esd, lay)[0])] if control else None)
        e_f = check(f"CSR forward {tag} (repeat bit-identical)",
                    [("out", out), ("lse", lse)],
                    [("out", want_f), ("lse", want_lse)], EDGE_FWD_BOUNDS,
                    ctl, enforce, kind_c)
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
        if witness:
            up = lambda *a: [t.double() for t in a]
            exact_f = es.gat_edge_csr_forward_reference(*up(wh, er, esd),
                                                        lay)[0]
            exact_b = list(zip(names, es.gat_edge_csr_backward_reference(
                *up(*bargs[:-1]), lay)))
            for label, k_out, p_out, exact in (
                    ("CSR forward", [("out", out)], [("out", want_f)],
                     [("out", exact_f)]),
                    ("CSR backward", got, want, exact_b)):
                print(f"{label} {tag} against the float64 witness: kernel "
                      f"{describe_far(worst_of(k_out, exact)[0])}; plain "
                      f"{describe_far(worst_of(p_out, exact)[0])}",
                      flush=True)
    return (e_f, e_b), ((wh, er, esd, lay), lse, corr, g)


def edge_readings(dev):
    """``--readings edge``: the CSR kernels against their plain versions
    and the bf16-feature control at every shape of EDGE_SHAPES and the hub
    graph for seeds 0-2, printed against the bounds, and kernel and plain
    version each against a float64 run; nothing fails on a bound."""
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        EDGE_HUB_SHAPE,
        EDGE_SHAPES,
    )

    for seed in range(3):
        for shape in EDGE_SHAPES + (EDGE_HUB_SHAPE,):
            edge_kernel_checks(dev, *shape, seed, enforce=False,
                               witness=True)


def close(name, got, want, tol):
    """Fail unless |got - want| <= atol + rtol |want| everywhere; returns
    the largest |got - want|."""
    rtol, atol = tol
    d = (got - want).abs()
    err = d.max().item() if d.numel() else 0.0
    if not bool((d <= atol + rtol * want.abs()).all()):
        fail(f"{name}: |d| up to {err:.3e} outside rtol {rtol}, atol {atol}")
    return err


def sparse_trainer(dev, config):
    """(step, batch) of phase 33's sparse training step: ``make_step_fns``
    at the Z = 32,768 sparse world, one batch of ``config.batch_size``
    agents x 12 times, seeded weights."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        build_model,
        init_params,
        make_optimizer,
        make_step_fns,
    )

    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
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
    return step, batch


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
        serve,
        train,
    )
    from ananke_abm_tpu_torch.ops.cuda import edge_segment as es
    from ananke_abm_tpu_torch.ops.cuda import fused_dopri5 as fd
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.checks import (
        EDGE_HUB_SHAPE,
        EDGE_SHAPES,
    )
    from ananke_abm_tpu_torch.ops.segment import edges_from_adj
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint, \
        save_checkpoint

    config = GATODEConfig()
    layers = config.gat_layers
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)

    # ---- 28. the CSR kernels against their plain versions -----------------
    errs = [0.0, 0.0]
    main = None
    for shape in EDGE_SHAPES + (EDGE_HUB_SHAPE,):
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
    step, batch = sparse_trainer(dev, config)
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
    # the device's time (each call captured in a CUDA graph): a call's host
    # work, the weights' packing and the launch, outlasts its kernel
    with torch.inference_mode():
        ms = graph_ms(lambda: drift_rhs_fused(*main_args), 50)
        eager_ms = cuda_ms(lambda: drift_rhs_fused(*main_args), 50)
        plain_ms = cuda_ms(lambda: drift_rhs_reference(*main_args), 5)
    fwd, _ = stage_flops(config.agent_dim, config.zone_dim,
                         config.context_dim, config.hidden_dim, ADAPT_ZONES,
                         config.num_blocks)
    flop = fwd * ADAPT_N
    print(f"K8a at N={ADAPT_N} Z={ADAPT_ZONES}: kernel {ms:.3f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s; device time, CUDA graph), "
          f"{eager_ms:.3f} ms a call eager, plain version {plain_ms:.3f} ms "
          f"[card {card}]", flush=True)
    # per agent: read x and h, write f
    nbytes = ADAPT_N * 4 * (2 * config.agent_dim + config.context_dim)
    return kernel_entry("drift_rhs_fused", "fused_step.cu",
                        "fused_rhs.py:119", launches, max_err, ms, plain_ms,
                        flop, nbytes)


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
    return kernel_entry("dopri5_step_fused_bf16", "fused_step.cu",
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


# ---- the schedule-VAE population pipeline (phases 39-46) ------------------

# configs/phase1.yaml, phase2.yaml and crf_config.yaml as dicts: the card's
# machine has no PyYAML (tests/test_torch_schedule_pipeline.py holds them
# equal to the files)
SCHEDULE_CONFIGS = {
    "phase1": {
        "data": {"npz": "runs/data/train_5min.npz"},
        "train": {"epochs": 500, "min_epochs": 500, "patience": 0,
                  "batch_size": 1024, "lr": 0.001, "weight_decay": 0.0001,
                  "grad_clip": 1.0, "beta_target": 1.0,
                  "beta_warm_frac": 0.3, "lambda_tv": 0, "lambda_home": 0},
        "model": {"method": "baseline_cnn", "z_dim": 16, "emb_dim": 256,
                  "cnn_channels": [64, 64], "cnn_kernel": 5,
                  "cnn_dropout": 0.1},
    },
    "phase2": {
        "data": {"npz": "runs/data/train_5min.npz"},
        "train": {"epochs": 500, "min_epochs": 500, "patience": 0,
                  "batch_size": 1024, "lr": 0.001, "weight_decay": 0.0001,
                  "grad_clip": 5.0, "beta_target": 2.0,
                  "beta_warm_frac": 0.1, "lambda_tv": 0.02,
                  "lambda_home": 0.2, "lambda_tod": 0.3,
                  "lambda_presence": 0.3, "lambda_share": 0.3},
        "model": {"method": "auto_pds", "z_dim": 16, "emb_dim": 256,
                  "cnn_channels": [64, 64], "cnn_kernel": 5,
                  "cnn_dropout": 0.1, "pds_path": "runs/pds/pds_pds.npz"},
    },
    "crf_config": {
        "crf": {"train_npz": "runs/crf_data/crf_train.npz",
                "val_npz": "runs/crf_data/crf_val.npz",
                "save_path": "runs/crf_data/crf_linear.ckpt",
                "meta_json": "runs/crf_data/crf_meta.json",
                "num_epochs": 500, "batch_size": 32, "lr": "1e-3",
                "weight_decay": "1e-4", "log_every": 10},
    },
}
# the keys the smoke replaces: its own run's files, and the epoch counts,
# which the time limit cuts
SCHEDULE_CUTS = {
    "phase1": ("data.npz", "train.epochs"),
    "phase2": ("data.npz", "model.pds_path", "train.epochs"),
    "crf_config": ("crf.train_npz", "crf.val_npz", "crf.save_path",
                   "crf.meta_json", "crf.num_epochs"),
}
SCHED_PERSONS = 42_817  # VISTA's person count (the README's quick start)
SCHED_SEED = 0
SCHED_GRID_MIN = 5  # L = 288 bins
SCHED_EPOCHS = 3
SCHED_SAMPLES = 1_048_576
SCHED_CHECK_Z = 65_536
SCHED_IDS_MIN = 0.999
# one VAE step, card against CPU: every loss component, every gradient
SCHED_STEP_ROWS = 1_024
SCHED_STEP_RTOL = 1e-4
SCHED_STEP_COS_MIN = 0.9999
# train_crf on the first CRF_TRAIN_ROWS training rows: at a batch of 32 an
# epoch over all ~38,500 is ~1,200 eager steps of 287-step scans, ~0.1 s each
CRF_TRAIN_ROWS = 4_096
CRF_EPOCHS = 2
CRF_SAMPLES = 65_536
CRF_CHECK_ROWS = 1_024
CRF_RTOL = 1e-5


def schedule_config(name, **values):
    """A copy of SCHEDULE_CONFIGS[name] with the SCHEDULE_CUTS keys given
    as ``section__key=value``; raises on a key outside the cuts."""
    import copy

    cfg = copy.deepcopy(SCHEDULE_CONFIGS[name])
    for key, value in values.items():
        section, leaf = key.split("__")
        if f"{section}.{leaf}" not in SCHEDULE_CUTS[name]:
            raise KeyError(f"{name}: {section}.{leaf} is not a listed cut")
        cfg[section][leaf] = value
    return cfg


def read_log(path):
    """training_log.csv as a list of {column: float}."""
    with open(path, newline="", encoding="utf-8") as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def max_rel(got, want):
    """max |got - want| / max |want| over two equal-length sequences."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def cosine(a, b):
    """Cosine of two tensors taken as vectors (1 where both are zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0 and nb == 0:
        return 1.0
    return float((a @ b).item() / max(na * nb, 1e-300))


def step_check(dev, card, name, cfg, meta, Y):
    """One VAE step (its loss components and every parameter's gradient)
    on the card against the same step on the CPU: the same carried weights,
    rows, injected noise, dropout off."""
    from ananke_abm_tpu_torch.models.gen_schedule import factory, params
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import train
    from ananke_abm_tpu_torch.models.gen_schedule.vae import init_params

    cfg = dict(cfg, model=dict(cfg["model"], cnn_dropout=0.0))
    home = meta["purpose_map"]["Home"]
    rows = torch.as_tensor(Y[:SCHED_STEP_ROWS])
    eps = torch.as_tensor(np.random.default_rng(SCHED_SEED).standard_normal(
        (SCHED_STEP_ROWS, cfg["model"]["z_dim"])).astype(np.float32))
    out = {}
    weights = None
    for where in ("cpu", dev):
        model, pds = factory.build_model(cfg, meta, device=where)
        if weights is None:
            init_params(model, torch.Generator().manual_seed(SCHED_SEED))
            weights = params.to_flax_params(model)
        params.load_flax_params(model, weights)
        loss_fn = train.make_loss_fn(model, home, train.loss_weights(cfg),
                                     train.load_pds_arrays(cfg, pds))
        model.train()
        t0 = time.perf_counter()
        loss, comps = loss_fn(rows.to(where),
                              torch.ones(SCHED_STEP_ROWS, device=where), 1.0,
                              eps=eps.to(where))
        loss.backward()
        if where != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[str(where)] = ({k: v.item() for k, v in comps.items()},
                           {n: p.grad.cpu() for n, p in
                            model.named_parameters()}, wall)
    (cc, cg, cw), (gc, gg, gw) = out["cpu"], out[str(dev)]
    rels = {k: abs(gc[k] - cc[k]) / max(abs(cc[k]), 1e-30) for k in cc
            if cc[k] != 0.0}
    cos = {n: cosine(gg[n], cg[n]) for n in cg}
    worst = min(cos, key=cos.get)
    print(f"step check {name} ({SCHED_STEP_ROWS} rows, L={Y.shape[1]}): "
          + ", ".join(f"{k} {cc[k]:.6f} rel {r:.2e}" for k, r in
                      rels.items())
          + f"; gradient cosine min {cos[worst]:.8f} ({worst}) over "
          f"{len(cos)} parameters; forward+backward card {gw:.4f} s, CPU "
          f"{cw:.4f} s [card {card}]", flush=True)
    if max(rels.values()) > SCHED_STEP_RTOL:
        fail(f"{name}: a loss component differs from the CPU's by more than "
             f"{SCHED_STEP_RTOL}")
    if cos[worst] <= SCHED_STEP_COS_MIN:
        fail(f"{name}: gradient of {worst} at cosine {cos[worst]} against "
             f"the CPU's")


def vae_epoch(dev, card, cfg, meta, Y):
    """A phase1 training epoch's wall (make_epoch_fns, the second of two,
    synchronised around it), then one more step under torch.profiler."""
    from ananke_abm_tpu_torch.models.gen_schedule import factory
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import train
    from ananke_abm_tpu_torch.models.gen_schedule.vae import init_params
    from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
    from ananke_abm_tpu_torch.utils.seed import generator

    tr = cfg["train"]
    model, _ = factory.build_model(cfg, meta, device=dev)
    init_params(model, torch.Generator().manual_seed(SCHED_SEED))
    optimizer = ClippedAdamW(model.parameters(), tr["lr"], tr["weight_decay"],
                             tr["grad_clip"])
    loss_fn = train.make_loss_fn(model, meta["purpose_map"]["Home"],
                                 train.loss_weights(cfg), None)
    bs = tr["batch_size"]
    train_epoch, _ = train.make_epoch_fns(model, optimizer, loss_fn, bs)
    Yd = torch.as_tensor(Y).to(dev)
    n_batches = -(-len(Y) // bs)
    walls = []
    for epoch in (1, 2):
        gen = generator(dev, SCHED_SEED, epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_epoch(Yd, gen, 1.0, n_batches).tolist()
        walls.append(time.perf_counter() - t0)
    print(f"phase1 epoch (make_epoch_fns, {n_batches} steps of {bs} rows): "
          f"{walls[1]:.4f} s ({walls[1] / n_batches * 1e3:.2f} ms a step; "
          f"the first epoch {walls[0]:.4f} s) [card {card}]", flush=True)
    gen = generator(dev, SCHED_SEED, 3)
    batch = Yd[:bs]
    mask = torch.ones(bs, device=dev)

    def step():
        optimizer.zero_grad()
        loss, _ = loss_fn(batch, mask, 1.0, gen)
        loss.backward()
        optimizer.step()

    device_busy("phase1 training step", step, card)


def crf_step_profile(dev, card, train_npz):
    """One train_crf step on a batch of 32 (the NLL over a 287-step scan,
    its backward, AdamW) under torch.profiler."""
    from ananke_abm_tpu_torch.models.gen_schedule.crf.model import (
        crf_nll_loss,
        init_crf_params,
    )
    from ananke_abm_tpu_torch.utils.seed import generator

    with np.load(train_npz) as d:
        U = torch.as_tensor(d["U"][:32]).to(dev)
        Y = torch.as_tensor(d["Y"][:32]).to(dev)
    params = init_crf_params(generator(dev, SCHED_SEED), U.shape[-1])
    for v in params.values():
        v.requires_grad_(True)
    optimizer = torch.optim.AdamW(list(params.values()), lr=1e-3,
                                  weight_decay=1e-4)

    def step():
        optimizer.zero_grad()
        crf_nll_loss(params, U, Y).backward()
        optimizer.step()

    step()
    device_busy("train_crf step", step, card)


def schedule_phases(dev, card):
    """Phases 39-46: the schedule-VAE pipeline of the README's quick start
    at the phase1 / phase2 / crf_config widths on 42,817 persons x 288
    bins. Every phase raises on failure."""
    from ananke_abm_tpu_torch.data_generator.population import (
        COLUMNS,
        generate_population_activities,
        write_csv,
    )
    from ananke_abm_tpu_torch.dataio.rasterize import prepare_from_csv
    from ananke_abm_tpu_torch.models.gen_schedule.crf.model import (
        crf_decode,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.crf.prepare import (
        prepare_crf_data,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.crf.train import train_crf
    from ananke_abm_tpu_torch.models.gen_schedule.pds import compute_pds
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.eval import (
        evaluate,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.sample import (
        load_vae,
        sample,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.train import train
    from ananke_abm_tpu_torch.ops.crf import (
        crf_log_partition,
        crf_path_score,
        viterbi_decode,
        viterbi_decode_no_all_home,
    )
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    root = OUT / "schedule"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    walls = {}

    # ---- 39. data --------------------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    acts = generate_population_activities(SCHED_PERSONS, seed=SCHED_SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    csv_path = write_csv(str(root / "activities.csv"),
                         {k: acts[k] for k in COLUMNS})
    t_csv = time.perf_counter() - t0
    grid = str(root / "train_5min.npz")
    t0 = time.perf_counter()
    _, meta = prepare_from_csv(csv_path, grid, grid_min=SCHED_GRID_MIN)
    t_prep = time.perf_counter() - t0
    P = len(meta["purpose_map"])
    if (meta["N"], meta["L"], P) != (SCHED_PERSONS,
                                     1440 // SCHED_GRID_MIN, 7):
        fail(f"prepared grid N={meta['N']} L={meta['L']} P={P}")
    t0 = time.perf_counter()
    compute_pds(grid, str(root / "pds"), SCHED_GRID_MIN,
                grid.replace(".npz", "_purpose_map.json"))
    t_pds = time.perf_counter() - t0
    pds_path = str(root / "pds_pds.npz")
    walls[39] = time.perf_counter() - t_phase
    print(f"schedule data: {len(acts['persid'])} activities of "
          f"{SCHED_PERSONS} persons, grid {meta['N']} x {meta['L']}, P={P}; "
          f"generate {t_gen:.3f} s, CSV {t_csv:.3f} s, prepare_from_csv "
          f"{t_prep:.3f} s, compute_pds {t_pds:.3f} s (host clock)",
          flush=True)

    # ---- 40. one VAE step, card against CPU --------------------------------
    t_phase = time.perf_counter()
    with np.load(grid) as g, np.load(grid.replace(".npz", "_splits.npz")) \
            as sp:
        Y_train = g["Y"][sp["train_idx"]]
    p1 = schedule_config("phase1", data__npz=grid, train__epochs=SCHED_EPOCHS)
    p2 = schedule_config("phase2", data__npz=grid, model__pds_path=pds_path,
                         train__epochs=1)
    for name, cfg in (("phase1", p1), ("phase2", p2)):
        step_check(dev, card, name, cfg, meta, Y_train)
    walls[40] = time.perf_counter() - t_phase

    # ---- 41. train() -------------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = root / "vae"
    res = train(p1, str(run), seed=SCHED_SEED, device=dev)
    log = read_log(str(run / "training_log.csv"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(log) != SCHED_EPOCHS or not all(
            np.isfinite(list(row.values())).all() for row in log):
        fail(f"phase1 train(): {len(log)} epochs, or a loss not finite")
    for name in ("last.ckpt", "best_val.ckpt"):
        if not (run / "checkpoints" / name).exists():
            fail(f"phase1 train() wrote no {name}")
    print(f"train() phase1: {SCHED_EPOCHS} epochs of "
          f"{-(-len(Y_train) // 1024)} batches in {res['seconds']:.3f} s "
          f"({res['seconds'] / SCHED_EPOCHS:.3f} s an epoch, host clock, "
          f"data load and model build included); losses "
          + ", ".join(f"{row['train_loss']:.5f}" for row in log)
          + f"; val {log[-1]['val_loss']:.5f}; peak {peak:.2f} GB "
          f"[card {card}]", flush=True)
    # the default kernels (cuDNN's weight gradients among them) sum in no
    # fixed order, so separately trained runs drift apart (the resumed run
    # read up to 6.9e-05 of a log column off the straight one, 1.07e-04 on
    # cuDNN's deterministic algorithms alone): both train with PyTorch's
    # deterministic algorithms, and then a resume repeats the straight run
    # bit for bit
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        straight, split = root / "vae_straight", root / "vae_resumed"
        train(p1, str(straight), seed=SCHED_SEED, device=dev)
        train(schedule_config("phase1", data__npz=grid,
                              train__epochs=SCHED_EPOCHS - 1), str(split),
              seed=SCHED_SEED, device=dev)
        train(p1, str(split), seed=SCHED_SEED, resume=True, device=dev)
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic = deterministic[1]
    want = read_log(str(straight / "training_log.csv"))[-1]
    resumed = read_log(str(split / "training_log.csv"))[-1]
    keys = [k for k in want if k != "epoch"]
    rel = max_rel([resumed[k] for k in keys], [want[k] for k in keys])
    print(f"train() resumed (deterministic algorithms): epochs 1-"
          f"{SCHED_EPOCHS - 1}, then epoch {int(resumed['epoch'])} from "
          f"last.ckpt against a straight run's: max rel difference "
          f"{rel:.3e} over {len(keys)} columns (must be 0)", flush=True)
    if rel != 0.0:
        fail("the resumed run departs from the straight run")
    vae_epoch(dev, card, p1, meta, Y_train)
    res2 = train(p2, str(root / "vae_pds"), seed=SCHED_SEED, device=dev)
    row = read_log(str(root / "vae_pds" / "training_log.csv"))[-1]
    for k in ("train_tod", "train_presence", "train_share"):
        if not (np.isfinite(row[k]) and row[k] > 0):
            fail(f"phase2 {k} = {row[k]}")
    print(f"train() phase2 (auto_pds): 1 epoch in {res2['seconds']:.3f} s; "
          f"loss {row['train_loss']:.5f}, tod {row['train_tod']:.3e}, "
          f"presence {row['train_presence']:.3e}, share "
          f"{row['train_share']:.3e} [card {card}]", flush=True)
    walls[41] = time.perf_counter() - t_phase

    # ---- 42. sample() --------------------------------------------------------
    t_phase = time.perf_counter()
    ckpt = str(run / "checkpoints" / "best_val.ckpt")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = sample(ckpt, SCHED_SAMPLES, str(root / "samples" / "s"),
                  seed=SCHED_SEED, reject_all_home=True, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    with np.load(root / "samples" / "s.npz") as d:
        Y_gen = d["Y_generated"]
        if Y_gen.shape != (SCHED_SAMPLES, meta["L"]) or \
                Y_gen.dtype != np.int64:
            fail(f"samples {Y_gen.shape} {Y_gen.dtype}")
        if (Y_gen == meta["purpose_map"]["Home"]).all(axis=1).any():
            fail("reject_all_home kept an all-home row")
    print(f"sample() argmax: {SCHED_SAMPLES} schedules in "
          f"{info['seconds']:.3f} s ({SCHED_SAMPLES / info['seconds']:.0f} "
          f"agents/s; {wall:.3f} s with the artifacts written), peak "
          f"{peak:.2f} GB [card {card}]", flush=True)
    obj = load_checkpoint(ckpt)
    z = torch.randn((SCHED_CHECK_Z, obj["cfg"]["model"]["z_dim"]),
                    generator=torch.Generator().manual_seed(SCHED_SEED))
    ids = {}
    for where in ("cpu", dev):
        model, pds = load_vae(obj, where)
        with torch.inference_mode():
            ids[str(where)] = torch.argmax(model.decode(z.to(where), pds),
                                           dim=-1).cpu()
    agree = (ids["cpu"] == ids[str(dev)]).float().mean().item()
    print(f"decode ids of the same {SCHED_CHECK_Z} z, card against CPU: "
          f"agree {agree:.6f} (>= {SCHED_IDS_MIN})", flush=True)
    if agree < SCHED_IDS_MIN:
        fail("the card's decode disagrees with the CPU's")
    walls[42] = time.perf_counter() - t_phase

    # ---- 43. the CRF data and trainer ----------------------------------------
    t_phase = time.perf_counter()
    crf_dir = root / "crf_data"
    t0 = time.perf_counter()
    crf_meta = prepare_crf_data(ckpt, grid.replace(".npz", "_splits.npz"),
                                str(crf_dir), device=dev)
    t_prep = time.perf_counter() - t0
    with np.load(crf_dir / "crf_train.npz") as d:
        n_train = d["U"].shape[0]
        np.savez(crf_dir / "crf_train_cut.npz", U=d["U"][:CRF_TRAIN_ROWS],
                 Y=d["Y"][:CRF_TRAIN_ROWS])
    crf_cfg = schedule_config(
        "crf_config", crf__train_npz=str(crf_dir / "crf_train_cut.npz"),
        crf__val_npz=str(crf_dir / "crf_val.npz"),
        crf__save_path=str(crf_dir / "crf_linear.ckpt"),
        crf__meta_json=str(crf_dir / "crf_meta.json"),
        crf__num_epochs=CRF_EPOCHS)
    t0 = time.perf_counter()
    crf_res = train_crf(crf_cfg, seed=SCHED_SEED, device=dev)
    t_crf = time.perf_counter() - t0
    if not np.isfinite(crf_res["best_val_nll"]):
        fail("train_crf's validation NLL is not finite")
    crf_step_profile(dev, card, crf_dir / "crf_train_cut.npz")
    print(f"prepare_crf_data: {n_train} train and {SCHED_PERSONS - n_train} "
          f"val rows in {t_prep:.3f} s; train_crf: {CRF_EPOCHS} epochs over "
          f"the first {CRF_TRAIN_ROWS} train rows (batch 32, "
          f"{CRF_TRAIN_ROWS // 32} steps an epoch) in {t_crf:.3f} s "
          f"({t_crf / CRF_EPOCHS:.3f} s an epoch with its validation NLL), "
          f"best val NLL {crf_res['best_val_nll']:.4f} [card {card}]",
          flush=True)
    walls[43] = time.perf_counter() - t_phase

    # ---- 44. the CRF recursions, card against CPU ----------------------------
    t_phase = time.perf_counter()
    crf_params = {k: torch.tensor(np.asarray(v)) for k, v in
                  load_checkpoint(str(crf_dir / "crf_linear.ckpt"))
                  ["params"].items()}
    with np.load(crf_dir / "crf_val.npz") as d:
        U = torch.as_tensor(d["U"][:CRF_CHECK_ROWS]) + crf_params["bias"]
    A = crf_params["A"]
    home = crf_meta["home_idx"]
    got = {}
    for where in ("cpu", dev):
        u, a = U.to(where), A.to(where)
        got[str(where)] = (crf_log_partition(u, a).cpu(),
                           viterbi_decode(u, a).cpu(),
                           viterbi_decode_no_all_home(u, a, home).cpu())
    (zc, pc, qc), (zg, pg, qg) = got["cpu"], got[str(dev)]
    rel_z = max_rel(zg, zc)
    rel_p = max_rel(crf_path_score(U, pg, A), crf_path_score(U, pc, A))
    rel_q = max_rel(crf_path_score(U, qg, A), crf_path_score(U, qc, A))
    print(f"CRF on {CRF_CHECK_ROWS} val rows, card against CPU: log Z rel "
          f"{rel_z:.2e}, Viterbi path scores rel {rel_p:.2e} (paths equal "
          f"{(pg == pc).float().mean().item():.6f}), constrained {rel_q:.2e}"
          f" (<= {CRF_RTOL})", flush=True)
    if max(rel_z, rel_p, rel_q) > CRF_RTOL:
        fail("the card's CRF recursions disagree with the CPU's")
    if ((qg == home).all(dim=1)).any():
        fail("the constrained decode left an all-home row")
    walls[44] = time.perf_counter() - t_phase

    # ---- 45. sample() through the CRF ----------------------------------------
    t_phase = time.perf_counter()
    info = sample(ckpt, CRF_SAMPLES, str(root / "samples" / "c"),
                  seed=SCHED_SEED, decode_mode="crf",
                  crf_path=str(crf_dir / "crf_linear.ckpt"),
                  enforce_nonhome=True, device=dev)
    with np.load(root / "samples" / "c.npz") as d:
        if (d["Y_generated"] == home).all(axis=1).any():
            fail("the CRF samples hold an all-home row")
    print(f"sample() crf, enforce_nonhome: {CRF_SAMPLES} schedules in "
          f"{info['seconds']:.3f} s ({CRF_SAMPLES / info['seconds']:.0f} "
          f"agents/s) [card {card}]", flush=True)
    walls[45] = time.perf_counter() - t_phase

    # ---- 46. evaluate() ------------------------------------------------------
    t_phase = time.perf_counter()
    report = evaluate(str(root / "samples" / "s.npz"),
                      str(root / "samples" / "s_meta.json"), grid,
                      str(root / "report.json"))
    walls[46] = time.perf_counter() - t_phase
    missing = {"P", "L", "home_idx", "minutes_share", "bigram",
               "tod_jsd_macro", "all_home_rate", "start_home_rate",
               "end_home_rate", "diversity_ratio"} - set(report)
    if missing or report["all_home_rate"] != 0.0:
        fail(f"evaluate(): missing {missing}, all-home rate "
             f"{report['all_home_rate']}")
    print(f"evaluate(): {SCHED_SAMPLES} samples against the grid in "
          f"{walls[46]:.3f} s (host); tod_jsd_macro "
          f"{report['tod_jsd_macro']:.5f}, bigram L1 "
          f"{report['bigram']['L1']:.5f}, diversity "
          f"{report['diversity_ratio']:.5f} [card {card}]", flush=True)
    comparison_phases(card, root, grid, csv_path, walls)
    cut_csv, catalog_csv = traj_phases(dev, card, root, acts, csv_path,
                                       walls)
    # ---- 63. the entry points with mesh= -----------------------------------
    t_phase = time.perf_counter()
    mesh_entry_phase(dev, card, {"root": root, "grid": grid, "ckpt": ckpt,
                                 "crf_dir": crf_dir, "cut_csv": cut_csv,
                                 "catalog_csv": str(catalog_csv)})
    walls[63] = time.perf_counter() - t_phase
    print("schedule phases wall: " + ", ".join(
        f"{k}: {v:.1f} s" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} s in all", flush=True)



# ---- the comparison layer, the host counters and the CLI (phases 47-50) ---

# phase 47: each n of the n-gram counters at the grid's 42,817 rows; at the
# samples' 1,048,576 the metrics' bigram (the numpy branches' unique sort
# of 300M codes takes ~10 s an n there)
NATIVE_GRID_NS = (1, 2, 3, 4)
NATIVE_SAMPLE_NS = (2,)
# phase 48: the rows of the samples on which the tables' CSVs through the
# numpy branches must equal those through the native counters
TABLES_CHECK_ROWS = 65_536
# the registry's functions and the CSV files they write (the README's
# "15-family" suite)
TABLES_FUNCS = 14
TABLES_CSVS = 24
CLI_SAMPLES = 65_536
CLI_COMMANDS = ("prepare", "fit", "sample-population", "eval-population",
                "viz-population", "compute-pds", "prepare-crf-data",
                "train-crf", "compare-samples", "metric-tables",
                "plot-overview")


@contextlib.contextmanager
def numpy_branch():
    """The host counters' numpy branches: ``native.available()`` False
    inside the block."""
    from ananke_abm_tpu_torch.ops import native

    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


def same_arrays(a, b):
    """Equal shapes, dtypes and values, of arrays or tuples of arrays."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


def native_checks(label, Y, ns):
    """Every host counter on ``Y`` through the native library and through
    its numpy branch: equal integers and shapes, or fail. ``rasterize_fill``
    rebuilds Y from Y's own run-length segments (both fills must give Y).
    Returns {entry point: (native s, numpy s)}."""
    from ananke_abm_tpu_torch.dataio.rasterize import rasterize_fill_numpy
    from ananke_abm_tpu_torch.ops import native

    P = 7
    Y = np.ascontiguousarray(Y, dtype=np.int64)
    N, T = Y.shape
    calls = {"tod_counts": lambda: native.tod_counts(Y, P),
             "run_length_segments": lambda: native.run_length_segments(Y)}
    for n in ns:
        calls[f"count_ngrams_dense n={n}"] = (
            lambda n=n: native.count_ngrams_dense(Y, n, P))
        calls[f"ngram_start_hist_dense n={n}"] = (
            lambda n=n: native.ngram_start_hist_dense(Y, n, P))
    walls = {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        got = fn()
        t_native = time.perf_counter() - t0
        with numpy_branch():
            t0 = time.perf_counter()
            want = fn()
            walls[name] = (t_native, time.perf_counter() - t0)
        if not same_arrays(got, want):
            fail(f"{label}: native {name} differs from its numpy branch")
    person, purpose, length = native.run_length_segments(Y)
    start = np.cumsum(length) - length - person * T
    args = (person, start, length, purpose, N, T)
    t0 = time.perf_counter()
    got = native.rasterize_fill(*args)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = rasterize_fill_numpy(*args)
    walls["rasterize_fill"] = (t_native, time.perf_counter() - t0)
    if not (same_arrays(got, want) and same_arrays(got, Y)):
        fail(f"{label}: rasterize_fill of Y's segments is not Y on both "
             f"branches")
    native.check_labels(Y, P)
    keep = Y[0, 0]
    Y[0, 0] = P
    try:
        for branch in (contextlib.nullcontext, numpy_branch):
            with branch():
                with contextlib.suppress(ValueError):
                    native.tod_counts(Y, P)
                    fail(f"{label}: a label of {P} passed check_labels")
    finally:
        Y[0, 0] = keep
    return walls


def numpy_tables(grid, grid_meta, samples_dir, out):
    """``metric_tables`` through the host counters' numpy branches (phase
    48, in a process of its own): (metrics run, {CSV: bytes}, wall)."""
    from ananke_abm_tpu_torch.models.gen_schedule.compare.tables import (
        metric_tables,
    )

    with numpy_branch():
        t0 = time.perf_counter()
        ran = metric_tables(grid, grid_meta, samples_dir, out)
        wall = time.perf_counter() - t0
    return len(ran), {f: (Path(out) / f).read_bytes()
                      for f in sorted(os.listdir(out))}, wall


def cli_run(argv, timeout=900):
    """``python -m ananke_abm_tpu_torch.cli.rgen_schedule *argv`` from the
    checkout's root on the card (no ANANKE_PLATFORM): (process, wall)."""
    env = {k: v for k, v in os.environ.items() if k != "ANANKE_PLATFORM"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ananke_abm_tpu_torch.cli.rgen_schedule",
         *map(str, argv)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def cli_ok(argv):
    proc, wall = cli_run(argv)
    if proc.returncode != 0:
        fail(f"rgen_schedule {argv[0]} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc, wall


def comparison_phases(card, root, grid, csv_path, walls):
    """Phases 47-50: the native host counters against their numpy
    branches, ``metric_tables`` over the million samples,
    ``compare_samples`` / ``plot_overview`` / ``visualize``, and the
    ``rgen_schedule`` CLI as subprocesses. Every phase raises on
    failure."""
    import importlib.util
    import resource

    from ananke_abm_tpu_torch.dataio.rasterize import (
        rasterize_frame,
        read_csv,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.compare.plot_viz import (
        plot_overview,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.compare.tables import (
        metric_tables,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.comparisons import (
        compare_samples,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.viz import (
        visualize,
    )
    from ananke_abm_tpu_torch.ops import native

    grid_meta = grid.replace(".npz", "_meta.json")
    samples = root / "samples"
    with np.load(grid) as g:
        Y_grid = g["Y"]
    with open(grid_meta, encoding="utf-8") as f:
        purpose_map = json.load(f)["purpose_map"]

    # ---- 47. the native host counters --------------------------------------
    t_phase = time.perf_counter()
    if not native.available():
        fail("the native host library did not build (g++) or load")
    print(f"native host library: {native.library_path().relative_to(ROOT)} "
          f"(built with g++ at its first use, phase 46's metrics)",
          flush=True)
    cols = read_csv(csv_path)
    t0 = time.perf_counter()
    Y_native, _ = rasterize_frame(cols, purpose_map, SCHED_GRID_MIN)
    t_native = time.perf_counter() - t0
    with numpy_branch():
        t0 = time.perf_counter()
        Y_numpy, _ = rasterize_frame(cols, purpose_map, SCHED_GRID_MIN)
        t_numpy = time.perf_counter() - t0
    if not (same_arrays(Y_native, Y_numpy) and same_arrays(Y_native, Y_grid)):
        fail("rasterize_frame of the activities differs between the branches "
             "or from phase 39's grid")
    print(f"rasterize_frame of {len(cols['persid'])} activities: native "
          f"{t_native:.3f} s, numpy {t_numpy:.3f} s, equal grids",
          flush=True)
    native_checks(f"the grid {Y_grid.shape}", Y_grid, NATIVE_GRID_NS)
    with np.load(samples / "s.npz") as d:
        Y_gen = d["Y_generated"]
    timed = native_checks(f"the samples {Y_gen.shape}", Y_gen,
                          NATIVE_SAMPLE_NS)
    walls[47] = time.perf_counter() - t_phase
    print(f"native host counters equal their numpy branches on the grid "
          f"{Y_grid.shape} (n = {NATIVE_GRID_NS}) and the samples "
          f"{Y_gen.shape} (n = {NATIVE_SAMPLE_NS}); walls at "
          f"{len(Y_gen)} rows, native / numpy: " + ", ".join(
              f"{k} {a:.3f} / {b:.3f} s" for k, (a, b) in timed.items())
          + " (host)", flush=True)

    # ---- 48. metric_tables over the million samples -----------------------
    t_phase = time.perf_counter()
    sample_meta = (samples / "s_meta.json").read_text()
    compare_dirs = {}
    for cut, rows in (("full", len(Y_gen)), ("cut", TABLES_CHECK_ROWS)):
        d = root / "compare" / cut
        d.mkdir(parents=True)
        np.savez(d / "vae_argmax.npz",
                 Y_generated=Y_gen[:rows].astype(np.uint8))
        (d / "vae_argmax_meta.json").write_text(sample_meta)
        compare_dirs[cut] = d

    def tables(cut, name):
        out = root / "tables" / name
        t0 = time.perf_counter()
        ran = metric_tables(grid, grid_meta, str(compare_dirs[cut]),
                            str(out))
        wall = time.perf_counter() - t0
        csvs = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        if len(ran) != TABLES_FUNCS or len(csvs) != TABLES_CSVS:
            fail(f"metric_tables {name}: {len(ran)} metrics, {len(csvs)} "
                 f"CSVs")
        return csvs, wall

    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        numpy_run = pool.submit(numpy_tables, grid, grid_meta,
                                str(compare_dirs["cut"]),
                                str(root / "tables" / "cut_numpy"))
        _, wall = tables("full", "full")
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"metric_tables: {TABLES_FUNCS} metric functions, "
              f"{TABLES_CSVS} CSVs, {len(Y_gen)} samples against the grid's "
              f"{len(Y_grid)} rows x {Y_grid.shape[1]} bins, native "
              f"counters, in {wall:.3f} s (host); the process's peak RSS so "
              f"far {rss:.2f} GB", flush=True)
        native_csvs, t_native = tables("cut", "cut_native")
        ran, numpy_csvs, t_numpy = numpy_run.result()
    if ran != TABLES_FUNCS or len(numpy_csvs) != TABLES_CSVS:
        fail(f"metric_tables cut_numpy: {ran} metrics, {len(numpy_csvs)} "
             f"CSVs")
    differ = [f for f in native_csvs if native_csvs[f] != numpy_csvs[f]]
    if differ or list(native_csvs) != list(numpy_csvs):
        fail(f"metric_tables at {TABLES_CHECK_ROWS} rows: CSVs differ "
             f"between the native and numpy branches: {differ}")
    walls[48] = time.perf_counter() - t_phase
    print(f"metric_tables at {TABLES_CHECK_ROWS} rows: the {TABLES_CSVS} "
          f"CSVs byte-equal between the native counters ({t_native:.3f} s) "
          f"and the numpy branches ({t_numpy:.3f} s, in a process of their "
          f"own beside the million's tables)", flush=True)

    # ---- 49. compare_samples, plot_overview, visualize ----------------------
    t_phase = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("matplotlib", "click")}
    print("on this machine: " + ", ".join(
        f"{m} {'installed' if ok else 'absent'}" for m, ok in found.items()),
        flush=True)
    plots = found["matplotlib"]
    out = root / "compare_samples"
    specs = [(name, str(samples / f"{p}.npz"), str(samples / f"{p}_meta.json"))
             for name, p in (("vae_argmax", "s"), ("vae_crf", "c"))]
    t0 = time.perf_counter()
    reports = compare_samples(specs, grid, str(out), make_plots=plots)
    t_cmp = time.perf_counter() - t0
    with open(out / "comparison_aggregate.csv", newline="",
              encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    if [r["model"] for r in rows] != ["vae_argmax", "vae_crf"] or             [r["model"] for r in reports] != ["vae_argmax", "vae_crf"] or             not all(np.isfinite(float(v)) for r in rows
                    for k, v in r.items() if k != "model"):
        fail(f"compare_samples: aggregate rows {rows}")
    for name, _, _ in specs:
        if not (out / f"report_{name}.json").exists():
            fail(f"compare_samples wrote no report_{name}.json")
    print(f"compare_samples: {len(Y_gen)} argmax and {CRF_SAMPLES} CRF "
          f"samples against the grid in {t_cmp:.3f} s (host); "
          + "; ".join(f"{r['model']}: bigram L1 {float(r['bigram_L1']):.5f},"
                      f" tod_jsd {float(r['tod_jsd_macro']):.5f}"
                      for r in rows), flush=True)
    if plots:
        t0 = time.perf_counter()
        plot_overview(grid, grid_meta, str(compare_dirs["full"]),
                      str(root / "overview"))
        visualize(str(samples / "s.npz"), str(samples / "s_meta.json"),
                  str(root / "viz"), grid)
        t_plots = time.perf_counter() - t0
        pngs = {d: sorted(p.name for p in (root / d).glob("*.png"))
                for d in ("compare_samples", "overview", "viz")}
        want = {"compare_samples": 6, "overview": 1 + 2 * len(purpose_map),
                "viz": 4}
        if {d: len(v) for d, v in pngs.items()} != want or any(
                (root / d / p).stat().st_size == 0
                for d, v in pngs.items() for p in v):
            fail(f"plots: {pngs}, want counts {want}")
        print(f"plots: {sum(map(len, pngs.values()))} PNGs "
              f"({', '.join(f'{d} {len(v)}' for d, v in pngs.items())}); "
              f"plot_overview and visualize in {t_plots:.3f} s", flush=True)
    else:
        print("matplotlib is absent: the plot calls (compare_samples' "
              "plots, plot_overview, visualize) were not run", flush=True)
    walls[49] = time.perf_counter() - t_phase

    # ---- 50. the CLI as subprocesses ------------------------------------------
    t_phase = time.perf_counter()
    cli = root / "cli"
    cli.mkdir()
    cli_grid = cli / "train_5min.npz"
    cli_walls = {}
    proc, cli_walls["--help"] = cli_ok(["--help"])
    missing = [c for c in CLI_COMMANDS if c not in proc.stdout]
    if missing:
        fail(f"rgen_schedule --help lists no {missing}")
    # phase 39 prepared with prepare_from_csv's val_frac 0.1 and seed 42
    _, cli_walls["prepare"] = cli_ok(
        ["prepare", "--activities", csv_path, "--grid", SCHED_GRID_MIN,
         "--out", cli_grid, "--val-frac", "0.1", "--seed", "42"])
    for suffix, keys in ((".npz", ("Y",)),
                         ("_splits.npz", ("train_idx", "val_idx"))):
        with np.load(str(cli_grid).replace(".npz", suffix)) as a, \
                np.load(grid.replace(".npz", suffix)) as b:
            if not all(same_arrays(a[k], b[k]) for k in keys):
                fail(f"rgen_schedule prepare: {suffix} differs from phase "
                     f"39's")
    _, cli_walls["compute-pds"] = cli_ok(
        ["compute-pds", "--grid", cli_grid, "--out", cli / "pds",
         "--grid-min", SCHED_GRID_MIN, "--purpose-json",
         str(cli_grid).replace(".npz", "_purpose_map.json")])
    config = cli / "phase1.json"
    config.write_text(json.dumps(schedule_config(
        "phase1", data__npz=str(cli_grid), train__epochs=1)))
    _, cli_walls["fit"] = cli_ok(["fit", "--config", config, "--output-dir",
                                  cli / "vae", "--seed", SCHED_SEED])
    if len(read_log(str(cli / "vae" / "training_log.csv"))) != 1:
        fail("rgen_schedule fit: the log holds no single epoch")
    prefix = cli / "samples" / "s"
    _, cli_walls["sample-population"] = cli_ok(
        ["sample-population", "--ckpt",
         cli / "vae" / "checkpoints" / "best_val.ckpt", "--num-samples",
         CLI_SAMPLES, "--outprefix", prefix, "--seed", SCHED_SEED,
         "--reject-all-home"])
    _, cli_walls["eval-population"] = cli_ok(
        ["eval-population", "--samples", f"{prefix}.npz", "--samples-meta",
         f"{prefix}_meta.json", "--reference", cli_grid, "--out-json",
         cli / "report.json"])
    report = json.loads((cli / "report.json").read_text())
    if report["all_home_rate"] != 0.0 or report["L"] != Y_grid.shape[1]:
        fail(f"rgen_schedule eval-population: {report}")
    proc, cli_walls["metric-tables"] = cli_ok(
        ["metric-tables", "--ref-npz", cli_grid, "--ref-meta",
         str(cli_grid).replace(".npz", "_meta.json"), "--compare-dir",
         cli / "samples", "--outdir", cli / "tables"])
    if len(os.listdir(cli / "tables")) != TABLES_CSVS or \
            not proc.stdout.startswith("Ran metrics: "):
        fail(f"rgen_schedule metric-tables: {proc.stdout}")
    # one process on one card: --data-parallel is the single-device run
    _, cli_walls["fit --data-parallel"] = cli_ok(
        ["fit", "--config", config, "--output-dir", cli / "dp", "--seed",
         SCHED_SEED, "--data-parallel"])
    dp_rel = max_rel(
        [r["train_loss"] for r in read_log(str(cli / "dp" /
                                               "training_log.csv"))],
        [r["train_loss"] for r in read_log(str(cli / "vae" /
                                               "training_log.csv"))])
    if dp_rel > MESH_ENTRY_RTOL:
        fail(f"rgen_schedule fit --data-parallel (one process): train loss "
             f"rel {dp_rel:.3e} from fit's")
    walls[50] = time.perf_counter() - t_phase
    print(f"rgen_schedule (python -m, one process each, on the card): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in cli_walls.items())
          + f"; prepare's grid and splits equal phase 39's; fit "
          f"--data-parallel in one process: fit's train loss (rel "
          f"{dp_rel:.3e}) [card {card}]", flush=True)


# ---- the traj_syn family and the ananke CLI (phases 51-56) -----------------

# TrajEmbedConfig's full width: L = 1800 / 5 = 360 bins, z 16, emb 128, CNN
# (64, 64) kernel 5, batch 32; the semi-CRF's Dmax = 300 / 5 = 60 bins
TRAJ_GRID_MIN = 5
TRAJ_DMAX_MIN = 300
# phase 52: the rows of the semi-CRF's card-against-CPU check (the CPU's
# recursions at 32 x 360 x 60 x 7 x 7 take seconds), the bounds (float32
# against float32, the reference's recursions in another summation order):
# log Z, the gold marginal, the path score and the NLL relative; the NLL's
# gradients' cosine; the decoded labels' agreement (a tie broken the other
# way moves a segment's end) and their path scores relative
TRAJ_CHECK_ROWS = 32
SEMI_RTOL = 1e-5
SEMI_COS_MIN = 0.99999
SEMI_LABELS_MIN = 0.999
# phase 53 (a cut of depth): train_traj_embed on the first TRAJ_TRAIN_ROWS
# persons of phase 39's 42,817 for TRAJ_EPOCHS epochs (the reference runs
# 1,000-3,000 epochs on VISTA; an eager semi-CRF step takes ~1.1 s)
TRAJ_TRAIN_ROWS = 128
TRAJ_EPOCHS = 2
# phase 54: schedules generated in each decode mode; phase 55: by the CLI
TRAJ_GEN = 4_096
CLI_TRAJ_GEN = 1_024
ANANKE_COMMANDS = ("traj-embed", "gval-traj", "visualize-combined-traj",
                   "make-purposes", "gatode-train", "gatode-serve", "info")
# phase 56: gatode-train's epochs (its other options at their defaults)
GATODE_CLI_EPOCHS = 2
# the CLI's main in a process of its own that prints, as its last line, the
# launch counts of the kernel wrappers after the command
CLI_PROBE = (
    "import json, sys\n"
    "from ananke_abm_tpu_torch.cli.main import main\n"
    "from ananke_abm_tpu_torch.ops.cuda import fused_gat, fused_step, "
    "fused_train\n"
    "main(sys.argv[1:])\n"
    "ks = {'K1': fused_step.rk4_interval_decode_fused,\n"
    "      'K2f': fused_train.day_forward_fused,\n"
    "      'K2b': fused_train.day_backward_fused,\n"
    "      'K3f': fused_train.ce_forward_fused,\n"
    "      'K3b': fused_train.ce_backward_fused,\n"
    "      'K4f': fused_gat.gat_forward_fused,\n"
    "      'K4b': fused_gat.gat_backward_fused}\n"
    "print(json.dumps({k: f.launches for k, f in ks.items()}))\n")


def ananke_run(argv, timeout=900, probe=False):
    """``python -m ananke_abm_tpu_torch.cli.main *argv`` (or, with
    ``probe``, the same main under CLI_PROBE) from the checkout's root on
    the card (no ANANKE_PLATFORM): (process, wall)."""
    env = {k: v for k, v in os.environ.items() if k != "ANANKE_PLATFORM"}
    head = ["-c", CLI_PROBE] if probe else ["-m",
                                            "ananke_abm_tpu_torch.cli.main"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *head, *map(str, argv)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc, time.perf_counter() - t0


def ananke_ok(argv, probe=False):
    proc, wall = ananke_run(argv, probe=probe)
    if proc.returncode != 0:
        fail(f"ananke {argv[0]} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc, wall


def labels_agree(a, b):
    return (a == b).float().mean().item()


def longest_run(labels):
    """The longest run of one label in any row of a (B, T) tensor."""
    Y = labels.cpu().numpy()
    best = 0
    for row in Y:
        change = np.flatnonzero(np.r_[True, row[1:] != row[:-1], True])
        best = max(best, int(np.diff(change).max()))
    return best


def semi_crf_checks(dev, card, Y_grid):
    """Phase 52: the semi-CRF at full width, card against CPU, on
    TRAJ_CHECK_ROWS rows of the L = 360 grid; returns the card's times."""
    from ananke_abm_tpu_torch.ops import semi_crf as sc

    B, D = TRAJ_CHECK_ROWS, TRAJ_DMAX_MIN // TRAJ_GRID_MIN
    P = int(Y_grid.max()) + 1
    g = torch.Generator().manual_seed(SCHED_SEED)
    U = torch.randn(B, Y_grid.shape[1], P, generator=g) * 2.0
    dur = torch.randn(P, D, generator=g) * 0.5
    A = torch.randn(P, P, generator=g) * 0.5
    y = torch.as_tensor(Y_grid[:B], dtype=torch.int64)
    out = {}
    for where in ("cpu", dev):
        u, d, a, lab = (t.to(where) for t in (U, dur, A, y))
        res = {"logZ": sc.semicrf_log_partition(u, d, a).cpu(),
               "logZ_self": sc.semicrf_log_partition(u, d, a, True).cpu(),
               "gold": sc.semicrf_gold_log_marginal(u, lab, d, a).cpu(),
               "path": sc.semicrf_path_score(u, lab, d, a).cpu()}
        for exact in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (u, d, a)]
            nll = sc.semicrf_nll(leaves[0], lab, leaves[1], leaves[2],
                                 exact_long=exact)
            nll.backward()
            res[f"nll_{exact}"] = nll.detach().cpu().reshape(1)
            res[f"grads_{exact}"] = [t.grad.cpu() for t in leaves]
        for self_ in (False, True):
            res[f"decode_{self_}"] = sc.semicrf_decode(u, d, a, self_).cpu()
        out[str(where)] = res
    cpu, card_out = out["cpu"], out[str(dev)]
    rels = {k: max_rel(card_out[k], cpu[k])
            for k in ("logZ", "logZ_self", "gold", "path", "nll_False",
                      "nll_True")}
    coss = {f"{k} {n}": cosine(gg, cg)
            for k in ("grads_False", "grads_True")
            for n, gg, cg in zip(("U", "dur", "A"), card_out[k], cpu[k])}
    agree = {k: labels_agree(card_out[k], cpu[k])
             for k in ("decode_False", "decode_True")}
    path_rel = max_rel(sc.semicrf_path_score(U, card_out["decode_False"].long(),
                                             dur, A),
                       sc.semicrf_path_score(U, cpu["decode_False"].long(),
                                             dur, A))
    run = longest_run(card_out["decode_False"])
    print(f"semi-CRF at L={Y_grid.shape[1]}, D={D}, P={P} on {B} rows, card "
          f"against CPU: " + ", ".join(f"{k} rel {v:.2e}"
                                       for k, v in rels.items())
          + f" (<= {SEMI_RTOL}); gradient cosines " + ", ".join(
              f"{k} {v:.9f}" for k, v in coss.items())
          + f" (> {SEMI_COS_MIN}); decoded labels agree " + ", ".join(
              f"allow_self={k[7:]} {v:.6f}" for k, v in agree.items())
          + f" (>= {SEMI_LABELS_MIN}), their path scores rel {path_rel:.2e};"
          f" longest decoded run without allow_self {run} bins (<= {D})",
          flush=True)
    if max(rels.values()) > SEMI_RTOL or path_rel > SEMI_RTOL:
        fail("the card's semi-CRF recursions disagree with the CPU's")
    if min(coss.values()) <= SEMI_COS_MIN:
        fail("the card's semi-CRF gradients disagree with the CPU's")
    if min(agree.values()) < SEMI_LABELS_MIN:
        fail("the card's semi-CRF decode disagrees with the CPU's")
    if run > D:
        fail(f"a decoded run of {run} bins exceeds Dmax = {D} bins")

    # the card's times: the recursions at the training batch (32 rows), the
    # decode at the generation chunk (512 rows)
    u32, d, a, lab32 = (t.to(dev) for t in (U[:32], dur, A, y[:32]))
    u512 = torch.randn(512, Y_grid.shape[1], P, device=dev) * 2.0

    def nll_step():
        leaf = u32.clone().requires_grad_(True)
        sc.semicrf_nll(leaf, lab32, d, a, exact_long=True).backward()

    times = {
        "log Z (32 rows)": cuda_ms(lambda: sc.semicrf_log_partition(
            u32, d, a, True), 3),
        "gold marginal (32)": cuda_ms(lambda: sc.semicrf_gold_log_marginal(
            u32, lab32, d, a), 3),
        "path score (32)": cuda_ms(lambda: sc.semicrf_path_score(
            u32, lab32, d, a), 3),
        "NLL exact_long + backward (32)": cuda_ms(nll_step, 3),
        "decode allow_self (512)": cuda_ms(lambda: sc.semicrf_decode(
            u512, d, a, True), 3),
        "decode (512)": cuda_ms(lambda: sc.semicrf_decode(u512, d, a), 3),
    }
    print("semi-CRF on the card (CUDA events, eager): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()) + f" [card {card}]",
        flush=True)
    return times


def cut_activities(acts, n_persons):
    """The activities of the first ``n_persons`` persons."""
    keep = np.isin(acts["persid"], np.unique(acts["persid"])[:n_persons])
    return {k: v[keep] for k, v in acts.items()}


def traj_step_profile(dev, card, mode, Y):
    """One traj_embed step at full width in ``mode`` under torch.profiler:
    (busy ms, wall ms, device operations) or None."""
    from ananke_abm_tpu_torch.models.traj_syn.configs import (
        CRFConfig,
        TrajEmbedConfig,
    )
    from ananke_abm_tpu_torch.models.traj_syn.model import init_params
    from ananke_abm_tpu_torch.models.traj_syn.pipeline import train_full as tf
    from ananke_abm_tpu_torch.utils.optim import ClippedAdamW
    from ananke_abm_tpu_torch.utils.seed import generator

    cfg = TrajEmbedConfig()
    crf_cfg = CRFConfig(crf_mode=mode, semi_Dmax_minutes=TRAJ_DMAX_MIN)
    P = int(Y.max()) + 1
    model = tf.build_model(cfg, Y.shape[1], P, dev)
    init_params(model, torch.Generator().manual_seed(0))
    crf = tf.init_crf_head(generator(dev, 0, 1), P, crf_cfg)
    for v in crf.values():
        v.requires_grad_(True)
    opt = ClippedAdamW(list(model.parameters()) + list(crf.values()),
                       cfg.lr, cfg.weight_decay, cfg.grad_clip)
    feats = torch.rand(P, 8, device=dev)
    loss_fn = tf.make_loss_fn(model, crf, crf_cfg, cfg.lambda_crf, feats)
    batch = torch.as_tensor(Y[:32], dtype=torch.int64, device=dev)
    mask = torch.ones(32, device=dev)
    gen = generator(dev, 0, 2)
    model.train()

    def step():
        opt.zero_grad()
        loss_fn(batch, mask, 1.0, gen)[0].backward()
        opt.step()

    step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"traj_embed step, {mode}, batch 32 x {Y.shape[1]} bins at full "
          f"width: {wall * 1e3:.1f} ms (host clock, synced)", flush=True)
    return device_busy(f"traj_embed {mode} step", step, card)


def traj_phases(dev, card, root, acts, csv_path, walls):
    """Phases 51-55: the purposes catalog and the buffer grid, the
    semi-CRF card against CPU, ``train_traj_embed`` at TrajEmbedConfig's
    full width, generation and validation, and the ``ananke`` CLI as
    subprocesses. None launches a hand-written kernel. Every phase raises
    on failure."""
    import importlib.util

    from ananke_abm_tpu_torch.data_generator.population import (
        COLUMNS,
        write_csv,
    )
    from ananke_abm_tpu_torch.models.traj_syn.configs import TrajEmbedConfig
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
        train_traj_embed,
    )
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.vae_only import (
        analyze_vae,
        synthesize_vae,
    )
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.validate import (
        CHUNK,
        gen_n_val_traj,
        generate_trajectories,
        load_generator,
    )
    from ananke_abm_tpu_torch.utils.make_purposes import (
        LEAD_COLUMNS,
        build_purposes_catalog,
    )
    from ananke_abm_tpu_torch.utils.traj_fig.make_buffer_grid import (
        make_buffer_grid,
    )

    traj = root / "traj"
    traj.mkdir()

    # ---- 51. the purposes catalog and the buffer grid -------------------
    t_phase = time.perf_counter()
    catalog_csv = traj / "purposes.csv"
    t0 = time.perf_counter()
    catalog = build_purposes_catalog(csv_path, str(catalog_csv))
    t_cat = time.perf_counter() - t0
    if list(catalog)[:len(LEAD_COLUMNS)] != LEAD_COLUMNS or \
            len(catalog["purpose"]) != 7 or not np.isfinite(
                catalog["person_day_participation_rate"]).all():
        fail(f"the purposes catalog: columns {list(catalog)}, purposes "
             f"{catalog['purpose'].tolist()}")
    t0 = time.perf_counter()
    Y_traj, pm, persids = make_buffer_grid(csv_path, TRAJ_GRID_MIN)
    t_native = time.perf_counter() - t0
    with numpy_branch():
        t0 = time.perf_counter()
        Y_numpy, pm_numpy, _ = make_buffer_grid(csv_path, TRAJ_GRID_MIN)
        t_numpy = time.perf_counter() - t0
    if not (same_arrays(Y_traj, Y_numpy) and pm == pm_numpy):
        fail("make_buffer_grid differs between the native and numpy "
             "branches")
    L = 1800 // TRAJ_GRID_MIN
    if Y_traj.shape != (SCHED_PERSONS, L) or not (
            Y_traj[:, -1] == pm["Home"]).all():
        fail(f"the buffer grid {Y_traj.shape}, or a last bin not Home")
    walls[51] = time.perf_counter() - t_phase
    print(f"purposes catalog of {len(acts['persid'])} activities: "
          f"{len(catalog['purpose'])} purposes x {len(catalog)} columns in "
          f"{t_cat:.3f} s; buffer grid {Y_traj.shape} native {t_native:.3f} "
          f"s, numpy {t_numpy:.3f} s, equal (host clock)", flush=True)

    # ---- 52. the semi-CRF, card against CPU ----------------------------------
    t_phase = time.perf_counter()
    semi_crf_checks(dev, card, Y_traj)
    walls[52] = time.perf_counter() - t_phase

    # ---- 53. train_traj_embed at full width ------------------------------------
    t_phase = time.perf_counter()
    cut_csv = write_csv(str(traj / "activities_cut.csv"),
                        {k: v for k, v in cut_activities(
                            acts, TRAJ_TRAIN_ROWS).items() if k in COLUMNS})
    runs, epoch_walls, busy = {}, {}, {}
    for mode in ("semi", "linear"):
        run = traj / f"run_{mode}"
        res = train_traj_embed(cut_csv, str(catalog_csv), epochs=TRAJ_EPOCHS,
                               outdir=str(run), crf_mode=mode,
                               seed=SCHED_SEED, device=dev)
        log = read_log(str(run / "training_log.csv"))
        if len(log) != TRAJ_EPOCHS or not all(
                np.isfinite(list(row.values())).all() for row in log) or \
                not (run / "ckpt_best.ckpt").exists():
            fail(f"train_traj_embed {mode}: {len(log)} epochs, a loss not "
                 f"finite, or no ckpt_best.ckpt")
        runs[mode] = str(run / "ckpt_best.ckpt")
        epoch_walls[mode] = res["seconds"] / TRAJ_EPOCHS
        print(f"train_traj_embed {mode} (exact_long: {mode == 'semi'}): "
              f"{TRAJ_EPOCHS} epochs on the first {TRAJ_TRAIN_ROWS} persons "
              f"(a cut of depth; batch 32, L={L}) in {res['seconds']:.3f} s "
              f"({epoch_walls[mode]:.3f} s an epoch, its validation pass "
              f"included); losses " + ", ".join(
                  f"{row['loss']:.4f}" for row in log) + f" [card {card}]",
              flush=True)
        busy[mode] = traj_step_profile(dev, card, mode, Y_traj)
    walls[53] = time.perf_counter() - t_phase

    # ---- 54. generation, validation and the VAE's synthesis -------------------
    t_phase = time.perf_counter()
    rates = {}
    for name, ckpt, mode in (("semi", runs["semi"], "semi"),
                             ("linear", runs["linear"], "linear"),
                             ("none", runs["semi"], "none")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Y_gen, meta = generate_trajectories(ckpt, TRAJ_GEN, seed=SCHED_SEED,
                                            crf_mode=mode, device=dev)
        t_gen = time.perf_counter() - t0
        rates[name] = TRAJ_GEN / t_gen
        t0 = time.perf_counter()
        summary = gen_n_val_traj(ckpt, TRAJ_GEN, str(traj / f"gen_{name}.csv"),
                                 csv_path, 5, mode,
                                 summary_json=str(traj / f"s_{name}.json"),
                                 seed=SCHED_SEED, device=dev)
        t_val = time.perf_counter() - t0
        v = summary["validation"]
        if Y_gen.shape != (TRAJ_GEN, L) or Y_gen.min() < 0 or \
                Y_gen.max() >= len(meta["purpose_map"]) or v["L"] != L or \
                not np.isfinite(v["tod_jsd_macro"]):
            fail(f"generation {name}: {Y_gen.shape}, validation {v}")
        print(f"generate {name}: {TRAJ_GEN} schedules in {t_gen:.3f} s "
              f"({rates[name]:.0f} schedules/s, chunks of {CHUNK}); "
              f"gen_n_val_traj with the segment CSV and the report against "
              f"the {SCHED_PERSONS} persons in {t_val:.3f} s: tod_jsd_macro "
              f"{v['tod_jsd_macro']:.5f}, mean segments "
              f"{summary['generated_stats']['mean_segments_per_person']:.2f}"
              f" [card {card}]", flush=True)
    z = torch.randn(CHUNK, TrajEmbedConfig().z_dim,
                    generator=torch.Generator().manual_seed(SCHED_SEED))
    for mode in ("semi", "linear"):
        got = {}
        for where in ("cpu", dev):
            decode, _, _ = load_generator(runs[mode], mode, device=where)
            got[str(where)] = decode(z.to(where)).cpu()
        agree = labels_agree(got[str(dev)], got["cpu"])
        print(f"one chunk of {CHUNK} decoded {mode}, card against CPU, the "
              f"same z: labels agree {agree:.6f} (>= {SEMI_LABELS_MIN})",
              flush=True)
        if agree < SEMI_LABELS_MIN:
            fail(f"the card's {mode} decode disagrees with the CPU's")
    t0 = time.perf_counter()
    npz = synthesize_vae(runs["semi"], TRAJ_GEN, str(traj / "vae" / "s.npz"),
                         seed=SCHED_SEED, device=dev)
    stats = analyze_vae(npz, str(traj / "vae" / "analysis.json"))
    t_vae = time.perf_counter() - t0
    if stats["N"] != TRAJ_GEN or abs(sum(stats["minutes_share"].values())
                                     - 1.0) > 1e-6:
        fail(f"analyze_vae: {stats}")
    walls[54] = time.perf_counter() - t_phase
    print(f"synthesize_vae + analyze_vae: {TRAJ_GEN} schedules in "
          f"{t_vae:.3f} s, {stats['unique_schedules']} unique", flush=True)

    # ---- 55. the ananke CLI as subprocesses ---------------------------------
    t_phase = time.perf_counter()
    cli = traj / "cli"
    cli.mkdir()
    cli_walls = {}
    proc, cli_walls["--help"] = ananke_ok(["--help"])
    missing = [c for c in ANANKE_COMMANDS if c not in proc.stdout]
    if missing:
        fail(f"ananke --help lists no {missing}")
    _, cli_walls["make-purposes"] = ananke_ok(
        ["make-purposes", "--activities-csv", csv_path, "--out-csv",
         cli / "purposes.csv"])
    if (cli / "purposes.csv").read_bytes() != catalog_csv.read_bytes():
        fail("ananke make-purposes differs from phase 51's catalog")
    _, cli_walls["traj-embed"] = ananke_ok(
        ["traj-embed", "--activities-csv", cut_csv, "--crf-mode", "semi",
         "--epochs", 1, "--outdir", cli / "run"])
    _, cli_walls["gval-traj"] = ananke_ok(
        ["gval-traj", "--ckpt", cli / "run" / "ckpt_best.ckpt", "--num-gen",
         CLI_TRAJ_GEN, "--gen-csv", cli / "gen.csv", "--val-csv", cut_csv,
         "--summary-json", cli / "summary.json"])
    summary = json.loads((cli / "summary.json").read_text())
    if summary["num_gen"] != CLI_TRAJ_GEN or "validation" not in summary:
        fail(f"ananke gval-traj: {summary}")
    # one process on one card: --data-parallel is the single-device run
    proc, cli_walls["traj-embed --data-parallel"] = ananke_ok(
        ["traj-embed", "--activities-csv", cut_csv, "--crf-mode", "semi",
         "--epochs", 1, "--outdir", cli / "dp", "--data-parallel"])
    if not (cli / "dp" / "ckpt_best.ckpt").exists():
        fail("ananke traj-embed --data-parallel wrote no checkpoint")
    plots = importlib.util.find_spec("matplotlib") is not None
    proc, cli_walls["visualize-combined-traj"] = ananke_run(
        ["visualize-combined-traj", "--trajectory-csv", cli / "gen.csv",
         "--outdir", cli / "figs"])
    pngs = sorted(p.name for p in (cli / "figs").glob("*.png")) \
        if plots else []
    if plots and (proc.returncode != 0 or "stacked_traj.png" not in pngs):
        fail(f"ananke visualize-combined-traj: {proc.returncode}, {pngs}")
    if not plots and (proc.returncode == 0 or
                      "matplotlib" not in proc.stderr):
        fail(f"ananke visualize-combined-traj without matplotlib exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    proc, cli_walls["info"] = ananke_ok(["info"])
    if torch.cuda.get_device_name(0) not in proc.stdout:
        fail(f"ananke info: {proc.stdout}")
    walls[55] = time.perf_counter() - t_phase
    print("ananke (python -m, one process each, on the card): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in cli_walls.items())
        + f"; make-purposes equal to phase 51's catalog; "
        f"visualize-combined-traj "
        + (f"{len(pngs)} PNGs" if plots else "exits naming matplotlib "
           "(absent)") + f"; info: {proc.stdout.strip().splitlines()[-1]} "
        f"[card {card}]", flush=True)
    print("traj_syn on the card: semi-CRF step busy "
          + ", ".join(f"{m} " + ("not measured" if b is None else
                                 f"{b[0] / b[1]:.1%} of {b[1]:.1f} ms, "
                                 f"{b[2]} device operations")
                      for m, b in busy.items())
          + "; epoch walls " + ", ".join(f"{m} {w:.3f} s"
                                         for m, w in epoch_walls.items())
          + "; schedules/s " + ", ".join(f"{m} {r:.0f}"
                                         for m, r in rates.items())
          + f" [card {card}]", flush=True)
    return cut_csv, catalog_csv


def gatode_cli_phase(card):
    """Phase 56 (after the build): ``ananke gatode-train`` for
    GATODE_CLI_EPOCHS epochs at its other defaults, then ``gatode-serve``
    with the kernel on and off, as subprocesses of the CLI's main that
    print their kernel launches. Each served grid equals ``serve()`` in this
    process on the same checkpoint, seed and route, bit for bit; the
    kernel's ids agree with its plain version's body (bf16 products, as
    phase 4) at SLICE_IDS_MIN. ``--use-pallas off`` runs the float32 body,
    a different model by its rounding: its agreement with the kernel's ids
    is printed, not bounded."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.params import (
        load_flax_params,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import _kernel_body
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        serve,
    )
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        rk4_interval_decode_reference,
    )
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    t_phase = time.perf_counter()
    out = OUT / "ananke_gatode"
    if out.exists():
        shutil.rmtree(out)
    proc, t_train = ananke_ok(["gatode-train", "--outdir", out, "--epochs",
                               GATODE_CLI_EPOCHS], probe=True)
    lines = proc.stdout.strip().splitlines()
    train_launches = json.loads(lines[-1])
    ckpt = lines[-2].rsplit("; ckpt ", 1)[1]
    steps = GATODE_CLI_EPOCHS * (8192 // 4096)
    for k in ("K2f", "K2b", "K3f", "K3b", "K4f", "K4b"):
        if train_launches[k] != steps:
            fail(f"ananke gatode-train launched {k} {train_launches[k]} "
                 f"times, not once a step ({steps})")
    ids, serve_walls = {}, {}
    for use in ("on", "off"):
        proc, serve_walls[use] = ananke_ok(
            ["gatode-serve", "--ckpt", ckpt, "--out-npz", out / f"{use}.npz",
             "--use-pallas", use], probe=True)
        k1 = json.loads(proc.stdout.strip().splitlines()[-1])["K1"]
        with np.load(out / f"{use}.npz") as d:
            ids[use] = d["zone_ids"]
        want = ids[use].shape[1] - 1 if use == "on" else 0
        if k1 != want:
            fail(f"ananke gatode-serve --use-pallas {use} launched K1 {k1} "
                 f"times, not {want}")
        serve(ckpt, str(out / "in_process.npz"), use_kernel=use == "on",
              device="cuda")
        with np.load(out / "in_process.npz") as d:
            if not np.array_equal(d["zone_ids"], ids[use]):
                fail(f"ananke gatode-serve --use-pallas {use}: ids differ "
                     f"from serve() in this process")
    # the kernel's plain version over the same agents (serve()'s defaults)
    ck = load_checkpoint(ckpt)
    config = GATODEConfig(**ck["config"])
    data = generate_agent_population(
        4096, num_times=int(ck["num_times"]), seed=1,
        num_zones=int(ck["num_zones"]), world_seed=int(ck["world_seed"]))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to("cuda")
    model = build_model(config, data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device="cuda")
    load_flax_params(model, ck["params"])
    body = _kernel_body(model, config.substeps, rk4_interval_decode_reference)
    with torch.inference_mode():
        plain = body(on(data["zone_features"]), on(data["adj"]),
                     on(data["times"]), on(data["person_feats"]),
                     on(data["home_zone"], torch.long)).cpu().numpy()
    agree = float(np.mean(ids["on"] == plain))
    f32 = float(np.mean(ids["on"] == ids["off"]))
    print(f"ananke gatode-train ({GATODE_CLI_EPOCHS} epochs, 8,192 agents x "
          f"48 times, batch 4,096; launches {train_launches}) "
          f"{t_train:.3f} s; gatode-serve 4,096 agents --use-pallas on "
          f"{serve_walls['on']:.3f} s, off {serve_walls['off']:.3f} s "
          f"(one process each); both equal to serve() in this process, bit "
          f"for bit; the kernel's ids against its plain version's body agree "
          f"{agree:.6f} (>= {SLICE_IDS_MIN}), against the float32 body "
          f"(off) {f32:.6f}; phase 56 in {time.perf_counter() - t_phase:.1f} "
          f"s [card {card}]", flush=True)
    if agree < SLICE_IDS_MIN:
        fail("gatode-serve's kernel ids disagree with its plain version's")


# ---- the trajectory ODE families (phases 57-60) ----------------------------

# phase 57 and tests/test_torch_cuda.py: card against CPU over one step,
# float32 against float32 (the schedule phases' class of bounds); the
# GenerativeODE's fixed grid is 2,401 internal steps at its defaults
ODE_RTOL = 1e-4
ODE_COS_MIN = 0.9999
ODE_IDS_MIN = 0.999
ODE_SEED = 0
# phase 60: mode_sep's travel-margin component is a masked mean of hinges
# max(m - (d_prev - d_dest), 0), with d_prev - d_dest a difference of two
# distances far larger than the hinges: float32 rounding moves it by up to
# ~4e-2 of itself, on the CPU as on the card (H100 80GB HBM3, 700 W: card
# against CPU 2.0e-4, 3.8e-2, 9.9e-3 over 3 seeds; from the float64
# witness the CPU 1.6e-4, 1.3e-2, 1.8e-2, the card 3.6e-4, 2.5e-2,
# 8.4e-3). The hinge is 1-Lipschitz in d_prev - d_dest, so distances
# within ODE_RTOL of themselves move the mean by at most ODE_RTOL x the
# masked mean of d_prev + d_dest ("travel_distances", itself held to
# ODE_RTOL): its bound, with the float64 witness printed beside it; every
# other component to ODE_RTOL of itself.
MODESEP_SCALED = {"travel_margin": "travel_distances"}
# phase 58 (a cut of depth: the reference runs 25,000 iterations)
LODE_ITERS = 6
LODE_STEPS_PER_CALL = 3
# phase 59: the inference engine
LODE_SAMPLES = 3
LODE_EVAL_POINTS = 500
LODE_BATCH_SIZES = (1, 10, 50, 100, 4_096, 65_536)
# phase 60 (cuts of depth: the reference runs 2,000 epochs)
MODESEP_EPOCHS = 3
MODESEP_SDE_EPOCHS = 1
# the longest wait for phases 57-60's process after phase 55
TRAJECTORY_ODE_TIMEOUT = 600


def card_cpu_readings(step, dev, scaled=None):
    """Run ``step(device, witness)`` (which returns ({component: 0-d
    tensor}, {parameter: gradient}, {name: output tensor}, {name: ids})) on
    ``dev`` and on the CPU: each component's relative difference, the
    largest of an output, the least gradient cosine and the least ids
    agreement. ``scaled`` {component: scale}: that component's difference
    is taken relative to the CPU's value of the component ``scale``
    instead of to itself. ``witness`` True runs the step in float64 on the
    CPU."""
    cuda_out = step(dev, False)
    cpu_out = step(torch.device("cpu"), False)
    (cc, gc, oc, ic), (kc, kg, ko, ki) = cpu_out, cuda_out
    scaled = scaled or {}
    rel = {k: abs(kc[k].item() - v.item()) / max(abs(v.item()), 1e-30)
           for k, v in cc.items()}
    per = {k: (abs(kc[k].item() - cc[k].item())
               / max(abs(cc[scaled[k]].item()), 1e-30) if k in scaled
               else v)
           for k, v in rel.items()}
    r = {"per": per, "rel": rel, "scaled": scaled,
         "comps": max(per.values()),
         "outputs": max(max_rel(ko[k].cpu(), v) for k, v in oc.items()),
         "cos": min(cosine(kg[k].cpu(), v) for k, v in gc.items()),
         "ids": min(float((ki[k].cpu() == v).float().mean())
                    for k, v in ic.items())}
    r["ok"] = (r["comps"] <= ODE_RTOL and r["cos"] > ODE_COS_MIN
               and r["ids"] >= ODE_IDS_MIN)
    r["outputs_of"] = {"cpu": cpu_out, "cuda": cuda_out}
    return r


def ode_witness_readings(step, r):
    """The float64 CPU witness of a card-against-CPU check: each
    component's relative distance from it, on the CPU and on the card, and
    the outputs' and gradients' (the line printed beside a component held
    relative to another's scale)."""
    wc, wg, wo, wi = step(torch.device("cpu"), True)
    out = {}
    for where in ("cpu", "cuda"):
        c, g, o, i = r["outputs_of"][where]
        out[where] = {
            "comps": {k: abs(c[k].item() - v.item()) / max(abs(v.item()),
                                                           1e-300)
                      for k, v in wc.items()},
            "outputs": max(max_rel(o[k].cpu(), v) for k, v in wo.items()),
            "cos": min(cosine(g[k].cpu(), v.float()) for k, v in wg.items()),
            "ids": min(float((i[k].cpu() == v).float().mean())
                       for k, v in wi.items())}
    return out


def describe_witness(w):
    return "; ".join(
        f"{where}: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                 w[where]["comps"].items())
        + f"; outputs {w[where]['outputs']:.3e}, least gradient cosine "
        f"{w[where]['cos']:.7f}, ids {w[where]['ids']:.6f}"
        for where in ("cpu", "cuda"))


def latent_ode_step(config, person_ids=(1, 2), seed=ODE_SEED):
    """``step(device, witness)`` for card_cpu_readings: one GenerativeODE
    loss-and-gradient at ``config`` on the personas' batch, the same
    weights and draws (eps and the SDE's step noise, made on the CPU from
    ``seed``) on every device."""
    from ananke_abm_tpu_torch.models.latent_ode import model as lmodel
    from ananke_abm_tpu_torch.models.latent_ode import train as ltrain

    state = {}

    def step(where, witness):
        model, b, host = ltrain.build_model_and_batch(config, person_ids,
                                                      device=where)
        if "weights" not in state:
            lmodel.init_params(model, torch.Generator().manual_seed(seed))
            state["weights"] = lmodel.to_flax_params(model)
            g = torch.Generator().manual_seed(seed + 1)
            B = b["person_features"].shape[0]
            D = config.state_dim + config.hidden_dim
            steps = int(round(config.sde_span_hours / config.sde_dt)) + 1
            state["eps"] = torch.randn((B, config.hidden_dim), generator=g)
            state["noise"] = torch.randn((steps, B, D), generator=g)
        lmodel.load_flax_params(model, state["weights"])
        eps, noise = state["eps"], state["noise"]
        if witness:
            model = model.double()
            b = {k: (v.double() if v.is_floating_point() else v)
                 for k, v in b.items()}
            eps, noise = eps.double(), noise.double()
        forward = ltrain.make_forward(model)
        times = host["t_unified"].astype(np.float32)
        out = forward(b, None, eps.to(where), noise.to(where), times)
        cand = model.encode_zones(b["all_zone_features"])
        total, comps = ltrain.calculate_composite_loss(b, out, cand, config)
        total.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        outputs = dict(zip(("loc_embed", "purpose_feat", "mode_feat", "mu",
                            "logvar"), (out[1], out[4], out[5], out[6],
                                        out[7])))
        ids = {"zone": out[0].argmax(-1), "purpose": out[2].argmax(-1),
               "mode": out[3].argmax(-1)}
        return ({k: v.detach() for k, v in comps.items()}, grads,
                {k: v.detach() for k, v in outputs.items()}, ids)

    return step


def mode_sep_step(csvs, config, seed=ODE_SEED):
    """``step(device, witness)`` for card_cpu_readings: one ModeSepModel
    loss-and-gradient over every person of the CSV family at ``config``,
    the same weights (the drift's output layer drawn, so the dynamics
    move) on every device."""
    from ananke_abm_tpu_torch.models.mode_sep import model as mmodel
    from ananke_abm_tpu_torch.models.mode_sep import train as mtrain
    from ananke_abm_tpu_torch.models.mode_sep.batching import (
        build_union_batch,
    )
    from ananke_abm_tpu_torch.models.mode_sep.data import (
        load_trajectory_csvs,
    )
    from ananke_abm_tpu_torch.models.mode_sep.losses import total_loss

    people, shared = load_trajectory_csvs(*csvs)
    union = build_union_batch(people, config.K_internal,
                              config.time_match_tol)
    state = {}

    def step(where, witness):
        model = mmodel.ModeSepModel(shared.id_maps.Z, config).to(where)
        if "weights" not in state:
            g = torch.Generator().manual_seed(seed)
            mmodel.init_params(model, g)
            with torch.no_grad():
                model.drift.out.weight.copy_(0.1 * torch.randn(
                    model.drift.out.weight.shape, generator=g))
            state["weights"] = mmodel.to_flax_params(model)
        mmodel.load_flax_params(model, state["weights"])
        times, b = mtrain.union_to_device(union, where)
        dist = torch.as_tensor(shared.dist_mat).to(where)
        if witness:
            model = model.double()
            times, dist = times.double(), dist.double()
            b = {k: (v.double() if v.is_floating_point() else v)
                 for k, v in b.items()}
        pred_emb, logits, v = model(times, b["home_idx"], b["work_idx"],
                                    b["traits"])
        total, comps = total_loss(config, logits, pred_emb, v,
                                  model.class_table, dist, b)
        total.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        comps = {k: c.detach() for k, c in comps.items() if k != "acc"}
        with torch.no_grad():
            # the travel margin's scale: the masked mean of d_prev + d_dest
            d = sum(torch.sqrt(((pred_emb - model.class_table[
                b[k].clamp_min(0)]) ** 2).sum(-1) + 1e-12)
                for k in ("prev_zone", "dest_zone"))
            m = b["travel_mask"].to(d.dtype)
            comps["travel_distances"] = (d * m).sum() / m.sum().clamp_min(1)
        return (comps, grads, {"pred_emb": pred_emb.detach(),
                               "v": v.detach()},
                {"zone": logits.argmax(-1)})

    return step


def mode_sep_readings(step, dev):
    """phase 60's check: the components of MODESEP_SCALED within ODE_RTOL
    of their scale, the others within ODE_RTOL of themselves, with the
    float64 witness read beside them; (readings, witness, ok)."""
    r = card_cpu_readings(step, dev, MODESEP_SCALED)
    return r, ode_witness_readings(step, r), r["ok"]


def describe_readings(r):
    return ("components rel diff " + ", ".join(
        f"{k} {v:.3e}" + (f" of {r['scaled'][k]} ({r['rel'][k]:.3e} of "
                          f"itself)" if k in r["scaled"] else "")
        for k, v in r["per"].items())
            + f" (<= {ODE_RTOL}), "
            f"outputs {r['outputs']:.3e}, least gradient cosine "
            f"{r['cos']:.7f} (> {ODE_COS_MIN}), ids agree {r['ids']:.6f} "
            f"(>= {ODE_IDS_MIN})")


def start_trajectory_ode():
    """Start phases 57-60 and 64-65 (``--trajectory-ode``) in a process of
    their own: their eager loops and host work run on one core, beside the
    schedule phases' process and the build. Its output goes to a log that
    :func:`finish_trajectory_ode` prints; the process is killed if this one
    exits first."""
    import atexit

    OUT.mkdir(parents=True, exist_ok=True)
    log = OUT / "trajectory_ode.log"
    f = open(log, "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--trajectory-ode"],
        stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, f, log, time.perf_counter(), stop


def finish_trajectory_ode(handle, timeout=TRAJECTORY_ODE_TIMEOUT):
    """Wait for phases 57-60 and 64-65's process, print its output, fail
    if it failed."""
    proc, f, log, t0, stop = handle
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        stop()
        f.close()
    text = log.read_text()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    if rc != 0:
        fail(f"phases 57-60, 64-65 (python3 chip_smoke.py --trajectory-ode) "
             f"exited {rc} after {time.perf_counter() - t0:.1f} s")
    print(f"phases 57-60, 64-65 in their own process: "
          f"{time.perf_counter() - t0:.1f} s from its start", flush=True)


def trajectory_ode_phases(dev, card, root, walls):
    """Phases 57-60: the Euler-Maruyama solver and the GenerativeODE card
    against CPU, latent_ode ``train()``, its inference engine and
    ``evaluate()``, and mode_sep's train -> infer -> evaluate on the mock
    world's CSV family. No phase launches a hand-written kernel. Every
    phase raises on failure."""
    from ananke_abm_tpu_torch.data_generator.export_csvs import (
        write_mock_world_csvs,
    )
    from ananke_abm_tpu_torch.models.latent_ode import train as ltrain
    from ananke_abm_tpu_torch.models.latent_ode.config import (
        GenerativeODEConfig,
    )
    from ananke_abm_tpu_torch.models.latent_ode.evaluate import (
        evaluate as lode_evaluate,
    )
    from ananke_abm_tpu_torch.models.latent_ode.inference import (
        BatchedInferenceEngine,
    )
    from ananke_abm_tpu_torch.models.latent_ode.model import load_flax_params
    from ananke_abm_tpu_torch.models.mode_sep import train as mtrain
    from ananke_abm_tpu_torch.models.mode_sep.config import ModeSepConfig
    from ananke_abm_tpu_torch.models.mode_sep.evaluate import (
        evaluate as ms_evaluate,
    )
    from ananke_abm_tpu_torch.models.mode_sep.inference import run_inference
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint
    from ananke_abm_tpu_torch.utils.seed import generator

    ode = root / "trajectory_ode"
    if ode.exists():
        shutil.rmtree(ode)
    ode.mkdir(parents=True)
    config = GenerativeODEConfig()
    steps = int(round(config.sde_span_hours / config.sde_dt)) + 1

    # ---- 57. the solver and GenerativeODE, card against CPU ---------------
    t_phase = time.perf_counter()
    step = latent_ode_step(config)
    t0 = time.perf_counter()
    r = card_cpu_readings(step, dev)
    print(f"GenerativeODE step at its defaults (hidden 32, encoder 64, ODE "
          f"hidden 128, zone embedding 8, 2 blocks; the two personas; the "
          f"fixed grid, {steps} Euler-Maruyama steps, one injected noise "
          f"tensor), card against CPU: {describe_readings(r)}; states "
          f"(positions, mu, logvar) max rel diff {r['outputs']:.3e}; both "
          f"runs {time.perf_counter() - t0:.3f} s [card {card}]", flush=True)
    if not r["ok"]:
        print("GenerativeODE step: float64 CPU witness: "
              + describe_witness(ode_witness_readings(step, r)),
              flush=True)
        fail("the GenerativeODE step on the card disagrees with the CPU")
    walls[57] = time.perf_counter() - t_phase

    # ---- 58. latent_ode train() ---------------------------------------------
    t_phase = time.perf_counter()
    run = ode / "latent_ode"
    res = ltrain.train(str(run), config=config, num_iterations=LODE_ITERS,
                       steps_per_call=LODE_STEPS_PER_CALL, log_every=0,
                       device=dev)
    hist = np.load(run / "loss_history.npz")
    if not (run / "latent_ode_best_model.ckpt").exists() or \
            hist["total"].shape != (LODE_ITERS,) or \
            not np.isfinite(hist["total"]).all():
        fail(f"latent_ode train(): history {hist['total']}, or no "
             f"checkpoint")
    lode_iter = res["seconds"] / LODE_ITERS
    print(f"latent_ode train() at its defaults: {LODE_ITERS} iterations in "
          f"calls of {LODE_STEPS_PER_CALL} (a cut of depth; the reference "
          f"runs {config.num_iterations}) in {res['seconds']:.3f} s, "
          f"{lode_iter:.3f} s an iteration (host clock); totals "
          f"{', '.join(f'{v:.3f}' for v in hist['total'])} [card {card}]",
          flush=True)
    model, b, host = ltrain.build_model_and_batch(config, device=dev)
    load_flax_params(model, load_checkpoint(
        str(run / "latent_ode_best_model.ckpt"))["params"])
    optimizer = ltrain.make_optimizer(model, config)
    loss_fn = ltrain.make_loss_fn(model, config)
    times = host["t_unified"].astype(np.float32)

    def one_step():
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(b, generator(dev, 0, LODE_ITERS), times=times)
        loss.backward()
        optimizer.step()

    t0 = time.perf_counter()
    lode_busy = device_busy("latent_ode training step (2,401 SDE steps)",
                            one_step, card)
    print(f"the profiled step and its summary: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    walls[58] = time.perf_counter() - t_phase

    # ---- 59. the inference engine and evaluate() ----------------------------
    t_phase = time.perf_counter()
    ckpt = str(run / "latent_ode_best_model.ckpt")
    engine = BatchedInferenceEngine(ckpt, device=dev)
    eval_times = np.linspace(0.0, 24.0, LODE_EVAL_POINTS).astype(np.float32)
    t0 = time.perf_counter()
    preds = engine.predict_trajectories(num_samples=LODE_SAMPLES,
                                        times=eval_times)
    t_pred = time.perf_counter() - t0
    if preds["zones"].shape != (2, LODE_SAMPLES, LODE_EVAL_POINTS) or \
            preds["zones"].min() < 0 or preds["zones"].max() >= 8:
        fail(f"predict_trajectories: zones {preds['zones'].shape}")
    bench = engine.benchmark_performance(batch_sizes=LODE_BATCH_SIZES,
                                         times=eval_times)
    print(f"latent_ode predict_trajectories: {LODE_SAMPLES} samples x 2 "
          f"persons x {LODE_EVAL_POINTS} times in {t_pred:.3f} s; "
          f"benchmark_performance on {LODE_EVAL_POINTS} times: " + ", ".join(
              f"{bs} persons {bench[bs]['people_per_s']:.1f} people/s "
              f"({bench[bs]['s_per_batch']:.3f} s a batch)"
              for bs in LODE_BATCH_SIZES)
          + f"; projected_1M_people_hours "
          f"{bench['projected_1M_people_hours']:.4f} [card {card}]",
          flush=True)
    t0 = time.perf_counter()
    metrics = lode_evaluate(ckpt, str(ode / "latent_eval"), device=dev)
    if set(metrics["persons"]) != {"Ava", "Theo"}:
        fail(f"latent_ode evaluate(): {metrics}")
    print(f"latent_ode evaluate() at its defaults ({LODE_SAMPLES} samples, "
          f"{LODE_EVAL_POINTS} points) in {time.perf_counter() - t0:.3f} s: "
          + ", ".join(f"{k} zone acc {v['zone_accuracy']:.3f}, purpose acc "
                      f"{v['purpose_accuracy']:.3f}"
                      for k, v in metrics["persons"].items())
          + f" [card {card}]", flush=True)
    walls[59] = time.perf_counter() - t_phase

    # ---- 60. mode_sep -------------------------------------------------------
    t_phase = time.perf_counter()
    paths = write_mock_world_csvs(str(ode / "mock_world"))
    csvs = tuple(paths[k] for k in ("periods.csv", "snaps.csv", "zones.csv",
                                    "persons.csv", "dist_mat.csv"))
    ms_cfg = ModeSepConfig()
    step = mode_sep_step(csvs, ms_cfg)
    t0 = time.perf_counter()
    r, w, ok = mode_sep_readings(step, dev)
    print(f"ModeSepModel step at its defaults (E 64, context 32, zone "
          f"embedding 8, hidden 128, 2 blocks, K_internal 8, RK4 x 4), card "
          f"against CPU: {describe_readings(r)}; the float64 CPU witness's "
          f"distance: {describe_witness(w)}; the three runs "
          f"{time.perf_counter() - t0:.3f} s [card {card}]", flush=True)
    if not ok:
        fail("the ModeSepModel step on the card disagrees with the CPU")
    ms_walls = {}
    for name, cfg in (("rk4", dataclasses.replace(
            ms_cfg, max_epochs=MODESEP_EPOCHS)),
                      ("sde", dataclasses.replace(
                          ms_cfg, max_epochs=MODESEP_SDE_EPOCHS,
                          enable_sde=True))):
        out = ode / f"mode_sep_{name}"
        res = mtrain.train(*csvs[:2], str(out), config=cfg,
                           zones_csv=csvs[2], persons_csv=csvs[3],
                           dist_mat_csv=csvs[4], device=dev)
        if not (np.isfinite(res["best_loss"]) and
                (out / "best.ckpt").exists()):
            fail(f"mode_sep train() {name}: best loss {res['best_loss']}")
        ms_walls[name] = res["seconds"] / cfg.max_epochs
        print(f"mode_sep train() {name}: {cfg.max_epochs} epochs in "
              f"{res['seconds']:.3f} s (host clock) [card {card}]",
              flush=True)
    ckpt = str(ode / "mode_sep_rk4" / "best.ckpt")
    t0 = time.perf_counter()
    pred = run_inference(ckpt, *csvs[:2], str(ode / "mode_sep_inf"),
                         zones_csv=csvs[2], persons_csv=csvs[3],
                         dist_mat_csv=csvs[4], device=dev)
    t_inf = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms_metrics = ms_evaluate(ckpt, *csvs[:2], str(ode / "mode_sep_eval"),
                             zones_csv=csvs[2], persons_csv=csvs[3],
                             dist_mat_csv=csvs[4], device=dev)
    t_eval = time.perf_counter() - t0
    if len(pred["time"]) == 0 or not (ode / "mode_sep_inf" /
                                      "dense_rollout.npz").exists():
        fail("mode_sep run_inference wrote no predictions")
    walls[60] = time.perf_counter() - t_phase
    print(f"mode_sep on the mock world's CSVs: an epoch {ms_walls['rk4']:.3f}"
          f" s (RK4, {MODESEP_EPOCHS} epochs; the reference runs "
          f"{ms_cfg.max_epochs}), {ms_walls['sde']:.3f} s (the SDE variant, "
          f"{MODESEP_SDE_EPOCHS} epoch, fixed grid of {steps} steps); "
          f"run_inference {len(pred['time'])} predictions in {t_inf:.3f} s; "
          f"evaluate {t_eval:.3f} s: snap accuracy "
          f"{ms_metrics['snap_accuracy']:.3f}, velocity AUC "
          f"{ms_metrics['velocity_stay_travel_auc']:.3f} [card {card}]",
          flush=True)
    print("trajectory ODEs on the card: latent_ode iteration "
          f"{lode_iter:.3f} s, step busy " + (
              "not measured" if lode_busy is None else
              f"{lode_busy[0] / lode_busy[1]:.1%} of {lode_busy[1]:.1f} ms, "
              f"{lode_busy[2]} device operations")
          + f"; mode_sep epoch {ms_walls['rk4']:.3f} s (SDE "
          f"{ms_walls['sde']:.3f} s); phases 57-60 "
          + ", ".join(f"{walls[k]:.1f}" for k in (57, 58, 59, 60))
          + f" s [card {card}]", flush=True)


# ---- the parallel layer under a mesh (phases 61-63) ------------------------

# phase 61: the plain sharded step and rollout at a cut of rung 2's agents;
# its one DOPRI5 step at these tolerances (the rollout's rk4 at the config's)
SHARDED_N = 8_192
MESH_DOPRI5_TOL = (1e-3, 1e-4)
# the plain step at world 1: only the cross-entropy's form moves (a
# logsumexp from the zone group's maximum in place of log_softmax)
MESH_LOSS_RTOL = 1e-5
MESH_COS_MIN = 0.99999
# phase 62: two ranks on the card, gloo reducing CUDA tensors, against the
# one-process step on the same rows (PERF.md section 2's fixed-step bound)
RANKS62 = 2
P62_LOSS_RTOL = 1e-5
P62_COS_MIN = 0.99999
P62_TIMEOUT = 600
# phase 63: the entry points at world 1 against their single-device calls
MESH_ENTRY_RTOL = 1e-4
# --parallel runs phase 63 on inputs of its own at this many persons
PARALLEL_PERSONS = 4_096


@contextlib.contextmanager
def nccl_mesh(dev, tag):
    """A one-rank NCCL process group on the card (a ``file://`` rendezvous
    under OUT) and its (1, 1) mesh; the group ends on exit."""
    from ananke_abm_tpu_torch.parallel import make_mesh, maybe_initialize

    OUT.mkdir(parents=True, exist_ok=True)
    rdv = OUT / f"rendezvous_{tag}"
    rdv.unlink(missing_ok=True)
    maybe_initialize(f"file://{rdv}", 1, 0, backend="nccl", device=dev,
                     timeout_s=300)
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def event_wall(fn):
    """``fn()``'s wall in seconds between CUDA events, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, out


def flat_of(tensors):
    return torch.cat([t.detach().reshape(-1).double() for t in tensors])


def mesh_phases(dev, card, rung1=None):
    """Phase 61: the GAT-ODE under a one-rank NCCL mesh. ``rung1``: phase
    4's (model, graph, agents) at rung 1, else built here."""
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        make_decoded_rollout,
        make_pallas_rollout,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        make_adjoint_step_fns,
        make_fused_train_step,
        make_step_fns,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_step as fs
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.parallel import (
        make_sharded_fused_train_step,
        make_sharded_rollout,
        make_sharded_train_step,
    )

    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               fg.gat_forward_fused, fg.gat_backward_fused)
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)
    t_phase = time.perf_counter()
    with nccl_mesh(dev, "61") as mesh:
        # ---- 61a. the fused step at rung 2: the single-device bits --------
        steps = {}
        for tag in ("single", "mesh"):
            model, opt, static, batch = rung2_trainer(dev, config)
            step = (make_fused_train_step(model, opt, config, static)[0]
                    if tag == "single" else make_sharded_fused_train_step(
                        model, opt, config, mesh, static))
            steps[tag] = (model, step, batch)
        walls = {"single": [], "mesh": []}
        results = {}
        for tag in ("single", "mesh", "mesh", "single"):
            model, step, batch = steps[tag]
            before = [k.launches for k in kernels]
            wall, (loss, acc) = event_wall(lambda: step(*batch))
            launched = [k.launches - b for k, b in zip(kernels, before)]
            if launched != [1] * 6:
                fail(f"phase 61 {tag} fused step launched K2f/K2b/K3f/K3b/"
                     f"K4f/K4b {launched} times, expected once each")
            walls[tag].append(wall)
            results.setdefault(tag, []).append(
                (loss.reshape(()).float(), acc.reshape(()).float(),
                 flat_of(model.parameters())))
        same = all(torch.equal(a, b) for ra, rb in zip(results["single"],
                                                      results["mesh"])
                   for a, b in zip(ra, rb))
        print(f"phase 61 fused step at rung 2 ({TRAIN_N} x {TRAIN_ZONES} x "
              f"{TRAIN_TIMES}) under a one-rank NCCL mesh: loss, accuracy "
              f"and parameters after each of 2 steps the single device's "
              f"bits: {same}; K2f/K2b/K3f/K3b/K4f/K4b once each a step; "
              f"walls (CUDA events) single "
              + ", ".join(f"{w:.4f}" for w in walls["single"]) + " s, mesh "
              + ", ".join(f"{w:.4f}" for w in walls["mesh"])
              + f" s [card {card}]", flush=True)
        if not same:
            fail("the sharded fused step at world 1 differs from the single "
                 "device's")

        # ---- 61b. the kernel rollouts at rung 1 ---------------------------
        if rung1 is None:
            rung1 = rung1_setup(dev)
        model, graph, agents = rung1
        serve_cfg = GATODEConfig()
        k1, k0 = fs.rk4_interval_decode_fused, fs.rk4_step_fused
        routes = {
            "interval": lambda m: make_pallas_rollout(
                model, *graph, substeps=serve_cfg.substeps, mesh=m,
                fuse_decode=True),
            "decoded": lambda m: make_decoded_rollout(model, serve_cfg,
                                                      *graph, mesh=m),
            "step": lambda m: make_pallas_rollout(
                model, *graph, substeps=serve_cfg.substeps, mesh=m),
        }
        ids, r_walls, launches = {}, {}, {}
        for name, make in routes.items():
            order = (("single", "mesh", "mesh", "single")
                     if name == "interval" else ("single", "mesh"))
            for tag in order:
                rollout = make(None if tag == "single" else mesh)
                before = (k1.launches, k0.launches)
                wall, out = event_wall(lambda: rollout(*agents))
                launches[name, tag] = (k1.launches - before[0],
                                       k0.launches - before[1])
                r_walls.setdefault((name, tag), []).append(wall)
                ids[name, tag] = out
        want = {"interval": (NUM_TIMES - 1, 0), "decoded": (NUM_TIMES - 1, 0),
                "step": (0, (NUM_TIMES - 1) * serve_cfg.substeps)}
        for name in routes:
            if launches[name, "mesh"] != want[name]:
                fail(f"phase 61 {name} rollout under the mesh launched "
                     f"(K1, K0) {launches[name, 'mesh']}, expected "
                     f"{want[name]}")
            if not torch.equal(ids[name, "mesh"], ids[name, "single"]):
                fail(f"phase 61 {name} rollout under the mesh: ids differ "
                     f"from the single device's")
        n = agents[0].shape[0]
        print(f"phase 61 rollouts at rung 1 ({n} x {NUM_TIMES}, "
              f"{graph[0].shape[0]} zones) under the mesh: the single "
              f"device's ids on every route; launches (K1, K0) "
              + ", ".join(f"{k} {launches[k, 'mesh']}" for k in routes)
              + "; walls (CUDA events) " + ", ".join(
                  f"{k} {t} " + "/".join(f"{w:.4f}" for w in r_walls[k, t])
                  for k in routes for t in ("single", "mesh"))
              + f" s [card {card}]", flush=True)

        # ---- 61c. the plain sharded step and rollout at SHARDED_N ---------
        checks = []
        for method in ("rk4", "dopri5"):
            cfg = (config if method == "rk4" else dataclasses.replace(
                config, method="dopri5", rtol=MESH_DOPRI5_TOL[0],
                atol=MESH_DOPRI5_TOL[1]))
            out = {}
            for tag in ("single", "mesh"):
                model, opt, static, batch = rung2_trainer(dev, cfg)
                batch = tuple(b[:SHARDED_N] for b in batch)
                if tag == "mesh":
                    step = make_sharded_train_step(model, opt, cfg, mesh,
                                                   static)
                elif method == "rk4":
                    step, _ = make_step_fns(model, opt, cfg, static)
                else:
                    step, _ = make_adjoint_step_fns(
                        model, opt, cfg, static, use_fused=False,
                        adjoint_mode="discrete")
                wall, (loss, acc) = event_wall(lambda: step(*batch))
                fwd = getattr(step, "stats", {}).get("forward", {})
                out[tag] = (loss.item(), acc.item(),
                            flat_of(p.grad for p in model.parameters()),
                            (fwd.get("n_steps"), fwd.get("n_accepted")),
                            wall)
            (ls, as_, gs, ss, ws), (lm, am, gm, sm, wm) = (out["single"],
                                                            out["mesh"])
            rel, cos = abs(lm - ls) / abs(ls), cosine(gm, gs)
            checks.append(rel <= MESH_LOSS_RTOL and cos > MESH_COS_MIN
                          and abs(am - as_) <= 1.0 / (SHARDED_N * TRAIN_TIMES)
                          and ss == sm)
            print(f"phase 61 plain sharded step ({method}, {SHARDED_N} "
                  f"agents): loss {lm:.7f} against {ls:.7f} (rel {rel:.3e} "
                  f"<= {MESH_LOSS_RTOL}), accuracy {am:.6f} against "
                  f"{as_:.6f}, gradient cosine {cos:.9f} (> {MESH_COS_MIN})"
                  + (f", steps (attempted, accepted) {sm} against {ss}"
                     if method == "dopri5" else "")
                  + f"; walls {ws:.4f} s single, {wm:.4f} s mesh (CUDA "
                  f"events) [card {card}]", flush=True)
        model, _, static, batch = rung2_trainer(dev, config)
        pf, hz = batch[0][:SHARDED_N], batch[1][:SHARDED_N]
        got = make_sharded_rollout(model, config, mesh, static)(pf, hz)
        with torch.inference_mode():
            logits, _ = model(*static[:2], pf, hz, static[2],
                              ode_method=config.method,
                              substeps=config.substeps)
        agree = (got == torch.argmax(logits, -1).to(torch.int32)
                 ).float().mean().item()
        print(f"phase 61 make_sharded_rollout ({SHARDED_N} agents, rk4): "
              f"ids agree with GATODE.forward's argmax {agree:.6f} (>= "
              f"{IDS_MIN})", flush=True)
        if not all(checks) or agree < IDS_MIN:
            fail("phase 61: the plain sharded step or rollout at world 1 "
                 "is out of its bounds")
    print(f"phase 61 in {time.perf_counter() - t_phase:.1f} s", flush=True)


def rung1_setup(dev):
    """(model, graph, agents) of phase 4's rollout at rung 1, for
    ``--parallel`` and ``--host-tools``."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        build_model,
        init_params,
    )

    data = generate_agent_population(N_AGENTS, num_times=NUM_TIMES,
                                     seed=AGENT_SEED, num_zones=NUM_ZONES,
                                     world_seed=WORLD_SEED)
    model = build_model(GATODEConfig(), data["zone_features"].shape[-1],
                        data["person_feats"].shape[-1], device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)
    return (model, (on(data["zone_features"]), on(data["adj"]),
                    on(data["times"])),
            (on(data["person_feats"]), on(data["home_zone"], torch.long)))


def parallel_rank(rank, d):
    """One of phase 62's ranks (``--parallel-rank RANK DIR``): the card
    shared, gloo reducing its CUDA tensors; the sharded fused step at rung
    2 and its control (this rank's gradient left out of the reduction on
    rank 1), written to DIR/rank{RANK}.pt."""
    import torch.distributed as dist

    from ananke_abm_tpu_torch.models.gnn_embed.train import GATODEConfig
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.parallel import (
        make_mesh,
        make_sharded_fused_train_step,
        maybe_initialize,
    )
    from ananke_abm_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    maybe_initialize(f"file://{d / 'rendezvous'}", RANKS62, rank,
                     backend="gloo", device=dev, timeout_s=300)
    probe = torch.full((1,), float(rank + 1), device=dev)
    try:
        dist.all_reduce(probe)
    except RuntimeError as e:
        torch.save({"gloo_cuda": str(e)}, d / f"rank{rank}.pt")
        dist.destroy_process_group()
        return
    out = {"gloo_cuda": probe.item()}
    mesh = make_mesh()
    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               fg.gat_forward_fused, fg.gat_backward_fused)
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)
    reduce = sharded.all_reduce_grads

    def control(params, group):
        if dist.get_rank() == 1:
            for p in params:
                p.grad = torch.zeros_like(p)
        reduce(params, group)

    for tag in ("step", "control"):
        model, opt, static, batch = rung2_trainer(dev, config)
        step = make_sharded_fused_train_step(model, opt, config, mesh,
                                             static)
        sharded.all_reduce_grads = control if tag == "control" else reduce
        before = [k.launches for k in kernels]
        try:
            loss, acc = step(*batch)
        finally:
            sharded.all_reduce_grads = reduce
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        print(f"rank {rank} {tag}: K2f/K2b/K3f/K3b/K4f/K4b launched "
              f"{launched}", flush=True)
        out[tag] = {"loss": loss.item(), "acc": acc.item(),
                    "launches": launched,
                    "grads": [p.grad.detach().double().cpu()
                              for p in model.parameters()]}
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


def two_rank_phase(dev, card):
    """Phase 62: the data-parallel fused step of two processes that share
    the card, gloo reducing the CUDA tensors, against this process's step
    on the same 32,768 rows; and the control that must fail."""
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        make_fused_train_step,
    )

    t_phase = time.perf_counter()
    d = OUT / "phase62"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    logs = [open(d / f"rank{r}.log", "w") for r in range(RANKS62)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
         str(r), str(d)], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=str(ROOT)) for r in range(RANKS62)]
    try:
        deadline = time.monotonic() + P62_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r in range(RANKS62):
        print((d / f"rank{r}.log").read_text().rstrip(), flush=True)
    if rcs is None or any(rcs):
        fail(f"phase 62's ranks exited {rcs}")
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(RANKS62)]
    if any(isinstance(r["gloo_cuda"], str) for r in ranks):
        print(f"phase 62 left out: gloo refused CUDA tensors for all_reduce "
              f"on torch {torch.__version__}: {ranks[0]['gloo_cuda']} "
              f"[card {card}]", flush=True)
        return
    if [r["gloo_cuda"] for r in ranks] != [3.0] * RANKS62:
        fail(f"phase 62 probe: gloo's all_reduce gave "
             f"{[r['gloo_cuda'] for r in ranks]}, expected 3.0")
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)
    model, opt, static, batch = rung2_trainer(dev, config)
    loss, acc = make_fused_train_step(model, opt, config, static)[0](*batch)
    want = (loss.item(), acc.item(),
            [p.grad.detach().double().cpu() for p in model.parameters()])

    def judge(res):
        rel = abs(res["loss"] - want[0]) / abs(want[0])
        cos = min(cosine(g, w) for g, w in zip(res["grads"], want[2]))
        ok = (rel <= P62_LOSS_RTOL and cos > P62_COS_MIN
              and res["acc"] == want[1] and res["launches"] == [1] * 6)
        return ok, (f"loss rel {rel:.3e} (<= {P62_LOSS_RTOL}), accuracy "
                    f"{res['acc']:.6f} against {want[1]:.6f}, the least "
                    f"parameter gradient cosine {cos:.9f} (> {P62_COS_MIN})")

    for r, res in enumerate(ranks):
        ok, text = judge(res["step"])
        print(f"phase 62 rank {r} of {RANKS62} (gloo, CUDA tensors, one "
              f"card): {text}", flush=True)
        if not ok:
            fail(f"phase 62 rank {r}'s step is out of its bounds")
        ok, text = judge(res["control"])
        print(f"phase 62 control (rank 1's gradient left out) on rank {r}: "
              f"{text}", flush=True)
        if ok:
            fail("phase 62's control passes the bounds")
    print(f"phase 62 in {time.perf_counter() - t_phase:.1f} s (two "
          f"processes and this one's step) [card {card}]", flush=True)


def mesh_entry_inputs(dev, root):
    """Phase 63's inputs when it runs alone (``--parallel``):
    PARALLEL_PERSONS persons through phase 39's data, phase 41's trainer
    (one epoch) and phase 43's CRF data, and phase 53's cut CSV."""
    from ananke_abm_tpu_torch.data_generator.population import (
        COLUMNS,
        generate_population_activities,
        write_csv,
    )
    from ananke_abm_tpu_torch.dataio.rasterize import prepare_from_csv
    from ananke_abm_tpu_torch.models.gen_schedule.crf.prepare import (
        prepare_crf_data,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.train import train

    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    acts = generate_population_activities(PARALLEL_PERSONS, seed=SCHED_SEED)
    csv_path = write_csv(str(root / "activities.csv"),
                         {k: acts[k] for k in COLUMNS})
    grid = str(root / "grid.npz")
    prepare_from_csv(csv_path, grid, grid_min=SCHED_GRID_MIN)
    p1 = schedule_config("phase1", data__npz=grid, train__epochs=1)
    train(p1, str(root / "vae"), seed=SCHED_SEED, device=dev)
    ckpt = str(root / "vae" / "checkpoints" / "best_val.ckpt")
    crf_dir = root / "crf_data"
    prepare_crf_data(ckpt, grid.replace(".npz", "_splits.npz"),
                     str(crf_dir), device=dev)
    cut_csv = write_csv(str(root / "activities_cut.csv"),
                        {k: v for k, v in cut_activities(
                            acts, TRAJ_TRAIN_ROWS).items() if k in COLUMNS})
    return {"root": root, "grid": grid, "ckpt": ckpt, "crf_dir": crf_dir,
            "cut_csv": cut_csv, "catalog_csv": None}


def mesh_entry_phase(dev, card, files):
    """Phase 63: the schedule trainer, sampler and CRF trainer,
    ``train_traj_embed`` and ``BatchedInferenceEngine`` with ``mesh=`` under
    a one-rank NCCL mesh, against their single-device calls."""
    import dataclasses as dc

    from ananke_abm_tpu_torch.models.gen_schedule.crf.train import train_crf
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.sample import (
        sample,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline.train import train
    from ananke_abm_tpu_torch.models.latent_ode.config import (
        GenerativeODEConfig,
    )
    from ananke_abm_tpu_torch.models.latent_ode.inference import (
        BatchedInferenceEngine,
    )
    from ananke_abm_tpu_torch.models.latent_ode.model import (
        init_params as lode_init,
    )
    from ananke_abm_tpu_torch.models.latent_ode.model import to_flax_params
    from ananke_abm_tpu_torch.models.latent_ode.train import (
        build_model_and_batch,
    )
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
        train_traj_embed,
    )
    from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint

    t_phase = time.perf_counter()
    root = Path(files["root"]) / "mesh"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    p1 = schedule_config("phase1", data__npz=files["grid"], train__epochs=1)
    crf_cfg = schedule_config(
        "crf_config", crf__train_npz=str(files["crf_dir"] / "crf_train.npz"),
        crf__val_npz=str(files["crf_dir"] / "crf_val.npz"),
        crf__meta_json=str(files["crf_dir"] / "crf_meta.json"),
        crf__num_epochs=1)
    cut = str(files["crf_dir"] / "crf_train_phase63.npz")
    with np.load(files["crf_dir"] / "crf_train.npz") as z:
        np.savez(cut, U=z["U"][:CRF_TRAIN_ROWS], Y=z["Y"][:CRF_TRAIN_ROWS])
    crf_cfg["crf"]["train_npz"] = cut
    lode_cfg = GenerativeODEConfig()
    lode_model, _, _ = build_model_and_batch(lode_cfg, device=dev)
    lode_init(lode_model, torch.Generator().manual_seed(SCHED_SEED))
    lode_ckpt = str(root / "latent_ode.ckpt")
    save_checkpoint({"params": to_flax_params(lode_model),
                     "config": dc.asdict(lode_cfg)}, lode_ckpt)

    def run(mesh, tag):
        out, walls = {}, {}
        t0 = time.perf_counter()
        train(p1, str(root / f"vae_{tag}"), seed=SCHED_SEED, mesh=mesh,
              device=dev)
        out["train"] = np.array([list(r.values()) for r in read_log(
            str(root / f"vae_{tag}" / "training_log.csv"))], np.float64)
        walls["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sample(files["ckpt"], CRF_SAMPLES, str(root / f"s_{tag}"),
               seed=SCHED_SEED, reject_all_home=True, mesh=mesh, device=dev)
        with np.load(root / f"s_{tag}.npz") as z:
            out["sample"] = (z["Y_generated"], z["U_mean_logits"])
        walls["sample"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crf_cfg["crf"]["save_path"] = str(root / f"crf_{tag}.ckpt")
        out["crf"] = train_crf(crf_cfg, seed=SCHED_SEED, mesh=mesh,
                               device=dev)["best_val_nll"]
        walls["train_crf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["traj"] = train_traj_embed(
            files["cut_csv"], files["catalog_csv"], epochs=1,
            outdir=str(root / f"traj_{tag}"), crf_mode="linear",
            seed=SCHED_SEED, mesh=mesh, device=dev)["best_val_loss"]
        walls["train_traj_embed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = BatchedInferenceEngine(lode_ckpt, mesh=mesh, device=dev
                                      ).predict_trajectories(num_samples=1)
        out["engine"] = [pred[k] for k in ("zones", "purposes", "modes")]
        walls["engine"] = time.perf_counter() - t0
        return out, walls

    single, s_walls = run(None, "single")
    with nccl_mesh(dev, "63") as mesh:
        sharded, m_walls = run(mesh, "mesh")
    # the train_* columns: epoch, beta and the eight train components
    log_rel = np.max(np.abs(sharded["train"][:, :10] - single["train"][:, :10])
                     / np.maximum(np.abs(single["train"][:, :10]), 1e-12))
    checks = {
        "trainer log (train columns)": log_rel <= MESH_ENTRY_RTOL,
        "sampler ids": np.array_equal(sharded["sample"][0],
                                      single["sample"][0]),
        "sampler logits' mean": np.allclose(sharded["sample"][1],
                                            single["sample"][1], rtol=1e-5,
                                            atol=1e-6),
        "train_crf": abs(sharded["crf"] - single["crf"]) <= MESH_ENTRY_RTOL
        * abs(single["crf"]),
        "train_traj_embed": abs(sharded["traj"] - single["traj"])
        <= MESH_ENTRY_RTOL * abs(single["traj"]),
        "engine ids": all(np.array_equal(a, b) for a, b in
                          zip(sharded["engine"], single["engine"])),
    }
    print(f"phase 63 entry points with mesh= under a one-rank NCCL mesh "
          f"against their single-device calls: "
          + ", ".join(f"{k} {'ok' if v else 'OUT'}" for k, v in checks.items())
          + f" (trainer log rel {log_rel:.3e}, train_crf "
          f"{sharded['crf']:.6f}/{single['crf']:.6f}, traj "
          f"{sharded['traj']:.6f}/{single['traj']:.6f}); walls single/mesh "
          + ", ".join(f"{k} {s_walls[k]:.2f}/{m_walls[k]:.2f}"
                      for k in s_walls)
          + f" s (host clock); {time.perf_counter() - t_phase:.1f} s "
          f"[card {card}]", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"phase 63: {bad} differ from the single-device calls")



# ---- the host tools and the profiling layer (phases 64-66) -----------------

# phase 64: a seeded raw VISTA stops table in VISTA's raw columns, sized so
# that at least VISTA_KEPT_MIN persons survive cleaning (the real survey's
# population, SURVEY.md), with persons of every kind that one of the 14
# cleaning rules drops or changes
VISTA_RAW_PERSONS = 64_000
VISTA_SEED = 0
VISTA_KEPT_MIN = 42_817
VISTA_FRACS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
# sha256 of the activities CSV that the JAX package's pandas cleaning
# writes from vista_raw_tables(VISTA_RAW_PERSONS, VISTA_SEED)
# (tests/test_torch_host_tools.py derives it)
VISTA_CLEAN_SHA256 = (
    "86347cfe9a99b72cdc58144025e04555d542a55d831fa34cc5bc054d2d2264a4")
VISTA_STOP_COLS = ("persid", "hhid", "stopno", "origplace1", "destplace1",
                   "destpurp1", "startime", "arrtime", "duration",
                   "travtime", "wdstopwgt_sa3")
VISTA_PERSON_COLS = ("persid", "hhid", "age", "sex", "persinc", "nolicence",
                     "fulltimework", "parttimework", "casualwork", "anywork",
                     "studying", "worktype", "homesa1")
VISTA_PLACES = ("Workplace", "Shops", "School", "Someplace", "Station")
VISTA_PURPOSES = ("Work Related", "Education", "Buy Something",
                  "Personal Business", "Pick-up or Deliver Something",
                  "Social", "Recreational", "Pick-up or Drop-off Someone",
                  "Accompany Someone", "Other Purpose", "Not Stated",
                  "Unknown Purpose", "At or Go Home")
# (kind, share, the cleaning rules that act on it): the kept persons, then
# one kind for each way a person drops out
VISTA_KINDS = (
    ("kept", 0.72, ()),
    ("unweighted", 0.02, (1,)),          # every stop without a weight
    ("row_unweighted", 0.02, (1, 5)),    # the last stop without one,
                                         # the one before it not Home
    ("from_stop2", 0.02, (2,)),          # no stopno 1
    ("away_start", 0.02, (3,)),          # the first origin not home
    ("away_end", 0.02, (3,)),            # the last destination not home
    ("ends_away", 0.02, (5,)),           # the last stop not Home
    ("one_stop", 0.02, (5,)),            # a single stop
    ("negative", 0.02, (6, 9)),          # a negative duration
    ("no_arrival", 0.02, (6, 9)),        # arrtime and duration missing
    ("no_travel", 0.02, (7, 9)),         # travtime missing
    ("gap", 0.02, (9,)),                 # the day does not tile 1440
    ("home_all_day", 0.02, (13,)),       # one 1440-minute Home row
    ("ends_zero", 0.02, (13, 14)),       # the 1440-minute Home row goes
    ("away_all_day", 0.02, (13, 14)),    # the 1440-minute Work row goes
)
# (trait, share, the cleaning rule that folds or changes it, None for a
# trap that no rule drops): the kept persons' traits, a Change Mode stop,
# two stops of one purpose, a purpose outside the groups or missing, the
# first origin missing (first skips it), a day starting at 0, a gap in
# stopno, hhid missing on the first stop, and (where asked) the last
# stop's startime missing
VISTA_TRAITS = (("transit", 0.15, 11), ("twice", 0.10, 12),
                ("unknown", 0.03, 4), ("orig_missing", 0.02, 3),
                ("start_zero", 0.02, 8), ("stopno_gap", 0.05, 10),
                ("hhid_missing", 0.02, None),
                ("startime_missing", 0.02, None))


def vista_raw_tables(n_persons, seed, startime_missing=False):
    """(stops, persons, labels): a raw VISTA stops table and its persons
    table as {column: list} (None where missing), rows shuffled, made from
    ``seed``. Persons are kinds of VISTA_KINDS; the kept ones carry
    VISTA_TRAITS (a missing last startime only with ``startime_missing``,
    which leaves float startimes in the cleaned table). persids are
    unpadded (``Y12P1`` sorts before ``Y2P1``). ``labels``: each person's
    ``persid``, ``kind`` and ``traits`` (a bool row over VISTA_TRAITS, set
    where the trait was applied), for :func:`vista_rule_report`."""
    rng = np.random.default_rng(seed)
    names, shares, _ = zip(*VISTA_KINDS)
    kinds = rng.choice(len(names), n_persons,
                       p=np.array(shares) / sum(shares))
    n_stops = rng.integers(2, 7, n_persons)
    traits = rng.random((n_persons, len(VISTA_TRAITS))) < np.array(
        [p for _, p, _ in VISTA_TRAITS])
    applied = np.zeros_like(traits)
    draws = rng.integers(0, 1 << 30, (n_persons, 8, 4))
    weights = np.round(rng.uniform(10.0, 400.0, (n_persons, 8)), 2)
    stops = {c: [] for c in VISTA_STOP_COLS}
    persons = {c: [] for c in VISTA_PERSON_COLS}
    for i in range(n_persons):
        kind = names[kinds[i]]
        trait = dict(zip((t for t, _, _ in VISTA_TRAITS), traits[i]
                         if kind == "kept" else [False] * len(VISTA_TRAITS)))
        used = {"hhid_missing", "orig_missing", "start_zero"}
        pid, hh = f"Y{i // 3}P{i % 3 + 1}", f"Y{i // 3}"
        d = draws[i]
        rows = []  # (purpose, orig, dest, start, arr, duration, travel)
        if kind in ("home_all_day", "ends_zero", "away_all_day"):
            first = {"home_all_day": "At or Go Home", "ends_zero": "Social",
                     "away_all_day": "Work Related"}[kind]
            end = 1440 if kind == "away_all_day" else 0
            rows = [(first, "Accommodation", "Someplace", 0, 0, end, 0),
                    ("At or Go Home", "Someplace", "Accommodation", end, end,
                     None, 0)]
        else:
            k = 1 if kind == "one_stop" else max(int(n_stops[i]), 3) \
                if kind in ("negative", "no_arrival", "no_travel", "gap") \
                else int(n_stops[i])
            s = 0 if trait["start_zero"] else 300 + int(d[0, 3]) % 241
            orig = "Accommodation"
            for j in range(k):
                trav = 5 + int(d[j, 0]) % 36
                last = j == k - 1
                purp = "At or Go Home" if last else VISTA_PURPOSES[
                    int(d[j, 2]) % len(VISTA_PURPOSES)]
                dest = "Accommodation" if last or purp == "At or Go Home" \
                    else VISTA_PLACES[int(d[j, 3]) % len(VISTA_PLACES)]
                dur = None if last else 20 + int(d[j, 1]) % 101
                rows.append([purp, orig, dest, s, s + trav, dur, trav])
                if not last:
                    s += trav + dur
                orig = dest
            mid = 1 + int(d[7, 0]) % (k - 2) if k > 2 else 0
            if trait["transit"] and k > 2:
                rows[mid][0] = "Change Mode"
                used.add("transit")
            if trait["twice"] and k > 3:
                rows[mid + 1][0] = rows[mid][0] = "Work Related"
                used.add("twice")
            if trait["unknown"] and k > 2:
                rows[mid][0] = None if d[7, 1] % 2 else "Mystery Purpose"
                used.add("unknown")
            if trait["startime_missing"] and startime_missing:
                rows[-1][3] = None
                used.add("startime_missing")
            if len(rows) > 2:
                used.add("stopno_gap")
            if kind == "row_unweighted":  # home-bound and not Home
                rows[-2][0], rows[-2][2] = "Social", "Accommodation"
            if kind == "ends_away":
                rows[-1][0] = "Social"
            if kind == "away_end":
                rows[-1][2] = "Shops"
            if kind == "away_start":
                rows[0][1] = "Workplace"
            if kind == "negative":
                rows[mid][5] = -5
            if kind == "no_arrival":
                rows[mid][4] = rows[mid][5] = None
            if kind == "no_travel":
                rows[mid][6] = None
            if kind == "gap":
                rows[mid][5] += 10
        first_no = 2 if kind == "from_stop2" else 1
        for j, (purp, orig, dest, start, arr, dur, trav) in enumerate(rows):
            no = first_no + j + (j >= 2 and trait["stopno_gap"])
            weighted = not (kind == "unweighted" or kind == "row_unweighted"
                            and j == len(rows) - 1)
            values = (pid, None if trait["hhid_missing"] and j == 0 else hh,
                      no, None if trait["orig_missing"] and j == 0 else orig,
                      dest, purp, start, arr, dur, trav,
                      float(weights[i, j]) if weighted else None)
            if trait["orig_missing"] and j == 1:
                values = values[:3] + ("Accommodation",) + values[4:]
            for c, v in zip(VISTA_STOP_COLS, values):
                stops[c].append(v)
        applied[i] = [trait[t] and t in used for t, _, _ in VISTA_TRAITS]
        work = ("Yes", "No")[int(d[6, 0]) % 2]
        for c, v in zip(VISTA_PERSON_COLS, (
                pid, hh, int(d[6, 1]) % 91, ("M", "F")[int(d[6, 2]) % 2],
                None if d[6, 3] % 10 == 0 else float(d[6, 3] % 3000) + 0.5,
                ("Yes", "No")[int(d[5, 0]) % 2], work, "No", "No", work,
                ("No Study", "Full-time", "Part-time")[int(d[5, 1]) % 3],
                None if work == "No" else ("Public", "Private")[
                    int(d[5, 2]) % 2], f"SA{int(d[5, 3]) % 500}")):
            persons[c].append(v)
    order = rng.permutation(len(stops["persid"]))
    stops = {c: [v[r] for r in order] for c, v in stops.items()}
    labels = {"persid": np.array(persons["persid"]),
              "kind": np.array(names)[kinds], "traits": applied}
    return stops, persons, labels


def vista_rule_report(labels, kept):
    """How the persons of :func:`vista_raw_tables` fared in the cleaning
    that kept the persids ``kept``, rule by rule: (rows, faults). A row
    ``(rule, what, made, left)`` counts the persons of a kind that the rule
    drops (none may be left) or of a trait that it folds or changes (some
    must be left, so the rule acted on persons that stay). A fault is a
    kind with persons left, a trait with none, or one of the 14 rules that
    no kind or trait reaches."""
    left = np.isin(labels["persid"], np.array(sorted(set(kept)), dtype=str))
    rows, faults = [], []
    for name, _, rules in VISTA_KINDS:
        of = labels["kind"] == name
        made, stay = int(of.sum()), int((of & left).sum())
        rows += [(r, f"drops kind {name}", made, stay) for r in rules]
        if rules and (made == 0 or stay):
            faults.append(f"kind {name}: {stay} of {made} persons left")
    for j, (name, _, rule) in enumerate(VISTA_TRAITS):
        of = labels["traits"][:, j]
        made, stay = int(of.sum()), int((of & left).sum())
        if rule is not None:
            rows.append((rule, f"folds or changes trait {name}", made, stay))
            if stay == 0:
                faults.append(f"trait {name}: none of {made} persons left")
    reached = {r for r, *_ in rows}
    if reached != set(range(1, 15)):
        faults.append(f"rules {sorted(set(range(1, 15)) - reached)} reach "
                      "no person")
    return sorted(rows), faults


def write_raw_csv(table, path):
    """{column: list} with the ``csv`` module: None as an empty cell,
    floats by their repr."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        w.writerows(zip(*([("" if v is None else repr(v)
                            if isinstance(v, float) else str(v)) for v in col]
                          for col in table.values())))



# phase 65: the mock-data tools' outputs, digested (mock_data_digest); a CPU
# test (tests/test_torch_host_tools.py) takes both from the JAX package
MOCK_DATA_SHA256 = (
    "3852d583a2203a7e20139f9c340847150c03cf32f25ebcf25d030b1d5ed1e686")
TRANSITIONS_SHA256 = (
    "ba2d44336614f27b76fa03b59c182b4cc2b3d550e601f988804ed038280bd94e")


def mock_data_digest(data):
    """sha256 of ``load_mock_data``'s output in either package's form:
    the people and zones tables column by column as Python values (a
    pandas frame or {column: array}), every array's dtype, shape and
    bytes, the zone names and the trajectories in their order."""
    h = hashlib.sha256()

    def array(a):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode() + a.tobytes())

    for key, value in data.items():
        h.update(key.encode())
        if key in ("people", "zones"):
            for c in value:
                h.update(repr((c, value[c].tolist())).encode())
        elif key == "trajectories":
            for pid, tl in value.items():
                h.update(repr(pid).encode())
                for k, v in tl.items():
                    h.update(k.encode())
                    if isinstance(v, np.ndarray):
                        array(v)
                    else:
                        h.update(repr(v).encode())
        elif key == "zone_names":
            h.update(repr(list(value)).encode())
        else:
            array(value)
    return h.hexdigest()


def host_tool_phases(card, root, walls):
    """Phases 64-65: VISTA cleaning at the real survey's population, the
    fraction samples, their grid and their sequence coverage; the
    mock-data tools. No hand-written kernel: host work beside the build.
    Every phase raises on failure."""
    from ananke_abm_tpu_torch.data_generator.analyze_transitions import (
        analyze_transitions,
    )
    from ananke_abm_tpu_torch.data_generator.load_data import load_mock_data
    from ananke_abm_tpu_torch.dataio.rasterize import prepare_from_csv
    from ananke_abm_tpu_torch.dataio.vista import (
        clean_vista_csv,
        read_csv,
        sample_population,
        write_csv,
    )
    from ananke_abm_tpu_torch.utils.sample_coverage import (
        plot_sample_coverage,
        sample_coverage_table,
    )

    # ---- 64. VISTA at its real size ----------------------------------------
    t_phase = time.perf_counter()
    d = root / "vista"
    d.mkdir(parents=True, exist_ok=True)
    wall = {}
    t0 = time.perf_counter()
    stops, persons, labels = vista_raw_tables(VISTA_RAW_PERSONS, VISTA_SEED)
    wall["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_raw_csv(stops, str(d / "stops.csv"))
    write_raw_csv(persons, str(d / "persons.csv"))
    wall["write raw CSVs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    acts = clean_vista_csv(str(d / "stops.csv"), str(d / "activities.csv"),
                           str(d / "persons.csv"),
                           str(d / "persons_clean.csv"))
    wall["clean_vista_csv"] = time.perf_counter() - t0
    digest = hashlib.sha256((d / "activities.csv").read_bytes()).hexdigest()
    kept = len(set(acts["persid"].tolist()))
    rows = len(stops["persid"])
    print(f"phase 64 VISTA: {VISTA_RAW_PERSONS} raw persons, {rows} stops "
          f"-> {kept} persons, {len(acts['persid'])} activities kept (>= "
          f"{VISTA_KEPT_MIN}); cleaned CSV sha256 {digest[:16]}... "
          f"({'equal to' if digest == VISTA_CLEAN_SHA256 else 'NOT'} the "
          f"JAX package's)", flush=True)
    report, faults = vista_rule_report(labels, acts["persid"].tolist())
    for rule, what, made, left in report:
        print(f"  rule {rule:2d} {what}: {made} persons made, {left} left",
              flush=True)
    if digest != VISTA_CLEAN_SHA256 or kept < VISTA_KEPT_MIN:
        fail("phase 64: the cleaned VISTA CSV differs from the JAX "
             "package's, or too few persons were kept")
    if faults:
        fail(f"phase 64: a cleaning rule acted on no person: {faults}")
    t0 = time.perf_counter()
    people = read_csv(str(d / "persons_clean.csv"))
    if len(people["persid"]) != kept:
        fail(f"phase 64: {len(people['persid'])} persons in the persons "
             f"subset for {kept} kept")
    samples = []
    for frac in VISTA_FRACS:
        sp, sa = sample_population(people, acts, frac)
        if len(sp["persid"]) != round(frac * kept) or \
                set(sa["persid"].tolist()) != set(sp["persid"].tolist()):
            fail(f"phase 64: the sample at {frac} holds other persons")
        path = d / f"activities_{frac}.csv"
        write_csv(sa, str(path))
        samples.append((frac, str(path)))
    wall["sample_population x9"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, meta = prepare_from_csv(str(d / "activities.csv"),
                               str(d / "grid.npz"), grid_min=SCHED_GRID_MIN)
    wall["prepare_from_csv"] = time.perf_counter() - t0
    if (meta["N"], meta["L"]) != (kept, 1440 // SCHED_GRID_MIN):
        fail(f"phase 64: grid N={meta['N']} L={meta['L']}")
    t0 = time.perf_counter()
    table = sample_coverage_table(str(d / "activities.csv"), samples,
                                  out_csv=str(d / "coverage.csv"))
    wall["sample_coverage_table"] = time.perf_counter() - t0
    cov = table["sampled_sequence_coverage"]
    if len(cov) != len(VISTA_FRACS) + 2 or not np.all(np.diff(cov) >= 0) \
            or not np.all(np.diff(table["sampled_unique_sequences"]) >= 0):
        fail(f"phase 64: coverage not rising with the sample rate: {table}")
    walls[64] = time.perf_counter() - t_phase
    print("phase 64 coverage (rate: unique sequences, person-days): "
          + ", ".join(f"{r:.1f}: {u:.4f}, {c:.4f}" for r, u, c in zip(
              *table.values())), flush=True)
    print("phase 64 walls (host clock): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in wall.items())
        + f"; {walls[64]:.1f} s in all; grid {meta['N']} x {meta['L']} "
        f"[card {card}]", flush=True)

    # ---- 65. the mock-data tools --------------------------------------------
    t_phase = time.perf_counter()
    data_digest = mock_data_digest(load_mock_data())
    with contextlib.redirect_stdout(io.StringIO()):
        result = analyze_transitions()
    trans_digest = hashlib.sha256(repr(result).encode()).hexdigest()
    print(f"phase 65 load_mock_data sha256 {data_digest[:16]}..., "
          f"analyze_transitions sha256 {trans_digest[:16]}... (their "
          f"{len(result['purpose_transitions'])} purpose and "
          f"{len(result['mode_transitions'])} mode transitions, "
          f"{len(result['forbidden'])} forbidden)", flush=True)
    if (data_digest, trans_digest) != (MOCK_DATA_SHA256, TRANSITIONS_SHA256):
        fail("phase 65: the mock-data tools differ from the JAX package's")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("phase 65 plots: not run (no matplotlib on this machine): "
              "plot_zone_graph, plot_persona_trajectories, "
              "plot_sample_coverage", flush=True)
    else:
        from ananke_abm_tpu_torch.data_generator.data_visualization import (
            plot_persona_trajectories,
            plot_zone_graph,
        )

        outs = [plot_zone_graph(str(root / "mock" / "zones.png")),
                *plot_persona_trajectories(str(root / "mock"))]
        plot_sample_coverage(table, str(d / "coverage.png"))
        outs.append(str(d / "coverage.png"))
        if not all(os.path.getsize(o) > 0 for o in outs):
            fail("phase 65: a plot was not written")
        print(f"phase 65 plots: {', '.join(Path(o).name for o in outs)}",
              flush=True)
    walls[65] = time.perf_counter() - t_phase


# phase 66: throughput against CUDA events around rung 1's rollout
THROUGHPUT_RTOL = 0.05
# the kernel libraries phase 66 launches (K0, K1, K2f; K2b, K3f, K3b; K4f,
# K4b): what --host-tools builds
HOST_TOOLS_LIBS = ("fused_step", "fused_train", "fused_gat")


def chrome_kernels(trace_dir, name):
    """(launches of kernels whose name holds ``name``, the distinct names)
    in the newest Chrome trace of ``trace_dir``."""
    newest = max(Path(trace_dir).glob("*.json"), key=os.path.getmtime)
    with open(newest) as f:
        events = json.load(f)["traceEvents"]
    hits = [e["name"] for e in events
            if e.get("cat") == "kernel" and name in e.get("name", "")]
    return len(hits), sorted(set(hits))


def profiling_phase(dev, card, rung1, k1_rate):
    """Phase 66: the profiling layer and the asynchronous checkpoint on the
    kernel paths. Raises on failure."""
    import copy

    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        make_decoded_rollout,
    )
    from ananke_abm_tpu_torch.models.gnn_embed.train import (
        GATODEConfig,
        make_fused_train_step,
    )
    from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg
    from ananke_abm_tpu_torch.ops.cuda import fused_train as ft
    from ananke_abm_tpu_torch.ops.cuda.fused_step import (
        rk4_interval_decode_fused,
        rk4_step_fused,
    )
    from ananke_abm_tpu_torch.utils.ckpt import (
        AsyncCheckpointer,
        load_checkpoint,
    )
    from ananke_abm_tpu_torch.utils.profiling import (
        JsonlLogger,
        PhaseTimes,
        debug_nan_mode,
        throughput,
        trace,
    )

    t_phase = time.perf_counter()
    d = OUT / "profiling"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    model, graph, agents = rung1
    rollout = make_decoded_rollout(model, GATODEConfig(), *graph,
                                   use_kernel=True)

    # throughput against CUDA events, alternated
    events, rates = [], []
    with torch.inference_mode():
        rollout(*agents)
        for kind in ("events", "throughput", "events", "throughput"):
            if kind == "events":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                rollout(*agents)
                end.record()
                torch.cuda.synchronize()
                events.append(start.elapsed_time(end) / 1e3)
            else:
                rates.append(throughput(rollout, *agents, items=N_AGENTS,
                                        iters=3, warmup=1))
    ev_rate = N_AGENTS / min(events)
    tp_rate = max(r["items_per_s"] for r in rates)
    per_call = ", ".join(f"{r['ms_per_call']:.3f}" for r in rates)
    print(f"phase 66 throughput() of the rung-1 rollout (K1, {N_AGENTS} "
          f"agents x {NUM_TIMES} times): "
          + ", ".join(f"{r['items_per_s']:.0f}" for r in rates)
          + f" agents/s ({per_call} ms a call); "
          f"CUDA events {', '.join(f'{N_AGENTS / e:.0f}' for e in events)} "
          f"agents/s; best {tp_rate:.0f} against {ev_rate:.0f} (rel "
          f"{tp_rate / ev_rate - 1:+.4f}, within {THROUGHPUT_RTOL}); phase "
          f"5's rollout "
          + (f"{k1_rate:.0f} agents/s" if k1_rate else "not run")
          + f" [card {card}]", flush=True)
    if abs(tp_rate / ev_rate - 1) > THROUGHPUT_RTOL:
        fail("phase 66: throughput() differs from the CUDA events' timing")

    # trace around one rollout
    rk4_interval_decode_fused.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode(), trace(str(d / "trace")):
        rollout(*agents)
    t_trace = time.perf_counter() - t0
    launched = rk4_interval_decode_fused.launches
    n_k1, names = chrome_kernels(d / "trace", "interval_kernel")
    print(f"phase 66 trace() of one rung-1 rollout: {n_k1} K1 launches in "
          f"the Chrome trace ({names}), {launched} counted by the wrapper; "
          f"{t_trace:.3f} s with the trace's export [card {card}]",
          flush=True)
    if not n_k1 == launched == NUM_TIMES - 1:
        fail(f"phase 66: the trace holds {n_k1} K1 launches, the wrapper "
             f"counted {launched}, the rollout makes {NUM_TIMES - 1}")

    # the NaN-check mode
    with debug_nan_mode():
        try:
            torch.log(torch.tensor([-1.0, 2.0], device=dev))
        except FloatingPointError as e:
            log_msg = str(e)
        else:
            fail("phase 66: torch.log(-1) on the card did not raise")
        x = torch.tensor([0.0, 1.0], device=dev, requires_grad=True)
        y = (torch.sqrt(x) * 0).sum()
        try:
            y.backward()
        except FloatingPointError as e:
            bwd_msg = str(e)
        else:
            fail("phase 66: a NaN gradient on the card did not raise")
    step_args = step_operands(model, 65_536, NUM_ZONES, dev, seed=3)
    bad = step_args[0].clone()
    bad[11, 5] = float("nan")
    before = rk4_step_fused.launches
    with torch.inference_mode(), debug_nan_mode():
        try:
            rk4_step_fused(bad, *step_args[1:])
        except FloatingPointError as e:
            k0_msg = str(e)
        else:
            fail("phase 66: K0 on a NaN state did not raise in the mode")
    if rk4_step_fused.launches != before + 1 or "rk4_step_fused" not in k0_msg:
        fail(f"phase 66: K0 launched {rk4_step_fused.launches - before} "
             f"times, raised {k0_msg!r}")
    print(f"phase 66 debug_nan_mode raises: {log_msg!r} (torch.log(-1)), "
          f"{bwd_msg!r} (a backward on autograd's device thread), "
          f"{k0_msg!r} (K0 on a state with one NaN, after its launch)",
          flush=True)

    # rung 2's fixed step: off, off, on from one state: the same bits
    config = GATODEConfig(substeps=SUBSTEPS, num_blocks=2)
    tmodel, opt, static, batch = rung2_trainer(dev, config)
    step, _ = make_fused_train_step(tmodel, opt, config, static)
    step(*batch)  # warm-up
    kernels = (ft.day_forward_fused, ft.day_backward_fused,
               ft.ce_forward_fused, ft.ce_backward_fused,
               fg.gat_forward_fused, fg.gat_backward_fused)
    params0 = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    opt0 = copy.deepcopy(opt.state_dict())
    phases = PhaseTimes()
    logger = JsonlLogger(str(d / "steps.jsonl"))
    runs = []
    for label, mode in (("off", False), ("off again", False), ("on", True)):
        tmodel.load_state_dict(params0)
        opt.load_state_dict(copy.deepcopy(opt0))
        before = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with phases.phase(f"fixed step, mode {label}"), \
                debug_nan_mode(mode):
            loss, acc = step(*batch)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logger.log({"run": label, "loss": loss, "acc": acc, "wall_s": wall})
        runs.append((loss.detach().clone(), [p.detach().clone() for p in
                                             tmodel.parameters()],
                     [opt.state[p][k].clone() for p in tmodel.parameters()
                      for k in ("exp_avg", "exp_avg_sq")], wall,
                     [k.launches - b for k, b in zip(kernels, before)]))
    same = [torch.equal(runs[0][0], r[0])
            and all(torch.equal(a, b) for a, b in zip(runs[0][1], r[1]))
            and all(torch.equal(a, b) for a, b in zip(runs[0][2], r[2]))
            for r in runs[1:]]
    logged = [json.loads(line) for line in open(d / "steps.jsonl")]
    print(f"phase 66 rung-2 fixed step ({TRAIN_N} x {TRAIN_ZONES} x "
          f"{TRAIN_TIMES}): loss {runs[0][0].item():.7f}; off again the "
          f"same bits {same[0]}, under debug_nan_mode the same bits "
          f"{same[1]}; walls off {runs[0][3]:.4f} / {runs[1][3]:.4f} s, on "
          f"{runs[2][3]:.4f} s (host clock, synced; the mode's overhead "
          f"{runs[2][3] / min(runs[0][3], runs[1][3]):.1f}x); launches "
          f"K2f/K2b/K3f/K3b/K4f/K4b {[r[4] for r in runs]}; PhaseTimes "
          f"{phases.summary()}; JsonlLogger losses "
          f"{[r['loss'] for r in logged]} [card {card}]", flush=True)
    if not all(same) or any(r[4] != [1] * 6 for r in runs):
        fail("phase 66: the fixed step under debug_nan_mode changed its "
             "bits, or a run launched another kernel count")
    if [r["loss"] for r in logged] != [r[0].item() for r in runs] or \
            not all(isinstance(r["acc"], float) for r in logged):
        fail("phase 66: JsonlLogger did not log the CUDA scalars as floats")

    # the asynchronous checkpoint, the next step launched before wait()
    names = [n for n, _ in tmodel.named_parameters()]
    params = [p for _, p in tmodel.named_parameters()]
    state = lambda: {"params": dict(zip(names, params)),
                     "exp_avg": [opt.state[p]["exp_avg"] for p in params],
                     "exp_avg_sq": [opt.state[p]["exp_avg_sq"]
                                    for p in params]}
    at_save = {"params": {n: p.detach().clone() for n, p in
                          zip(names, params)},
               **{k: [opt.state[p][k].clone() for p in params]
                  for k in ("exp_avg", "exp_avg_sq")}}
    ck = AsyncCheckpointer()
    path = str(d / "async.ckpt")
    t0 = time.perf_counter()
    ck.save(state(), path)
    t_save = time.perf_counter() - t0
    step(*batch)  # updates every parameter and moment in place
    t0 = time.perf_counter()
    ck.wait()
    t_wait = time.perf_counter() - t0
    loaded = load_checkpoint(path)
    host = lambda t: t.cpu().numpy()
    held = all(np.array_equal(loaded["params"][n],
                              host(at_save["params"][n])) for n in names) \
        and all(np.array_equal(a, host(b)) for key in ("exp_avg",
                                                        "exp_avg_sq")
                for a, b in zip(loaded[key], at_save[key]))
    moved = not all(torch.equal(p, at_save["params"][n])
                    for n, p in zip(names, params))
    print(f"phase 66 AsyncCheckpointer: save {t_save:.3f} s (the copy to "
          f"the host), wait {t_wait:.3f} s after the next step; the file "
          f"holds the state at save bit for bit {held}, the step moved the "
          f"parameters {moved}; phase 66 in "
          f"{time.perf_counter() - t_phase:.1f} s [card {card}]", flush=True)
    if not (held and moved):
        fail("phase 66: the asynchronous checkpoint does not hold the state "
             "at save")


if __name__ == "__main__":
    main()
