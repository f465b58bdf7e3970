"""One rank of the port's parallel tests: a gloo process group on the CPU.

``python tests/_torch_parallel_worker.py SUITE RANK WORLD DIR`` joins the
group of WORLD ranks at the ``file://`` rendezvous in DIR, runs every case
of SUITE in order on a mesh of the world (2 ranks: 2 x 1; 4 ranks: 2 x 2)
and writes this rank's results to ``DIR/SUITE_RANK.npz``, keys
``case/name``. A failing case writes its traceback to
``DIR/SUITE_RANK.err`` and ends the rank at once. Imports no JAX: the
tests hold these results against the JAX package and the port's
single-device calls in their own process, building the same inputs with
the set-up functions here.

:func:`run_group` starts the ranks of one suite (one group a test file),
each on one intra-op thread, and kills them all after a deadline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the widths of tests/_torch_port.py::TINY
TINY = dict(zone_dim=16, agent_dim=8, context_dim=8, hidden_dim=16,
            gat_heads=2, gat_layers=1, substeps=2)
N_AGENTS, NUM_TIMES, NUM_ZONES = 32, 6, 12


# ---- set-ups shared with the tests ----------------------------------------

def gatode(seed=0, n_agents=N_AGENTS, num_times=NUM_TIMES,
           num_zones=NUM_ZONES, num_blocks=1, **overrides):
    """``(config, data, model)``: a tiny GAT-ODE on the CPU initialised
    from ``seed``, and its world."""
    from ananke_abm_tpu_torch.data_generator import generate_agent_population
    from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain

    cfg = ttrain.GATODEConfig(num_blocks=num_blocks, **{**TINY, **overrides})
    data = generate_agent_population(n_agents, num_times=num_times,
                                     num_zones=num_zones, seed=seed)
    model = ttrain.build_model(cfg, data["zone_features"].shape[-1],
                               data["person_feats"].shape[-1], device="cpu")
    ttrain.init_params(model, torch.Generator().manual_seed(seed))
    return cfg, data, model


def static_of(data, sparse=False):
    from ananke_abm_tpu_torch.ops.segment import edges_from_adj

    t = lambda k: torch.as_tensor(data[k], dtype=torch.float32)
    if not sparse:
        return t("zone_features"), t("adj"), t("times")
    ei = tuple(torch.as_tensor(e, dtype=torch.long)
               for e in edges_from_adj(data["adj"]))
    return t("zone_features"), None, t("times"), ei


def batch_of(data):
    return (torch.as_tensor(data["person_feats"], dtype=torch.float32),
            torch.as_tensor(data["home_zone"], dtype=torch.long),
            torch.as_tensor(data["zone_ids"], dtype=torch.long))


def flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).double().numpy()


def flat_grads(model) -> np.ndarray:
    """The gradients the last step applied (``ClippedAdamW`` leaves the
    reduced, clipped gradient in ``.grad``)."""
    return torch.cat([p.grad.reshape(-1)
                      for p in model.parameters()]).double().numpy()


def optimizer_of(model, cfg):
    from ananke_abm_tpu_torch.models.gnn_embed.train import make_optimizer

    return make_optimizer(model, cfg)


# the cases' configurations, read by the tests too
STEP_CASES = {
    "rk4": dict(),
    "sparse": dict(sparse=True),
    "dopri5": dict(method="dopri5", rtol=1e-3, atol=1e-4),
    "clip": dict(grad_clip=1e-2),
}


def step_case(name):
    kw = dict(STEP_CASES[name])
    sparse = kw.pop("sparse", False)
    cfg, data, model = gatode(seed=1, **kw)
    return cfg, data, model, static_of(data, sparse)


# ---- the cases ----------------------------------------------------------------

def case_mesh_api(mesh, world):
    import torch.distributed as dist

    from ananke_abm_tpu_torch import parallel
    from ananke_abm_tpu_torch.parallel import mesh as pmesh

    x = torch.arange(world * 3 * 2, dtype=torch.float32).reshape(-1, 2)
    sh = parallel.shard_batch(mesh, {"x": x})["x"]
    rep = parallel.replicate(mesh, x)
    local = x[parallel.host_row_slice(x.shape[0])]
    glob = parallel.host_local_batch_to_global(mesh, local)
    info = parallel.maybe_initialize()
    errors = []
    for bad in (dict(n_devices=world + 1), dict(zone_parallel=3)):
        try:
            parallel.make_mesh(**bad)
        except ValueError as e:
            errors.append(str(e))
    return {"shard_shape": np.array(sh.shape),
            "shard_local": sh.to_local().numpy(),
            "rep_local": rep.to_local().numpy(),
            "global_shape": np.array(glob.shape),
            "global_local": glob.to_local().numpy(),
            "summary": np.array([info["process_index"],
                                 info["process_count"],
                                 info["local_devices"],
                                 info["global_devices"]]),
            "mesh_shape": np.array(mesh.mesh.shape),
            "default_zone_parallel": np.array(
                parallel.make_mesh().mesh.shape),
            "zone_rank": np.array(mesh.get_local_rank("zones")),
            "rank": np.array(dist.get_rank()),
            "errors": np.array(errors)}


def case_fused(mesh, world):
    from ananke_abm_tpu_torch.parallel import make_sharded_fused_train_step

    cfg, data, model = gatode(seed=3, num_times=4, num_zones=10,
                              n_agents=48, num_blocks=2)
    step = make_sharded_fused_train_step(model, optimizer_of(model, cfg),
                                         cfg, mesh, static_of(data))
    out = [step(*batch_of(data)) for _ in range(2)]
    return {"loss": np.array([float(l) for l, _ in out]),
            "acc": np.array([float(a) for _, a in out]),
            "params": flat_params(model), "grads": flat_grads(model)}


def _step_case(name, mesh, zone_ring=False):
    from ananke_abm_tpu_torch.parallel import make_sharded_train_step

    cfg, data, model, static = step_case(name)
    before = flat_params(model)
    step = make_sharded_train_step(model, optimizer_of(model, cfg), cfg,
                                   mesh, static, zone_ring=zone_ring)
    loss, acc = step(*batch_of(data))
    res = {"loss": np.array(float(loss)), "acc": np.array(float(acc)),
           "update": flat_params(model) - before,
           "grads": flat_grads(model)}
    fwd = step.stats.get("forward")
    if fwd is not None:
        res["steps"] = np.array([fwd["n_steps"], fwd["n_accepted"]])
    return res


def case_step_rk4(mesh, world):
    return _step_case("rk4", mesh)


def case_step_sparse(mesh, world):
    return _step_case("sparse", mesh)


def case_step_dopri5(mesh, world):
    return _step_case("dopri5", mesh)


def case_step_clip(mesh, world):
    return _step_case("clip", mesh)


def case_step_ring(mesh, world):
    return _step_case("rk4", mesh, zone_ring=True)


def case_step_refusals(mesh, world):
    from ananke_abm_tpu_torch.parallel import make_sharded_train_step

    cfg, data, model = gatode(seed=1)
    msgs = []
    try:
        make_sharded_train_step(model, None, cfg, mesh,
                                static_of(data, sparse=True), zone_ring=True)
    except ValueError as e:
        msgs.append(str(e))
    return {"messages": np.array(msgs)}


ROLLOUT_AGENTS = 33  # uneven over the agent axis


def rollout_setup():
    cfg, data, model = gatode(seed=2, n_agents=ROLLOUT_AGENTS)
    return cfg, data, model


def case_rollouts(mesh, world):
    from ananke_abm_tpu_torch.models.gnn_embed.rollout import (
        make_decoded_rollout,
        make_pallas_rollout,
    )
    from ananke_abm_tpu_torch.parallel import make_sharded_rollout

    cfg, data, model = rollout_setup()
    zf, adj, times = static_of(data)
    pf, hz, _ = batch_of(data)
    out = {
        "pallas_step": make_pallas_rollout(model, zf, adj, times,
                                           substeps=cfg.substeps,
                                           mesh=mesh)(pf, hz),
        "pallas_interval": make_pallas_rollout(
            model, zf, adj, times, substeps=cfg.substeps, mesh=mesh,
            fuse_decode=True)(pf, hz),
        "decoded_kernel": make_decoded_rollout(
            model, cfg, zf, adj, times, use_kernel=True, mesh=mesh)(pf, hz),
        "decoded_f32": make_decoded_rollout(
            model, cfg, zf, adj, times, use_kernel=False, mesh=mesh)(pf, hz),
        "sharded_dense": make_sharded_rollout(
            model, cfg, mesh, static_of(data))(pf, hz),
        "sharded_sparse": make_sharded_rollout(
            model, cfg, mesh, static_of(data, sparse=True))(pf, hz),
        "sharded_dopri5": make_sharded_rollout(
            model, dataclasses.replace(cfg, method="dopri5", rtol=1e-3,
                                       atol=1e-4), mesh,
            static_of(data))(pf, hz),
    }
    return {k: v.numpy() for k, v in out.items()}


def case_ring_encoder(mesh, world):
    from ananke_abm_tpu_torch.parallel import encode_zones_ring

    res = {}
    for z in (8, 12):
        cfg, data, model = gatode(seed=4, num_zones=z, gat_layers=2)
        zf, adj, _ = static_of(data)
        with torch.no_grad():
            res[f"z{z}"] = encode_zones_ring(
                model, zf, adj, mesh, heads=cfg.gat_heads,
                num_layers=cfg.gat_layers).numpy()
    cfg, data, model = gatode(seed=4, num_zones=12, gat_layers=2)
    zf, adj, _ = static_of(data)
    try:
        encode_zones_ring(model, zf[:5], adj[:5, :5], mesh,
                          heads=cfg.gat_heads, num_layers=cfg.gat_layers)
    except ValueError as e:
        res["indivisible"] = np.array(str(e))
    return res


def case_train(mesh, world):
    from ananke_abm_tpu_torch.models.gnn_embed import train as ttrain
    from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

    res = {}
    out = os.environ["PARALLEL_TEST_DIR"]
    for name, kw in TRAIN_CASES.items():
        d = os.path.join(out, f"train_{name}")
        r = ttrain.train(d, config=train_config(), data_parallel=True,
                         device="cpu", **kw)
        res[f"{name}_loss"] = np.array(r["final_loss"])
        res[f"{name}_acc"] = np.array(r["final_acc"])
        res[f"{name}_ckpt"] = np.array(os.path.exists(r["ckpt"]))
        res[f"{name}_seconds"] = np.array(r["seconds"])
        import torch.distributed as dist

        dist.barrier()
        ck = load_checkpoint(r["ckpt"])
        res[f"{name}_hist"] = np.array([h["loss"] for h in ck["history"]])
    return res


TRAIN_CASES = {"dense": dict(n_agents=40, num_times=6, num_zones=12, seed=5),
               "sparse": dict(n_agents=40, num_times=6, num_zones=12,
                              seed=5, sparse_zones=True)}


def train_config():
    from ananke_abm_tpu_torch.models.gnn_embed.train import GATODEConfig

    return GATODEConfig(**TINY, num_blocks=1, batch_size=15, epochs=2)


# ---- the schedule, traj_syn and latent_ode families ------------------------

SCHED_CFG = {
    "train": {"epochs": 2, "min_epochs": 2, "patience": 0, "batch_size": 32,
              "lr": 1e-3, "weight_decay": 1e-4, "grad_clip": 1.0,
              "beta_target": 1.0, "beta_warm_frac": 0.3, "lambda_tv": 0.01,
              "lambda_home": 0.1},
    "model": {"method": "baseline_cnn", "z_dim": 4, "emb_dim": 16,
              "cnn_channels": [8], "cnn_kernel": 3, "cnn_dropout": 0.1,
              "cnn_norm": "batch"},
}
SAMPLE = dict(num_samples=100, seed=2, csv_max_persons=3,
              reject_all_home=True)
SCHED_NORMS = ("group", "batch")
LATENT_TINY = dict(hidden_dim=8, encoder_hidden_dim=16, ode_hidden_dim=16,
                   zone_embed_dim=4, num_residual_blocks=1, sde_dt=0.1)
LATENT_CASES = {"sde": dict(),
                "dopri5": dict(enable_sde=False, ode_method="dopri5",
                               rtol=1e-3, atol=1e-4)}


def pipeline_files(d):
    """The files the pipeline cases read, written with the port's numpy
    code (and its single-device trainer for the sampler's checkpoint):
    ``paths`` by name."""
    import copy
    import json

    from ananke_abm_tpu_torch.data_generator import population as tpop
    from ananke_abm_tpu_torch.dataio import rasterize as trast
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import (
        train as strain,
    )
    from ananke_abm_tpu_torch.models.latent_ode.config import (
        GenerativeODEConfig,
    )
    from ananke_abm_tpu_torch.models.latent_ode.model import (
        GenerativeODE,
        to_flax_params,
    )
    from ananke_abm_tpu_torch.utils.ckpt import save_checkpoint

    paths = {"acts": os.path.join(d, "activities.csv"),
             "grid": os.path.join(d, "grid.npz")}
    tpop.write_csv(paths["acts"],
                   tpop.generate_population_activities(96, seed=11))
    trast.prepare_from_csv(paths["acts"], paths["grid"], grid_min=60,
                           val_frac=0.2, seed=5)
    for norm in SCHED_NORMS:
        cfg = copy.deepcopy(SCHED_CFG)
        cfg["data"] = {"npz": paths["grid"]}
        cfg["model"]["cnn_norm"] = norm
        paths[f"cfg_{norm}"] = os.path.join(d, f"sched_cfg_{norm}.json")
        with open(paths[f"cfg_{norm}"], "w") as f:
            json.dump(cfg, f)
    strain.train(cfg, os.path.join(d, "vae"), seed=1, device="cpu")
    paths["vae"] = os.path.join(d, "vae", "checkpoints", "best_val.ckpt")
    rng = np.random.default_rng(12)
    for tag, n in (("crf_train", 24), ("crf_val", 10)):
        y = rng.integers(0, 7, size=(n, 12))
        u = (rng.standard_normal((n, 12, 7)) + 2.0 * np.eye(7)[y]
             ).astype(np.float32)
        paths[tag] = os.path.join(d, tag + ".npz")
        np.savez(paths[tag], U=u, Y=y.astype(np.int64))
    paths["crf_meta"] = os.path.join(d, "crf_meta.json")
    with open(paths["crf_meta"], "w") as f:
        f.write('{"P": 7, "L": 12, "home_idx": 0}')
    for name, kw in LATENT_CASES.items():
        config = GenerativeODEConfig(**LATENT_TINY, **kw)
        torch.manual_seed(7)
        m = GenerativeODE(8, 7, config)
        paths[f"latent_{name}"] = os.path.join(d, f"latent_{name}.ckpt")
        save_checkpoint({"params": to_flax_params(m),
                         "config": dataclasses.asdict(config)},
                        paths[f"latent_{name}"])
    return paths


def crf_cfg(d, save):
    return {"train_npz": os.path.join(d, "crf_train.npz"),
            "val_npz": os.path.join(d, "crf_val.npz"),
            "meta_json": os.path.join(d, "crf_meta.json"),
            "save_path": os.path.join(d, save), "num_epochs": 2,
            "batch_size": 24, "lr": "1e-2", "weight_decay": "1e-4",
            "log_every": 10}


def traj_kwargs(d, outdir):
    return dict(activities_csv=os.path.join(d, "activities.csv"),
                purposes_csv=None, epochs=2, batch_size=16,
                outdir=os.path.join(d, outdir), seed=3)


def case_schedule(mesh, world):
    import json

    import torch.distributed as dist

    from ananke_abm_tpu_torch.models.gen_schedule.crf.train import train_crf
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import (
        sample as ssample,
    )
    from ananke_abm_tpu_torch.models.gen_schedule.pipeline import (
        train as strain,
    )

    d = os.environ["PARALLEL_TEST_DIR"]
    out = {}
    for norm in SCHED_NORMS:
        with open(os.path.join(d, f"sched_cfg_{norm}.json")) as f:
            cfg = json.load(f)
        res = strain.train(cfg, os.path.join(d, f"sched_mesh_{norm}"),
                           seed=1, mesh=mesh, device="cpu")
        out[f"train_{norm}"] = np.array([res["best_val_loss"],
                                         res["epochs_ran"]])
    for chunk in (63, 64):
        info = ssample.sample(os.path.join(d, "vae", "checkpoints",
                                           "best_val.ckpt"),
                              outprefix=os.path.join(d, f"sample_{chunk}"),
                              chunk_size=chunk, mesh=mesh, device="cpu",
                              **SAMPLE)
        out[f"sample_{chunk}"] = np.array(info["generated"])
    with np.load(os.path.join(d, "crf_init.npz")) as z:
        init = {k: z[k] for k in z.files}
    res = train_crf(crf_cfg(d, "crf_mesh.ckpt"), init=init, mesh=mesh,
                    device="cpu")
    out["crf"] = np.array(res["best_val_nll"])
    dist.barrier()
    return out


def case_traj_embed(mesh, world):
    from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
        train_traj_embed,
    )

    d = os.environ["PARALLEL_TEST_DIR"]
    res = train_traj_embed(**traj_kwargs(d, "traj_mesh"), mesh=mesh,
                           device="cpu")
    return {"best": np.array(res["best_val_loss"])}


def case_latent_ode(mesh, world):
    from ananke_abm_tpu_torch.models.latent_ode.inference import (
        BatchedInferenceEngine,
    )

    d = os.environ["PARALLEL_TEST_DIR"]
    out = {}
    for name in LATENT_CASES:
        eng = BatchedInferenceEngine(os.path.join(d, f"latent_{name}.ckpt"),
                                     person_ids=(1, 2), mesh=mesh,
                                     device="cpu")
        pred = eng.predict_trajectories(num_samples=2, seed=4)
        for k in ("zones", "purposes", "modes"):
            out[f"{name}_{k}"] = pred[k]
        bench = eng.benchmark_performance(batch_sizes=(3,))
        out[f"{name}_bench"] = np.array(bench[3]["people_per_s"])
    return out


def case_draws_and_norms(mesh, world):
    """Whole-batch draws and batch statistics: each rank's rows of the
    sharded call against the same rows of the whole-batch call."""
    from ananke_abm_tpu_torch.models.gen_schedule.encoders import (
        SyncBatchNorm1d,
        dropout,
        reparameterize,
    )
    from ananke_abm_tpu_torch.ode import euler_maruyama_solve
    from ananke_abm_tpu_torch.parallel.mesh import (
        AGENT_AXIS,
        row_slice,
    )
    from ananke_abm_tpu_torch.utils.seed import RowDraws, generator

    n = 7
    rows, group = row_slice(n, mesh), mesh.get_group(AGENT_AXIS)
    x = torch.randn((n, 4, 5), generator=torch.Generator().manual_seed(0))
    wts = torch.randn((n, 4, 5), generator=torch.Generator().manual_seed(1))
    gen = lambda: generator("cpu", 9)  # noqa: E731
    out = {"rows": np.array([rows.start, rows.stop])}
    out["dropout_whole"] = dropout(x, 0.3, True, gen())[rows].numpy()
    out["dropout_rows"] = dropout(x[rows], 0.3, True,
                                  RowDraws(gen(), rows, n, group)).numpy()
    mu, lv = x[:, 0], x[:, 1]
    out["reparam_whole"] = reparameterize(mu, lv, gen())[rows].numpy()
    out["reparam_rows"] = reparameterize(
        mu[rows], lv[rows], RowDraws(gen(), rows, n, group)).numpy()
    y0, ts = x[:, 2], np.linspace(0.0, 1.0, 4).astype(np.float32)
    drift = lambda t, y, a: -y  # noqa: E731
    diff = lambda t, y, a: 0.5 * torch.ones_like(y)  # noqa: E731
    out["sde_whole"] = euler_maruyama_solve(
        drift, diff, y0, ts, gen(), substeps=3)[:, rows].numpy()
    out["sde_rows"] = euler_maruyama_solve(
        drift, diff, y0[rows], ts, RowDraws(gen(), rows, n, group),
        substeps=3).numpy()
    for tag, grp in (("whole", None), ("rows", group)):
        bn = SyncBatchNorm1d(4, eps=1e-5, momentum=0.1)
        bn.group = grp
        xi = (x if grp is None else x[rows]).clone().requires_grad_(True)
        y = bn(xi)
        (y * (wts if grp is None else wts[rows])).sum().backward()
        sl = rows if grp is None else slice(None)
        out[f"bn_{tag}_y"] = y[sl].detach().numpy()
        out[f"bn_{tag}_dx"] = xi.grad[sl].numpy()
        gw = bn.weight.grad.clone()
        if grp is not None:
            torch.distributed.all_reduce(gw, group=grp)
        out[f"bn_{tag}_dw"] = gw.numpy()
        out[f"bn_{tag}_stats"] = torch.stack(
            [bn.running_mean, bn.running_var]).numpy()
    return out


SUITES = {
    "gatode": [case_mesh_api, case_fused, case_step_rk4, case_step_sparse,
               case_step_dopri5, case_step_clip, case_step_refusals,
               case_rollouts, case_train],
    "zones": [case_mesh_api, case_ring_encoder, case_step_rk4,
              case_step_ring, case_fused, case_rollouts],
    "pipelines": [case_draws_and_norms, case_schedule, case_traj_embed,
                  case_latent_ode],
}


# ---- the rank ---------------------------------------------------------------

def main(argv):
    suite, rank, world, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ananke_abm_tpu_torch.parallel import make_mesh, maybe_initialize

    os.environ["PARALLEL_TEST_DIR"] = d
    maybe_initialize(f"file://{os.path.join(d, suite + '.rendezvous')}",
                     world, rank, backend="gloo", device="cpu",
                     timeout_s=60)
    mesh = make_mesh()
    out = {}
    for case in SUITES[suite]:
        name = case.__name__[len("case_"):]
        try:
            for k, v in case(mesh, world).items():
                out[f"{name}/{k}"] = np.asarray(v)
        except BaseException:
            with open(os.path.join(d, f"{suite}_{rank}.err"), "w") as f:
                f.write(f"case {name} on rank {rank}:\n"
                        + traceback.format_exc())
            os._exit(1)
    np.savez(os.path.join(d, f"{suite}_{rank}.npz"), **out)
    dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_mesh(d):
    """A one-rank gloo process group in this process (rendezvous in
    ``d``) and its (1, 1) mesh; the group ends on exit."""
    import torch.distributed as dist

    from ananke_abm_tpu_torch.parallel import make_mesh, maybe_initialize

    maybe_initialize(f"file://{os.path.join(str(d), 'one_rank')}", 1, 0,
                     backend="gloo", device="cpu", timeout_s=60)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def torchrun(module, argv, n, cwd, timeout=180):
    """``torchrun --standalone --nproc-per-node=n -m module argv`` on the
    CPU (``ANANKE_PLATFORM=cpu``, one thread a rank)."""
    env = dict(os.environ, ANANKE_PLATFORM="cpu", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", module, *argv], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


def run_group(suite: str, world: int, d: str, timeout: float = 240.0):
    """Run the ranks of ``suite`` and return ``[results of rank r]`` (dicts
    of arrays); raises with the first rank's traceback when a rank fails,
    every rank killed after ``timeout`` seconds."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(world), d], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = []
    for r in range(world):
        err = os.path.join(d, f"{suite}_{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f.read())
    if errors or any(p.returncode for p in procs):
        raise RuntimeError(
            f"suite {suite!r}: rank exit codes "
            f"{[p.returncode for p in procs]}\n" + "\n".join(errors)
            + "\n".join(logs)[-4000:])
    results = []
    for r in range(world):
        with np.load(os.path.join(d, f"{suite}_{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
