"""The mesh entry points of the port's schedule, traj_syn and latent_ode
families on a 2-rank gloo mesh on the CPU: the trainer, the sampler and
the CRF trainer of the schedule VAE, ``train_traj_embed`` and the latent_ode
``BatchedInferenceEngine``, each held against the single-device call (and
the CRF trainer and the batch norm against the JAX package); and the rules
they keep: every draw is the whole batch's, batch norm takes the whole
batch's statistics.

One group of ranks (``_torch_parallel_worker.py``, suite ``pipelines``)
runs every case of this file once; each test reads its case's results and
the files rank 0 wrote."""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_worker as w
from _schedule_port import _rel
from ananke_abm_tpu.models.gen_schedule.crf import model as jcrf_model
from ananke_abm_tpu.models.gen_schedule.crf.train import (
    train_crf as jtrain_crf,
)
from ananke_abm_tpu.models.gen_schedule.encoders import SyncBatchNorm
from ananke_abm_tpu.utils import load_checkpoint as jload
from ananke_abm_tpu_torch.models.gen_schedule.pipeline import (
    sample as tsample,
)
from ananke_abm_tpu_torch.models.gen_schedule.pipeline import train as ttrain
from ananke_abm_tpu_torch.models.latent_ode.inference import (
    BatchedInferenceEngine,
)
from ananke_abm_tpu_torch.models.traj_syn.pipeline.train_full import (
    train_traj_embed,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint

WORLD = 2


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipelines"))
    paths = w.pipeline_files(d)
    init = jcrf_model.init_crf_params(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), 7)
    np.savez(os.path.join(d, "crf_init.npz"),
             **{k: np.asarray(v) for k, v in init.items()})
    return d, paths, w.run_group("pipelines", WORLD, d)


def _log(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(v) for v in r.values()] for r in rows])


def test_draws_are_the_whole_batch_draws(group):
    *_, ranks = group
    for r in ranks:
        for k in ("dropout", "reparam", "sde"):
            np.testing.assert_array_equal(r[f"draws_and_norms/{k}_rows"],
                                          r[f"draws_and_norms/{k}_whole"],
                                          err_msg=k)


def test_batch_norm_takes_the_whole_batch_statistics(group):
    *_, ranks = group
    for r in ranks:
        for k in ("y", "dx"):
            np.testing.assert_allclose(r[f"draws_and_norms/bn_rows_{k}"],
                                       r[f"draws_and_norms/bn_whole_{k}"],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for k in ("dw", "stats"):
            np.testing.assert_allclose(r[f"draws_and_norms/bn_rows_{k}"],
                                       r[f"draws_and_norms/bn_whole_{k}"],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # and the whole batch's output against the reference's SyncBatchNorm
    import torch

    x = torch.randn((7, 4, 5), generator=torch.Generator().manual_seed(0))
    xj = jnp.asarray(x.numpy().transpose(0, 2, 1))  # (B, T, C)
    bn = SyncBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), xj, use_running_average=False)
    yj, upd = bn.apply(v, xj, use_running_average=False,
                       mutable=["batch_stats"])
    got = np.concatenate([r["draws_and_norms/bn_rows_y"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(yj).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(
        ranks[0]["draws_and_norms/bn_rows_stats"],
        np.stack([stats["mean"], stats["var"]]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", w.SCHED_NORMS)
def test_schedule_trainer_under_a_mesh_is_the_single_device_run(group, norm,
                                                                 tmp_path):
    """Dropout and the loss means over the whole batch: the run's log and
    parameters are the single device's. Under ``norm="batch"`` the
    convolution biases before each batch norm have a zero gradient up to
    rounding, which Adam scales to full steps: those biases, the running
    means that follow them and the eval-mode metrics track the rounding,
    so there the training columns (batch statistics) are compared."""
    d, paths, ranks = group
    with open(paths[f"cfg_{norm}"]) as f:
        cfg = json.load(f)
    single = str(tmp_path / "single")
    res = ttrain.train(cfg, single, seed=1, device="cpu")
    got = _log(os.path.join(d, f"sched_mesh_{norm}", "training_log.csv"))
    want = _log(os.path.join(single, "training_log.csv"))
    if norm == "batch":
        cols = slice(0, 10)  # epoch, beta and the train_* components
        np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=1e-5,
                                   atol=1e-7)
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for r in ranks:
        np.testing.assert_allclose(r[f"schedule/train_{norm}"],
                                   [res["best_val_loss"], res["epochs_ran"]],
                                   rtol=1e-5)
    # the whole parameter vector (the biases before each norm follow the
    # rounding, as above, but weigh little in it)
    flat = [np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
        load_checkpoint(os.path.join(r, "checkpoints", "last.ckpt"))[
            "params"])]) for r in (os.path.join(d, f"sched_mesh_{norm}"),
                                   single)]
    assert np.linalg.norm(flat[0] - flat[1]) <= 2e-3 * np.linalg.norm(
        flat[1])


def test_sampler_under_a_mesh_is_the_single_device_sample(group, tmp_path):
    """A chunk of 63 rounds up to 64 over the 2 ranks: both equal the
    single-device sample in chunks of 64."""
    d, paths, ranks = group
    prefix = str(tmp_path / "single")
    tsample.sample(paths["vae"], outprefix=prefix, chunk_size=64,
                   device="cpu", **w.SAMPLE)
    with np.load(prefix + ".npz") as z:
        want = {k: z[k] for k in z.files}
    for chunk in (63, 64):
        for r in ranks:
            assert int(r[f"schedule/sample_{chunk}"]) == w.SAMPLE[
                "num_samples"]
        with np.load(os.path.join(d, f"sample_{chunk}.npz")) as got:
            np.testing.assert_array_equal(got["Y_generated"],
                                          want["Y_generated"])
            np.testing.assert_allclose(got["U_mean_logits"],
                                       want["U_mean_logits"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got["U_std_logits"],
                                       want["U_std_logits"], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got["Z_stats"], want["Z_stats"],
                                       rtol=1e-5, atol=1e-6)
        assert os.path.exists(os.path.join(d, f"sample_{chunk}_meta.json"))


def test_train_crf_under_a_mesh_matches_jax(group):
    """One full batch an epoch and JAX's initial parameters: the sharded
    CRF trainer lands on JAX's single-device run."""
    d, _, ranks = group
    jres = jtrain_crf(w.crf_cfg(d, "crf_jax.ckpt"), seed=0)
    for r in ranks:
        np.testing.assert_allclose(r["schedule/crf"], jres["best_val_nll"],
                                   rtol=1e-5)
    j = jload(os.path.join(d, "crf_jax.ckpt"))
    t = load_checkpoint(os.path.join(d, "crf_mesh.ckpt"))
    for k in ("A", "bias"):
        assert _rel(t["params"][k], j["params"][k]) <= 1e-5


def test_traj_embed_under_a_mesh_is_the_single_device_run(group, tmp_path):
    d, _, ranks = group
    kw = w.traj_kwargs(d, "unused")
    kw["outdir"] = str(tmp_path / "single")
    res = train_traj_embed(**kw, device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["traj_embed/best"], res["best_val_loss"],
                                   rtol=2e-4)
    np.testing.assert_allclose(
        _log(os.path.join(d, "traj_mesh", "training_log.csv")),
        _log(os.path.join(kw["outdir"], "training_log.csv")), rtol=2e-4,
        atol=1e-6)
    assert os.path.exists(os.path.join(d, "traj_mesh", "ckpt_best.ckpt"))


@pytest.mark.parametrize("name", sorted(w.LATENT_CASES))
def test_latent_ode_engine_under_a_mesh_is_the_single_device_engine(group,
                                                                    name):
    """The person axis shards; the SDE noise (or the dopri5 controller)
    is the whole batch's."""
    _, paths, ranks = group
    eng = BatchedInferenceEngine(paths[f"latent_{name}"], person_ids=(1, 2),
                                 device="cpu")
    pred = eng.predict_trajectories(num_samples=2, seed=4)
    for r in ranks:
        for k in ("zones", "purposes", "modes"):
            np.testing.assert_array_equal(r[f"latent_ode/{name}_{k}"],
                                          pred[k], err_msg=k)
        assert r[f"latent_ode/{name}_bench"] > 0
