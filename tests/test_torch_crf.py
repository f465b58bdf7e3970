"""The port's linear-chain CRF (``ananke_abm_tpu_torch/ops/crf.py``) and
its CRF refinement (``models/gen_schedule/crf``) against the JAX package
on the same seeded inputs, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import one_rank_mesh
from ananke_abm_tpu.models.gen_schedule.crf import model as jcrf_model
from ananke_abm_tpu.models.gen_schedule.crf.train import (
    train_crf as jtrain_crf,
)
from ananke_abm_tpu.ops import crf as jcrf
from ananke_abm_tpu.utils import load_checkpoint as jload
from ananke_abm_tpu_torch.models.gen_schedule.crf import model as tcrf_model
from ananke_abm_tpu_torch.models.gen_schedule.crf.train import (
    train_crf as ttrain_crf,
)
from ananke_abm_tpu_torch.ops import crf as tcrf
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint as tload

HOME = 2


def _instance(seed, B=6, T=12, P=5, scale=1.0):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((B, T, P)) * scale).astype(np.float32)
    A = (rng.standard_normal((P, P)) * 0.5).astype(np.float32)
    y = rng.integers(0, P, size=(B, T))
    return u, A, y


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("seed,T,P", [(0, 12, 5), (1, 1, 3), (2, 48, 7)])
def test_log_partition_and_marginals_match_jax(seed, T, P):
    u, A, _ = _instance(seed, T=T, P=P)
    want = jcrf.crf_log_partition(jnp.asarray(u), jnp.asarray(A))
    got = tcrf.crf_log_partition(_t(u), _t(A))
    assert _rel(got, want) <= 1e-5
    want = jcrf.crf_marginals(jnp.asarray(u), jnp.asarray(A))
    got = tcrf.crf_marginals(_t(u), _t(A))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed,T,P", [(3, 12, 5), (4, 48, 7), (5, 2, 2),
                                      (6, 1, 4)])
def test_viterbi_paths_equal_jax(seed, T, P):
    u, A, _ = _instance(seed, B=16, T=T, P=P, scale=2.0)
    want = jcrf.viterbi_decode(jnp.asarray(u), jnp.asarray(A))
    got = tcrf.viterbi_decode(_t(u), _t(A))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    home = min(HOME, P - 1)
    want = jcrf.viterbi_decode_no_all_home(jnp.asarray(u), jnp.asarray(A),
                                           home)
    got = tcrf.viterbi_decode_no_all_home(_t(u), _t(A), home)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if P > 1:
        assert ((got.numpy() != home).any(axis=1)).all()


def test_constrained_decode_under_a_home_heavy_pull_equals_jax():
    """Unaries that favour home everywhere: the constraint decides."""
    u, A, _ = _instance(7, B=32, T=24, P=7)
    u[:, :, HOME] += 4.0
    want = jcrf.viterbi_decode_no_all_home(jnp.asarray(u), jnp.asarray(A),
                                           HOME)
    got = tcrf.viterbi_decode_no_all_home(_t(u), _t(A), HOME)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got.numpy() != HOME).any(axis=1)).all()
    assert (tcrf.viterbi_decode(_t(u), _t(A)).numpy() == HOME).all(1).any()


def test_ties_go_to_the_first_index_as_in_jax():
    u = np.zeros((3, 6, 4), np.float32)
    A = np.zeros((4, 4), np.float32)
    for fn in ("viterbi_decode",):
        np.testing.assert_array_equal(
            getattr(tcrf, fn)(_t(u), _t(A)).numpy(),
            np.asarray(getattr(jcrf, fn)(jnp.asarray(u), jnp.asarray(A))))
    np.testing.assert_array_equal(
        tcrf.viterbi_decode_no_all_home(_t(u), _t(A), 1).numpy(),
        np.asarray(jcrf.viterbi_decode_no_all_home(jnp.asarray(u),
                                                   jnp.asarray(A), 1)))


@pytest.mark.parametrize("masked", [False, True])
def test_nll_and_its_gradients_match_jax(masked):
    u, A, y = _instance(8, B=6, T=16, P=5)
    bias = np.random.default_rng(9).standard_normal(5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None

    def jloss(u, A, bias):
        return jcrf.crf_nll(u + bias[None, None], jnp.asarray(y), A,
                            None if mask is None else jnp.asarray(mask))

    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(A), jnp.asarray(bias))
    tu, tA, tb = (_t(a).requires_grad_(True) for a in (u, A, bias))
    got = tcrf.crf_nll(tu + tb[None, None], _t(y), tA,
                       None if mask is None else _t(mask))
    got.backward()
    assert _rel(got.detach(), want) <= 1e-6
    for g, jg in zip((tu.grad, tA.grad, tb.grad), jgrads):
        assert _rel(g, jg) <= 1e-4


def test_path_score_matches_jax():
    u, A, y = _instance(10, T=20, P=7)
    want = jcrf.crf_path_score(jnp.asarray(u), jnp.asarray(y), jnp.asarray(A))
    got = tcrf.crf_path_score(_t(u), _t(y), _t(A))
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("enforce", [False, True])
def test_crf_decode_with_bias_matches_jax(enforce):
    u, A, _ = _instance(11, B=8, T=20, P=7)
    params = {"A": A, "bias": np.linspace(-1, 1, 7).astype(np.float32)}
    want = jcrf_model.crf_decode(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(u),
        home_idx=HOME, enforce_nonhome=enforce)
    got = tcrf_model.crf_decode({k: _t(v) for k, v in params.items()},
                                _t(u), home_idx=HOME,
                                enforce_nonhome=enforce)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _crf_files(tmp_path, n_train=24, n_val=10, T=12, P=7):
    rng = np.random.default_rng(12)
    paths = {}
    for tag, n in (("train", n_train), ("val", n_val)):
        y = rng.integers(0, P, size=(n, T))
        u = (rng.standard_normal((n, T, P)) + 2.0 * np.eye(P)[y]
             ).astype(np.float32)
        paths[tag] = str(tmp_path / f"crf_{tag}.npz")
        np.savez(paths[tag], U=u, Y=y.astype(np.int64))
    meta = str(tmp_path / "crf_meta.json")
    with open(meta, "w") as f:
        f.write(f'{{"P": {P}, "L": {T}, "home_idx": {HOME}}}')
    return paths, meta


def test_train_crf_full_batch_epochs_match_jax(tmp_path):
    """One full batch an epoch (so the permutation only reorders a sum),
    JAX's initial parameters injected: two epochs land on JAX's."""
    paths, meta = _crf_files(tmp_path)
    cfg = {"train_npz": paths["train"], "val_npz": paths["val"],
           "meta_json": meta, "num_epochs": 2, "batch_size": 24,
           "lr": "1e-2", "weight_decay": "1e-4", "log_every": 10}
    jres = jtrain_crf({**cfg, "save_path": str(tmp_path / "j.ckpt")}, seed=0)
    init = jcrf_model.init_crf_params(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), 7)
    tres = ttrain_crf({**cfg, "save_path": str(tmp_path / "t.ckpt")},
                      seed=0, device="cpu",
                      init={k: np.asarray(v) for k, v in init.items()})
    np.testing.assert_allclose(tres["best_val_nll"], jres["best_val_nll"],
                               rtol=1e-5)
    j, t = jload(str(tmp_path / "j.ckpt")), tload(str(tmp_path / "t.ckpt"))
    assert (t["P"], t["T"], t["home_idx"]) == (j["P"], j["T"], j["home_idx"])
    for k in ("A", "bias"):
        assert _rel(t["params"][k], j["params"][k]) <= 1e-5


def test_train_crf_logs_the_epoch_mean_of_its_batch_nlls(tmp_path, capsys):
    """Three batches an epoch: the logged train_nll is the mean of the
    three batches' NLLs, each taken before its own step (a replay of the
    epoch by hand: the same generators, permutation and AdamW)."""
    import json

    from ananke_abm_tpu_torch.utils.seed import generator

    paths, meta = _crf_files(tmp_path)
    capsys.readouterr()
    ttrain_crf({"train_npz": paths["train"], "val_npz": paths["val"],
                "meta_json": meta, "save_path": str(tmp_path / "c.ckpt"),
                "num_epochs": 2, "batch_size": 8, "lr": 1e-1,
                "weight_decay": 1e-4, "log_every": 1}, seed=5, device="cpu")
    logged = [json.loads(line)["train_nll"]
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    with np.load(paths["train"]) as d:
        U, Y = _t(d["U"]), _t(d["Y"])
    params = tcrf_model.init_crf_params(generator("cpu", 5), 7)
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.AdamW(list(params.values()), lr=1e-1,
                            weight_decay=1e-4)
    want = []
    for epoch in (1, 2):
        perm = torch.randperm(24, generator=generator("cpu", 5, epoch))
        losses = []
        for i in range(3):
            bidx = perm[i * 8:(i + 1) * 8]
            opt.zero_grad()
            loss = tcrf_model.crf_nll_loss(params, U[bidx], Y[bidx])
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert len(set(losses)) == 3
        want.append(float(np.mean(np.float32(losses))))
    np.testing.assert_allclose(logged, want, rtol=1e-6)


def test_train_crf_drops_the_remainder_and_keeps_the_best(tmp_path):
    paths, meta = _crf_files(tmp_path, n_train=25)
    save = str(tmp_path / "c.ckpt")
    res = ttrain_crf({"crf": {
        "train_npz": paths["train"], "val_npz": paths["val"],
        "meta_json": meta, "save_path": save, "num_epochs": 3,
        "batch_size": 8, "lr": 1e-2, "weight_decay": 0.0}}, seed=3,
        device="cpu")
    ck = tload(save)
    assert np.isfinite(res["best_val_nll"])
    assert ck["params"]["A"].shape == (7, 7) and ck["params"]["A"].dtype \
        == np.float32
    # the saved parameters give the best validation NLL reported
    with np.load(paths["val"]) as v:
        nll = tcrf_model.crf_nll_loss(
            {k: _t(a) for k, a in ck["params"].items()}, _t(v["U"]),
            _t(v["Y"]))
    np.testing.assert_allclose(float(nll), res["best_val_nll"], rtol=1e-6)
    # the same run under a (one-rank) mesh: the same best NLL
    with one_rank_mesh(tmp_path) as mesh:
        sharded = ttrain_crf({"crf": {
            "train_npz": paths["train"], "val_npz": paths["val"],
            "meta_json": meta, "save_path": str(tmp_path / "m.ckpt"),
            "num_epochs": 3, "batch_size": 8, "lr": 1e-2,
            "weight_decay": 0.0}}, seed=3, device="cpu", mesh=mesh)
    np.testing.assert_allclose(sharded["best_val_nll"], res["best_val_nll"],
                               rtol=1e-6)
