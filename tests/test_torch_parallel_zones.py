"""The port's parallel layer on a 4-rank gloo mesh (2 agents x 2 zones) on
the CPU: the ring zone encoder against ``encode_zones`` of both packages,
the plain step with its logits tiled over the zone axis (and with the ring
encoder inside), the fused step and the kernel rollout on a 2-D mesh.

One group of ranks (``_torch_parallel_worker.py``, suite ``zones``) runs
every case of this file once; each test reads its case's results."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as w
from ananke_abm_tpu.models.gnn_embed import train as jtrain
from ananke_abm_tpu_torch.models.gnn_embed.params import to_flax_params
from test_torch_parallel import (
    _cos,
    assert_grads_close,
    _single_fused,
    _single_rollouts,
    _single_step,
)

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_group("zones", WORLD, str(tmp_path_factory.mktemp("zones")))


def test_two_by_two_mesh(ranks):
    for rank, r in enumerate(ranks):
        assert list(r["mesh_api/mesh_shape"]) == [2, 2]
        assert list(r["mesh_api/default_zone_parallel"]) == [2, 2]
        assert int(r["mesh_api/zone_rank"]) == rank % 2
        # the ranks of one zone group hold the same rows
        x = np.arange(WORLD * 6, dtype=np.float32).reshape(-1, 2)
        a = rank // 2
        np.testing.assert_array_equal(r["mesh_api/shard_local"],
                                      x[6 * a:6 * a + 6])


@pytest.mark.parametrize("z", [8, 12])
def test_ring_encoder_matches_encode_zones(ranks, z):
    cfg, data, model = w.gatode(seed=4, num_zones=z, gat_layers=2)
    zf, adj, _ = w.static_of(data)
    with torch.no_grad():
        dense = model.encode_zones(zf, adj).numpy()
    jcfg = jtrain.GATODEConfig(**dataclasses.asdict(cfg))
    jmodel = jtrain.build_model(jcfg, zf.shape[1],
                                data["person_feats"].shape[-1])
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(model))
    jdense = np.asarray(jmodel.apply({"params": params}, jnp.asarray(
        data["zone_features"]), jnp.asarray(data["adj"]),
        method=jmodel.encode_zones))
    for r in ranks:
        np.testing.assert_allclose(r[f"ring_encoder/z{z}"], dense,
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(r[f"ring_encoder/z{z}"], jdense,
                                   rtol=2e-5, atol=2e-6)


def test_ring_refuses_an_indivisible_zone_count(ranks):
    assert str(ranks[0]["ring_encoder/indivisible"]) == \
        "Z=5 not divisible by zones=2"


@pytest.mark.parametrize("case", ["step_rk4", "step_ring"])
def test_zone_tiled_step_is_the_single_device_step(ranks, case):
    _, _, loss, acc, upd, _, grads = _single_step("rk4")
    for r in ranks:
        assert_grads_close(r[f"{case}/grads"], grads)
        np.testing.assert_allclose(r[f"{case}/loss"], loss, rtol=1e-4)
        assert abs(r[f"{case}/acc"] - acc) < 1e-6
        assert _cos(r[f"{case}/update"], upd) > 0.999
        np.testing.assert_allclose(r[f"{case}/update"], upd, rtol=1e-3,
                                   atol=1e-6)


def test_fused_step_on_a_2d_mesh(ranks):
    _, _, out, model = _single_fused()
    for r in ranks:
        assert_grads_close(r["fused/grads"], w.flat_grads(model))
        np.testing.assert_allclose(r["fused/loss"], [float(l) for l, _ in out],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["fused/acc"], [float(a) for _, a in out],
                                   atol=1e-6)


def test_rollouts_on_a_2d_mesh(ranks):
    *_, want = _single_rollouts()
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(r[f"rollouts/{k}"], v.numpy(),
                                          err_msg=k)
