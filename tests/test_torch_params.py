"""Port parameters: the flax tree <-> torch bridge, bf16 weight packing
and the flax-style initialiser."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import bf16_bits, make_pair
from ananke_abm_tpu.ops.pallas.fused_step import (
    pack_weights_bf16 as jax_pack,
)
from ananke_abm_tpu_torch.models.gnn_embed.params import (
    load_flax_params,
    to_flax_params,
)
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    build_model,
    init_params,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import pack_weights_bf16


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


@pytest.mark.parametrize("num_blocks", [0, 1, 2])
def test_flax_roundtrip_is_bit_identical(num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=16)
    src, back = _leaves(pair.params), _leaves(to_flax_params(pair.tmodel))
    assert src.keys() == back.keys()
    for k, v in src.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        assert back[k].dtype == np.float32


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_pack_weights_bf16_matches_jax_bit_for_bit(num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=16)
    got = jax.tree_util.tree_leaves(
        pack_weights_bf16(pair.tmodel),
        is_leaf=lambda x: isinstance(x, torch.Tensor),
    )
    want = jax.tree_util.tree_leaves(jax_pack(pair.params))
    assert len(got) == len(want) == 5 + 4 * num_blocks + 2
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(bf16_bits(g), bf16_bits(w))


def test_pack_weights_rejects_blockless_drift():
    pair = make_pair(num_blocks=0, n_agents=16)
    with pytest.raises(ValueError, match="num_blocks"):
        pack_weights_bf16(pair.tmodel)


@pytest.mark.parametrize("full", [False, True])
def test_init_params_has_the_flax_names_and_shapes(full):
    pair = make_pair(num_blocks=2, n_agents=16, full=full)
    model = build_model(pair.tcfg, 7, 8, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    want = {k: np.shape(v) for k, v in _leaves(pair.params).items()}
    got = {k: np.shape(v) for k, v in _leaves(to_flax_params(model)).items()}
    assert got == want


def test_init_params_follows_flax_initialisers():
    model = build_model(GATODEConfig(), 7, 8, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    tree = to_flax_params(model)
    # lecun-normal kernels: std sqrt(1/fan_in), truncated at 2 std
    k = tree["drift"]["Dense_1"]["kernel"]
    std = np.sqrt(1.0 / k.shape[0])
    assert abs(k.std() / std - 1.0) < 0.05
    assert np.abs(k).max() <= 2 * std / 0.87962566103423978 + 1e-6
    for layer in ("Dense_0", "Dense_1", "Dense_5"):
        assert not tree["drift"][layer]["bias"].any()
    gat = tree["zone_gat"]
    for k in ("GATLayer_0", "GATLayer_1"):
        a = gat[k]["a_src"]
        limit = np.sqrt(6.0 / sum(a.shape))
        assert np.abs(a).max() <= limit and a.std() > limit / 4
    np.testing.assert_array_equal(gat["LayerNorm_0"]["scale"], 1.0)
    np.testing.assert_array_equal(gat["LayerNorm_1"]["bias"], 0.0)
    # the same generator seed gives the same weights
    again = build_model(GATODEConfig(), 7, 8, device="cpu")
    init_params(again, torch.Generator().manual_seed(0))
    for (ka, a), (kb, b) in zip(_leaves(tree).items(),
                                _leaves(to_flax_params(again)).items()):
        np.testing.assert_array_equal(a, b, err_msg=ka)


def test_shipping_config_parameter_count_matches_jax():
    pair = make_pair(num_blocks=2, n_agents=16, full=True)
    n_jax = sum(np.size(v) for v in _leaves(pair.params).values())
    n_port = sum(p.numel() for p in pair.tmodel.parameters())
    assert n_port == n_jax == 108_640


def test_load_flax_params_rejects_mismatched_trees():
    pair = make_pair(num_blocks=1, n_agents=16)
    tree = to_flax_params(pair.tmodel)
    missing = to_flax_params(pair.tmodel)
    del missing["drift"]["Dense_1"]["bias"]
    with pytest.raises(KeyError, match="drift/Dense_1/bias"):
        load_flax_params(pair.tmodel, missing)
    wrong = to_flax_params(pair.tmodel)
    wrong["query_proj"]["kernel"] = wrong["query_proj"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="query_proj/kernel"):
        load_flax_params(pair.tmodel, wrong)
    extra = to_flax_params(pair.tmodel)
    extra["drift"]["Dense_9"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="Dense_9"):
        load_flax_params(pair.tmodel, extra)
    load_flax_params(pair.tmodel, tree)  # the untouched tree still loads
