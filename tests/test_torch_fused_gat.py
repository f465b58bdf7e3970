"""The zone-encoder kernels' plain versions (``ops/cuda/fused_gat.py``, K4f
/ K4b on the card) against the JAX package's ``zone_gat_fused`` run in
interpret mode, on the same zone graph and flax parameters.

Bounds are the JAX tests' own for its kernel against flax
(tests/test_ops_kernels.py ``TestFusedZoneGAT``): the output within rtol =
atol = 2e-5; the parameter gradients at cosine > 1 - 1e-6 and within rtol
1e-4, atol 1e-5. Both sides compute ``_gat_math`` in float32 with the sums
in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.models.gnn_embed.gat import ZoneGAT as JaxZoneGAT
from ananke_abm_tpu.ops.pallas import fused_gat as jfg
from ananke_abm_tpu_torch.models.gnn_embed.gat import ZoneGAT
from ananke_abm_tpu_torch.ops.cuda import fused_gat as fg

NARROW = dict(Z=37, F=7, feat=16, heads=2)
FULL = dict(Z=64, F=7, feat=64, heads=4)
CASES = [
    pytest.param(dict(NARROW, num_layers=1), id="narrow-1layer"),
    pytest.param(dict(NARROW, num_layers=2), id="narrow-2layers"),
    pytest.param(dict(FULL, num_layers=2), id="full-2layers"),
    pytest.param(dict(NARROW, num_layers=1, isolated=5),
                 id="narrow-isolated-row"),
    pytest.param(dict(FULL, num_layers=2, isolated=0),
                 id="full-isolated-row"),
    # the graphs the kernels' walks over a row's entries must get right, at
    # a Z that is not a multiple of 32: a row of more than 32 entries, a row
    # whose only entry is its self loop and a row with no entry
    pytest.param(dict(FULL, Z=70, num_layers=2, walk=True),
                 id="full-long-self-and-empty-rows"),
    pytest.param(dict(NARROW, Z=70, num_layers=1, walk=True),
                 id="narrow-long-self-and-empty-rows"),
]


def _setup(Z, F, feat, heads, num_layers, isolated=None, walk=False,
           seed=0):
    """Zone features, adjacency (self loops; row ``isolated`` zeroed; with
    ``walk``, row 0 on at its first 40 columns, row 1 at its self loop
    alone and row 2 at none), the flax parameters and the port's module
    holding them."""
    rng = np.random.default_rng(seed)
    zf = rng.normal(size=(Z, F)).astype(np.float32)
    adj = (rng.uniform(size=(Z, Z)) < 0.3).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    if isolated is not None:
        adj[isolated] = 0.0
    if walk:
        adj[0, :40] = 1.0
        adj[1] = 0.0
        adj[1, 1] = 1.0
        adj[2] = 0.0
    gat = JaxZoneGAT(features=feat, heads=heads, num_layers=num_layers)
    gp = gat.init(jax.random.PRNGKey(seed), jnp.asarray(zf),
                  jnp.asarray(adj))["params"]
    module = ZoneGAT(F, feat, heads, num_layers, device="cpu")
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    with torch.no_grad():
        module.inp.weight.copy_(t(gp["Dense_0"]["kernel"]).T)
        module.inp.bias.copy_(t(gp["Dense_0"]["bias"]))
        for k, (layer, norm) in enumerate(zip(module.layers, module.norms)):
            g = gp[f"GATLayer_{k}"]
            layer.proj.weight.copy_(t(g["Dense_0"]["kernel"]).T)
            layer.a_src.copy_(t(g["a_src"]))
            layer.a_dst.copy_(t(g["a_dst"]))
            norm.weight.copy_(t(gp[f"LayerNorm_{k}"]["scale"]))
            norm.bias.copy_(t(gp[f"LayerNorm_{k}"]["bias"]))
    return zf, adj, gp, module, t(zf), t(adj)


def _jax_fused(zf, adj, gp, heads, num_layers):
    return jfg.zone_gat_fused(jnp.asarray(zf), jnp.asarray(adj), gp,
                              heads=heads, num_layers=num_layers,
                              interpret=True)


def _flat_grads(module):
    """The module's gradients in flatten_gat_params' order and shapes."""
    flat = [module.inp.weight.grad.T, module.inp.bias.grad]
    for layer, norm in zip(module.layers, module.norms):
        flat.append(layer.proj.weight.grad.T)
        flat += [layer.a_src.grad[h:h + 1] for h in range(layer.heads)]
        flat += [layer.a_dst.grad[h:h + 1] for h in range(layer.heads)]
        flat += [norm.weight.grad, norm.bias.grad]
    return flat


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_interpret(case):
    zf, adj, gp, module, tzf, tadj = _setup(**case)
    heads, num_layers = case["heads"], case["num_layers"]
    want = np.asarray(_jax_fused(zf, adj, gp, heads, num_layers))
    with torch.no_grad():
        got = fg.zone_gat_fused(tzf, tadj, module, heads=heads,
                                num_layers=num_layers).numpy()
    assert got.shape == (case["Z"], case["feat"])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_parameter_gradients_match_jax_interpret(case):
    zf, adj, gp, module, tzf, tadj = _setup(**case)
    heads, num_layers = case["heads"], case["num_layers"]
    g_tree = jax.grad(lambda p: jnp.sum(jnp.sin(
        _jax_fused(zf, adj, p, heads, num_layers))))(gp)
    want = np.concatenate([np.ravel(np.asarray(g)) for g in
                           jfg.flatten_gat_params(g_tree, num_layers)])
    out = fg.zone_gat_fused(tzf, tadj, module, heads=heads,
                            num_layers=num_layers)
    torch.sin(out).sum().backward()
    got = np.concatenate([g.reshape(-1).numpy()
                          for g in _flat_grads(module)])
    assert got.shape == want.shape
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 1 - 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_zone_feature_and_adjacency_cotangents_are_zero():
    """zone_feats and adj are data: zero cotangents, as _gat_core_bwd."""
    _, _, _, module, tzf, tadj = _setup(**NARROW, num_layers=1)
    tzf.requires_grad_()
    tadj.requires_grad_()
    out = fg.zone_gat_fused(tzf, tadj, module, heads=2, num_layers=1)
    gzf, gadj = torch.autograd.grad(out.sum(), (tzf, tadj))
    assert torch.count_nonzero(gzf) == 0 and torch.count_nonzero(gadj) == 0


def test_flat_interface_matches_the_module_and_its_backward():
    """gat_forward_reference on flatten_gat_params is the module path's
    forward; gat_backward_reference is its VJP; the port's own ZoneGAT
    (torch's LayerNorm statistics) agrees to float32 rounding."""
    _, _, _, module, tzf, tadj = _setup(**FULL, num_layers=2, seed=3)
    flat = fg.flatten_gat_params(module)
    out, res = fg.gat_forward_reference(tzf, tadj, flat, 4, 2)
    assert res is None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    grads = fg.gat_backward_reference(tzf, tadj, flat, g, 4, 2)
    assert [tuple(x.shape) for x in grads] == [tuple(w.shape) for w in flat]
    via = fg.zone_gat_fused(tzf, tadj, module, heads=4, num_layers=2)
    (via * g).sum().backward()
    for a, b in zip(grads, _flat_grads(module)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(via.detach(), out.detach(), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(module(tzf, tadj), out.detach(),
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    _, _, _, module, tzf, tadj = _setup(**FULL, num_layers=2)
    flat = tuple(w.detach() for w in fg.flatten_gat_params(module))
    before = (fg.gat_forward_fused.launches, fg.gat_backward_fused.launches)
    out, res = fg.gat_forward_fused(tzf, tadj, flat, 4, 2)
    torch.testing.assert_close(
        out, fg.gat_forward_reference(tzf, tadj, flat, 4, 2)[0],
        rtol=0, atol=0)
    g = torch.ones_like(out)
    for a, b in zip(fg.gat_backward_fused(tzf, tadj, flat, g, 4, 2, res),
                    fg.gat_backward_reference(tzf, tadj, flat, g, 4, 2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fg.gat_forward_fused.launches,
            fg.gat_backward_fused.launches) == before


@pytest.mark.parametrize("bad,match", [
    ("heads", "do not match"), ("layers", "do not match"),
    ("dtype", "float32"), ("shape", "shape"),
])
def test_refusals(bad, match):
    _, _, _, module, tzf, tadj = _setup(**NARROW, num_layers=1)
    flat = tuple(w.detach() for w in fg.flatten_gat_params(module))
    if bad == "heads":
        call = lambda: fg.zone_gat_fused(tzf, tadj, module, heads=4,
                                         num_layers=1)
    elif bad == "layers":
        call = lambda: fg.zone_gat_fused(tzf, tadj, module, heads=2,
                                         num_layers=2)
    elif bad == "dtype":
        call = lambda: fg.gat_forward_fused(tzf.double(), tadj, flat, 2, 1)
    else:
        call = lambda: fg.gat_forward_fused(tzf, tadj[:-1], flat, 2, 1)
    with pytest.raises((ValueError, TypeError), match=match):
        call()


@pytest.mark.parametrize("z,words", [(1, 1), (32, 1), (33, 2), (70, 3),
                                     (500, 16), (16_384, 512)])
def test_fwd_list_words_hold_each_rows_columns(z, words):
    """K4f's lists of the graph's entries, after its 1/std residual: a
    bitmask of ceil(z / 32) words for each row's on-graph columns."""
    assert fg.fwd_list_words(z) == z * words


@pytest.mark.parametrize("z,words", [(1, 1), (32, 1), (33, 2), (500, 16),
                                     (16_384, 512)])
def test_bwd_list_words_hold_both_lists_and_the_rows_of_no_entry(z, words):
    """K4b's scratch for the graph's entries: a bitmask of ceil(z / 32)
    words for each row's columns and for each column's rows, and one
    bitmask of the rows with no entry."""
    assert fg.bwd_list_words(z) == 2 * z * words + words
