"""The training-day kernels' plain versions (the port on the CPU) against
the JAX package's Pallas kernels in interpret mode, on the same inputs made
with numpy: ``rk4_day_rollout`` (K2f/K2b) and ``decode_ce`` (K3f/K3b).

Both sides round at the same bf16 points and sum in float32 in other
orders, so they agree to bf16 accuracy, not bit for bit. The problem and
the bounds are tests/test_fused_train.py's (N=40, Da 8, Dz 16, Z 12, H 16,
Hc 8, T 4, substeps 2; gradient cosine > 0.999; nll relative < 1e-2 and
correct agreement > 0.97 for the decode), with the day's states held
tighter: max |dxs| / max |xs| < 2e-3 (the same arithmetic on both sides,
where the JAX test bounds bf16 against float32 at 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.ops.pallas import fused_train as jft
from ananke_abm_tpu_torch.ops.cuda import fused_train as tft

N, Da, Dz, Z, H, Hc, T, S = 40, 8, 16, 12, 16, 8, 4, 2
NAMES = "x0 h ze W1 b1 Wq blocks W3 b3".split()


def _problem(n_blocks, n=N):
    rng = np.random.default_rng(n_blocks)
    r = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    args = [r(n, Da), r(n, Hc), r(Z, Dz), r(Da + Dz + Hc + 2, H), r(H),
            r(Da, Dz),
            tuple((r(H, H), r(H), r(H, H), r(H))
                  for _ in range(n_blocks)),
            r(H, Da), r(Da)]
    times = np.linspace(0.0, 2.0, T).astype(np.float32)
    tgt = rng.standard_normal((T, n, Da)).astype(np.float32)
    return args, times, tgt


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v)) for v in
                           jax.tree_util.tree_leaves(tree)])


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_loss(args, times, tgt):
    def loss(*a):
        xs = jft.rk4_day_rollout(*a, jnp.asarray(times), substeps=S,
                                 interpret=True)
        return jnp.mean((xs - tgt) ** 2), xs

    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    (_, xs), g = jax.value_and_grad(loss, argnums=tuple(range(9)),
                                    has_aux=True)(*jargs)
    return np.asarray(xs), g


def _port_loss(args, times, tgt):
    targs = [torch.tensor(a, requires_grad=True) for a in args[:6]]
    tblocks = [[torch.tensor(w, requires_grad=True) for w in b]
               for b in args[6]]
    tw3, tb3 = (torch.tensor(a, requires_grad=True) for a in args[7:])
    xs = tft.rk4_day_rollout(*targs, tuple(tuple(b) for b in tblocks), tw3,
                             tb3, torch.tensor(times), substeps=S)
    torch.mean((xs - torch.tensor(tgt)) ** 2).backward()
    grads = [t.grad.numpy() for t in targs]
    grads.append([[w.grad.numpy() for w in b] for b in tblocks])
    grads += [tw3.grad.numpy(), tb3.grad.numpy()]
    return xs.detach().numpy(), grads


@pytest.fixture(scope="module", params=[1, 2])
def day(request):
    args, times, tgt = _problem(request.param)
    return _jax_loss(args, times, tgt), _port_loss(args, times, tgt)


def test_day_rollout_matches_pallas_interpret(day):
    (xs_j, _), (xs_t, _) = day
    assert xs_t.shape == (T, N, Da)
    np.testing.assert_array_equal(xs_t[0], xs_j[0])  # row 0 is x0
    rel = np.abs(xs_t - xs_j).max() / np.abs(xs_j).max()
    assert rel < 2e-3, rel


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_day_rollout_gradients_match_pallas_interpret(day, i):
    (_, g_j), (_, g_t) = day
    cos = _cos(_flat(g_t[i]), _flat(g_j[i]))
    assert cos > 0.999, (NAMES[i], cos)


def test_day_rollout_gradients_off_the_tile_grid():
    """N = 70 is a multiple of neither the CUDA kernels' 64-row tiles nor
    the Pallas kernels' tiles: finite gradients of the right shapes."""
    args, times, tgt = _problem(1, n=70)
    xs, grads = _port_loss(args, times, tgt)
    assert xs.shape == (T, 70, Da)
    assert grads[0].shape == (70, Da) and grads[1].shape == (70, Hc)
    assert all(np.isfinite(_flat(g)).all() for g in grads)


def test_stage_times_table_matches_jax():
    rng = np.random.default_rng(5)
    times = np.sort(rng.uniform(0, 24, 6)).astype(np.float32)
    W1t = rng.standard_normal((2, H)).astype(np.float32)
    b1 = rng.standard_normal(H).astype(np.float32)
    dts_j, tf_j = jft._stage_times_table(jnp.asarray(times), 3,
                                         jnp.asarray(W1t), jnp.asarray(b1))
    dts_t, tf_t = tft.stage_times_table(torch.tensor(times), 3,
                                        torch.tensor(W1t), torch.tensor(b1))
    assert tf_t.shape == (15, 4, H)
    np.testing.assert_allclose(dts_t.numpy(), np.asarray(dts_j), rtol=1e-6)
    np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j), rtol=1e-5,
                               atol=1e-5)


M, Z2 = 50, 12


@pytest.fixture(scope="module")
def ce():
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((M, Da)).astype(np.float32)
    Wd = (0.4 * rng.standard_normal((Da, Dz))).astype(np.float32)
    ze = (0.4 * rng.standard_normal((Z2, Dz))).astype(np.float32)
    tgt = rng.integers(0, Z2, M).astype(np.int32)

    def jloss(r, w, z):
        nll, corr = jft.decode_ce(r, jnp.asarray(tgt), w, z, interpret=True)
        return jnp.mean(nll), (nll, corr)

    (_, (nll_j, corr_j)), g_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(rows), jnp.asarray(Wd), jnp.asarray(ze))
    t = [torch.tensor(a, requires_grad=True) for a in (rows, Wd, ze)]
    nll_t, corr_t = tft.decode_ce(t[0], torch.tensor(tgt), t[1], t[2])
    nll_t.mean().backward()
    return ((np.asarray(nll_j), np.asarray(corr_j), g_j),
            (nll_t.detach().numpy(), corr_t.numpy(),
             [a.grad.numpy() for a in t]))


def test_decode_ce_matches_pallas_interpret(ce):
    (nll_j, corr_j, _), (nll_t, corr_t, _) = ce
    assert nll_t.shape == (M,) and corr_t.dtype == np.int32
    assert np.abs(nll_t - nll_j).max() / np.abs(nll_j).max() < 1e-2
    assert np.mean(corr_t == corr_j) > 0.97


@pytest.mark.parametrize("i,name", enumerate(["rows", "Wd", "ze"]))
def test_decode_ce_gradients_match_pallas_interpret(ce, i, name):
    (_, _, g_j), (_, _, g_t) = ce
    cos = _cos(np.ravel(g_t[i]), np.ravel(np.asarray(g_j[i])))
    assert cos > 0.999, (name, cos)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    args, times, _ = _problem(1)
    before = (tft.day_forward_fused.launches, tft.day_backward_fused.launches,
              tft.ce_forward_fused.launches, tft.ce_backward_fused.launches)
    _port_loss(args, times, np.zeros((T, N, Da), np.float32))
    after = (tft.day_forward_fused.launches, tft.day_backward_fused.launches,
             tft.ce_forward_fused.launches, tft.ce_backward_fused.launches)
    assert after == before


def test_wrappers_check_their_operands():
    rows = torch.zeros(4, Da)
    wd = torch.zeros(Da, Dz, dtype=torch.bfloat16)
    ze = torch.zeros(Z2, Dz, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="targets"):
        tft.ce_forward_fused(rows, torch.zeros(4, dtype=torch.long), wd, ze)
    with pytest.raises(ValueError, match="shape"):
        tft.ce_backward_fused(rows, torch.zeros(4, dtype=torch.int32), wd,
                              ze, torch.zeros(5))
