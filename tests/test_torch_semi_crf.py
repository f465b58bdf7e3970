"""The port's semi-Markov CRF (``ananke_abm_tpu_torch/ops/semi_crf.py``)
against the JAX package's ``ananke_abm_tpu/ops/semi_crf.py`` on the same
seeded inputs, on the CPU at float32: the five functions (rtol 1e-5), the
NLL's gradients against ``jax.grad`` (rtol 1e-4) and the decoded labels
exactly, ties included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.ops import semi_crf as jsc
from ananke_abm_tpu_torch.ops import semi_crf as tsc

# jitted, so that each shape compiles once across the seeds
J_LOGZ = jax.jit(jsc.semicrf_log_partition, static_argnums=3)
J_PATH = jax.jit(jsc.semicrf_path_score)
J_GOLD = jax.jit(jsc.semicrf_gold_log_marginal)
J_DECODE = jax.jit(jsc.semicrf_decode, static_argnums=3)

# (B, T, P, D)
SHAPES = [(4, 12, 4, 4), (3, 9, 3, 2), (2, 12, 4, 1), (1, 5, 2, 4)]


def _inputs(seed, B, T, P, D, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # small integers: many segmentations score exactly the same
        U = rng.integers(0, 2, (B, T, P)).astype(np.float32)
        A = rng.integers(-1, 2, (P, P)).astype(np.float32)
        dur = np.zeros((P, D), np.float32)
    else:
        U = rng.standard_normal((B, T, P)).astype(np.float32)
        A = (0.5 * rng.standard_normal((P, P))).astype(np.float32)
        dur = (0.5 * rng.standard_normal((P, D))).astype(np.float32)
    # gold grids with runs both shorter and longer than D
    runs = rng.integers(1, 2 * D + 2, (B, T))
    y = np.zeros((B, T), np.int32)
    for b in range(B):
        t, p = 0, int(rng.integers(0, P))
        while t < T:
            y[b, t:t + runs[b, t]] = p
            t += runs[b, t]
            p = (p + 1 + int(rng.integers(0, max(P - 1, 1)))) % P
    return U, y, dur, A


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=rtol * max(
                                   1.0, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_scores_match_jax(shape, seed):
    U, y, dur, A = map(jnp.asarray, _inputs(seed, *shape))
    for allow_self in (False, True):
        _close(tsc.semicrf_log_partition(_t(U), _t(dur), _t(A), allow_self),
               J_LOGZ(U, dur, A, allow_self), 1e-5)
    _close(tsc.semicrf_path_score(_t(U), _t(y), _t(dur), _t(A)),
           J_PATH(U, y, dur, A), 1e-5)
    _close(tsc.semicrf_gold_log_marginal(_t(U), _t(y), _t(dur), _t(A)),
           J_GOLD(U, y, dur, A), 1e-5)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("exact_long", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_nll_and_its_gradients_match_jax_grad(shape, exact_long, masked):
    U, y, dur, A = map(jnp.asarray, _inputs(7, *shape))
    mask = jnp.asarray(np.arange(shape[0]) % 3 != 1, jnp.float32) if masked \
        else None

    def jloss(U, dur, A):
        return jsc.semicrf_nll(U, y, dur, A, mask_b=mask,
                               exact_long=exact_long)

    want, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        U, dur, A)
    tU, tdur, tA = (_t(a).requires_grad_(True) for a in (U, dur, A))
    got = tsc.semicrf_nll(tU, _t(y), tdur, tA,
                          mask_b=None if mask is None else _t(mask),
                          exact_long=exact_long)
    _close(got, want, 1e-5)
    got.backward()
    for name, g, w in zip(("unaries", "dur", "A"), (tU, tdur, tA), jg):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(w))),
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("allow_self", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_decode_labels_equal_jax(seed, allow_self, ties):
    """Equal labels, exactly: with ``ties`` the unaries and transitions
    are small integers, so many paths tie and every max must pick the
    first index, as ``jnp.argmax`` does; the NEG_INF + A entries of the
    masked diagonal tie in float32 too."""
    for shape in SHAPES:
        U, _, dur, A = map(jnp.asarray, _inputs(seed, *shape, ties=ties))
        want = np.asarray(J_DECODE(U, dur, A, allow_self))
        got = tsc.semicrf_decode(_t(U), _t(dur), _t(A), allow_self)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(shape))


def test_first_index_ties_in_the_predecessor_max():
    """-1e30 + a rounds to -1e30 in float32: every predecessor of an
    empty ring ties, and torch.max must return the first, as JAX does."""
    ring = torch.full((3,), tsc.NEG_INF) + torch.tensor([0.5, -0.25, 0.125])
    assert torch.unique(ring).numel() == 1
    assert int(torch.max(ring, 0).indices) == 0
    assert int(torch.argmax(ring)) == 0 == int(jnp.argmax(jnp.asarray(
        ring.numpy())))


def test_decode_without_self_keeps_runs_within_dmax():
    U, _, dur, A = _inputs(5, 4, 12, 3, 2)
    U[:, :, 0] += 5.0  # purpose 0 everywhere would be best without the cap
    labels = tsc.semicrf_decode(_t(U), _t(dur), _t(A)).numpy()
    for row in labels:
        run = 1
        for a, b in zip(row[:-1], row[1:]):
            run = run + 1 if a == b else 1
            assert run <= 2
