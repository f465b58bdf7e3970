"""The segment sum (kernel K9e): the port's plain version against the JAX
Pallas kernel ``segment_sum_pallas`` run in interpret mode, the person-zone
segment sum against ``jax.ops.segment_sum`` with dropped ids, and the
wrapper's CPU dispatch.

Both sides round every value to bf16 and sum in float32, in other orders:
max |d| / max |ref| within 1e-5 (the JAX tests' 2e-2 against XLA's float32
sum is the rounding itself). Ids outside ``[0, num_segments)``, negative
ones included, are dropped on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t32, tlong
from ananke_abm_tpu.ops.pallas.edge_segment import segment_sum_pallas
from ananke_abm_tpu.ops.segment import (
    person_zone_segment_sum as jax_person_zone_segment_sum,
)
from ananke_abm_tpu_torch.ops.cuda.edge_segment import (
    MAX_SEGMENT_FEATURES,
    segment_chunks,
    segment_sum,
    segment_sum_fits,
    segment_sum_reference,
)
from ananke_abm_tpu_torch.ops.segment import person_zone_segment_sum

REL = 1e-5


def _case(kind, seed):
    """(values, ids, num_segments) of a case: ``in_range`` ids in [0, Z);
    ``dropped`` some ids >= Z and some negative; ``empty`` ids that leave
    most segments empty."""
    rng = np.random.default_rng(seed)
    e, d, z = {"in_range": (3000, 32, 100), "dropped": (2500, 16, 64),
               "empty": (700, 8, 300)}[kind]
    vals = rng.normal(size=(e, d)).astype(np.float32)
    ids = rng.integers(0, z, e).astype(np.int32)
    if kind == "dropped":
        ids[::7] = z + rng.integers(0, 50, ids[::7].shape)
        ids[3::11] = -1 - rng.integers(0, 5, ids[3::11].shape)
    if kind == "empty":
        ids = (ids % 10) * 29
    return vals, ids, z


@pytest.mark.parametrize("kind", ["in_range", "dropped", "empty"])
def test_reference_matches_segment_sum_pallas(kind):
    vals, ids, z = _case(kind, seed=1)
    want = np.asarray(segment_sum_pallas(jnp.asarray(vals),
                                         jnp.asarray(ids), z,
                                         interpret=True))
    got = segment_sum_reference(t32(vals), torch.as_tensor(ids), z).numpy()
    assert got.shape == want.shape == (z, vals.shape[1])
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / np.abs(want).max() <= REL
    kept = (ids >= 0) & (ids < z)
    empty = np.setdiff1d(np.arange(z), ids[kept])
    assert len(empty) > 0 or kind != "empty"
    assert (got[empty] == 0).all() and (want[empty] == 0).all()


def test_reference_rounds_values_to_bf16():
    """The sum is of bf16-rounded values: a value off the bf16 grid sums to
    its rounding, not to itself."""
    vals = torch.tensor([[1.0 + 2 ** -12], [3.0]])
    out = segment_sum_reference(vals, torch.tensor([0, 0]), 1)
    assert out.item() == 4.0


def test_person_zone_segment_sum_drops_negative_ids():
    """The repaired fault: a negative zone id is dropped, as
    ``jax.ops.segment_sum`` drops it, not read from the end."""
    values = np.arange(8, dtype=np.float32).reshape(4, 2)
    ids = np.asarray([0, -1, 2, 5], np.int32)
    want = np.asarray(jax_person_zone_segment_sum(
        jnp.asarray(values), jnp.asarray(ids), 3))
    got = person_zone_segment_sum(t32(values), tlong(ids), 3).numpy()
    np.testing.assert_array_equal(got, [[0, 1], [0, 0], [4, 5]])
    np.testing.assert_array_equal(got, want)


def test_person_zone_segment_sum_matches_jax_with_dropped_ids():
    vals, ids, z = _case("dropped", seed=2)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), num_segments=z))
    got = person_zone_segment_sum(t32(vals), tlong(ids), z).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    vals, ids, z = _case("dropped", seed=3)
    for dtype in (torch.int32, torch.int64):
        got = segment_sum(t32(vals), torch.as_tensor(ids).to(dtype), z)
        want = segment_sum_reference(t32(vals), torch.as_tensor(ids), z)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert segment_sum.launches == 0


def test_wrapper_rejects_bad_operands():
    vals = torch.zeros(6, 4)
    ids = torch.zeros(6, dtype=torch.long)
    with pytest.raises(ValueError, match="6 ids"):
        segment_sum(vals[:5], ids, 3)
    with pytest.raises(TypeError, match="float32"):
        segment_sum(vals.double(), ids, 3)
    with pytest.raises(TypeError, match="integers"):
        segment_sum(vals, ids.float(), 3)
    with pytest.raises(ValueError, match="num_segments"):
        segment_sum(vals, ids, 0)
    with pytest.raises(ValueError, match=r"\(E, D\)"):
        segment_sum(vals[:, 0], ids, 3)
    with pytest.raises(ValueError, match="meta"):
        segment_sum(vals.to("meta"), ids.to("meta"), 3)


def test_predicate_and_chunks():
    assert segment_sum_fits(32) and segment_sum_fits(MAX_SEGMENT_FEATURES)
    assert not segment_sum_fits(0)
    assert not segment_sum_fits(MAX_SEGMENT_FEATURES + 1)
    # rung 1's population by zone, rung 2's by BASELINE config 4's zones
    assert segment_chunks(1_048_576, 64, 32) == 264
    assert segment_chunks(32_768, 500, 32) == 16
    # a small sum takes one chunk; never more chunks than rows
    assert segment_chunks(100, 64, 32) == 1
    assert segment_chunks(3, 1, 1) == 1
    # a wide table takes fewer chunks, so the partial sums stay small
    assert segment_chunks(1_048_576, 32_768, 32) == 4
