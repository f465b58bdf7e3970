"""The port's profiling tools and asynchronous checkpoints against the JAX
package's (``utils/profiling.py``, ``utils/ckpt.py::AsyncCheckpointer``),
on the CPU: the same phase records and JSONL lines, ``throughput``'s keys,
a Chrome trace written, the NaN-check mode in the forward, the backward,
nested and restored, silent on integer and boolean outputs and seeing
K0's plain version, and checkpoints that hold the state at ``save`` and
load in both packages."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ananke_abm_tpu.utils import ckpt as jckpt
from ananke_abm_tpu.utils import profiling as jprof
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    build_model,
    init_params,
)
from ananke_abm_tpu_torch.ops.cuda.fused_step import (
    interval_stage_times,
    pack_weights_bf16,
    rk4_step_fused,
    time_feature_table,
)
from ananke_abm_tpu_torch.utils import ckpt as tckpt
from ananke_abm_tpu_torch.utils import profiling as tprof


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---- PhaseTimes, JsonlLogger, throughput, trace -----------------------------

def test_phase_times_write_the_reference_records(tmp_path):
    recs = []
    for mod in (jprof, tprof):
        pt = mod.PhaseTimes()
        for name in ("load", "step", "step"):
            with pt.phase(name):
                pass
        path = tmp_path / mod.__name__ / "phases.jsonl"
        pt.dump(str(path))
        pt.dump(str(path))  # appends
        recs.append((_jsonl(path), pt.summary()))
    (jl, js), (tl, ts) = recs
    assert [list(r) for r in tl] == [list(r) for r in jl]
    assert [r["phase"] for r in tl] == [r["phase"] for r in jl]
    assert list(ts) == list(js) == ["load", "step"]


def test_jsonl_logger_writes_the_reference_lines(tmp_path):
    """Python, numpy and one-element tensor scalars log as floats (a jnp
    scalar in the reference); strings and other values as they are; a
    tensor of more elements is no float (torch's RuntimeError caught where
    JAX raises TypeError)."""
    jl = jprof.JsonlLogger(str(tmp_path / "j" / "log.jsonl"))
    tl = tprof.JsonlLogger(str(tmp_path / "t" / "log.jsonl"))
    jl.log({"epoch": 3, "loss": jnp.float32(0.25), "acc": np.float64(0.5),
            "tag": "x", "n": np.int64(7)})
    tl.log({"epoch": 3, "loss": torch.tensor(0.25), "acc": np.float64(0.5),
            "tag": "x", "n": np.int64(7)})
    tl.log({"loss": torch.tensor([0.125])})
    assert _jsonl(tmp_path / "t" / "log.jsonl")[0] == \
        _jsonl(tmp_path / "j" / "log.jsonl")[0]
    assert _jsonl(tmp_path / "t" / "log.jsonl")[1] == {"loss": 0.125}
    many = torch.ones(3)
    assert tprof._jsonable(many) is many
    assert jprof._jsonable(jnp.ones(3)).shape == (3,)


def test_throughput_gives_the_reference_keys():
    x = torch.randn(64, 64)
    r = tprof.throughput(lambda a: a @ a, x, items=64, iters=4, warmup=2)
    j = jprof.throughput(jax.jit(lambda a: a @ a), jnp.asarray(x.numpy()),
                         items=64, iters=4, warmup=2)
    assert list(r) == list(j)
    assert all(v > 0 for v in r.values())
    assert r["items_per_s"] == pytest.approx(64 / (r["ms_per_call"] / 1e3))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.randn(32, 32).matmul(torch.randn(32, 32)).sum()
    assert d == str(tmp_path / "tr")
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---- the NaN-check mode -----------------------------------------------------

def _raises_nan(fn):
    try:
        fn()
    except FloatingPointError as e:
        return str(e)
    return None


def test_nan_mode_raises_in_the_forward_as_jax_does():
    with jprof.debug_nan_mode():
        assert _raises_nan(lambda: jnp.log(jnp.float32(-1.0))) is not None
    with tprof.debug_nan_mode():
        msg = _raises_nan(lambda: torch.log(torch.tensor([-1.0, 2.0])))
    assert msg is not None and "log" in msg
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # off again


def test_nan_mode_raises_in_a_backward():
    """A NaN that first appears in a gradient (0 / 0 in sqrt's backward
    at 0, whose forward is finite) raises."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with tprof.debug_nan_mode():
        y = (torch.sqrt(x) * 0).sum()
        assert torch.isfinite(y)
        assert _raises_nan(y.backward) is not None
    y = (torch.sqrt(x) * 0).sum()
    y.backward()  # the mode off: a NaN gradient, no raise
    assert torch.isnan(x.grad).any()


def test_nan_mode_raises_on_the_thread_that_entered_it():
    """The mode entered on a thread of its own checks that thread's
    forward and backward (a CUDA backward, which autograd's engine runs on
    threads of its own, is tests/test_torch_cuda.py's)."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    caught = []

    def run():
        with tprof.debug_nan_mode():
            y = (torch.sqrt(x) * 0).sum()
            caught.append(_raises_nan(y.backward))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert caught and caught[0] is not None


def test_nan_mode_nests_and_restores():
    log = lambda: torch.log(torch.tensor([-1.0]))
    assert _raises_nan(log) is None
    with tprof.debug_nan_mode():
        assert _raises_nan(log) is not None
        with tprof.debug_nan_mode(False):
            assert _raises_nan(log) is None
            with tprof.debug_nan_mode():
                assert _raises_nan(log) is not None
            assert _raises_nan(log) is None
        assert _raises_nan(log) is not None
        with tprof.debug_nan_mode():
            assert _raises_nan(log) is not None
        assert _raises_nan(log) is not None
    assert _raises_nan(log) is None
    with tprof.debug_nan_mode(False):
        assert _raises_nan(log) is None
    assert not tprof._NAN_MODE


def test_nan_mode_checks_floating_outputs_only():
    """An argmax, a mask, integer arithmetic and the allocation of
    unwritten memory do not raise; a NaN input read by a float op does."""
    x = torch.tensor([[1.0, float("nan")], [0.5, 0.25]])
    with tprof.debug_nan_mode():
        ids = torch.argmax(torch.tensor([[1.0, 2.0], [3.0, 0.0]]), dim=1)
        mask = torch.isnan(x)
        n = (torch.arange(5) // 2).sum()
        torch.empty(1 << 16)
        assert ids.tolist() == [1, 0] and mask.sum() == 1 and n == 4
        assert _raises_nan(lambda: x * 2) is not None


def test_check_nan_acts_only_in_the_mode():
    bad = torch.tensor([1.0, float("nan")])
    tprof.check_nan("kernel", bad)  # off: returns at once
    with tprof.debug_nan_mode():
        tprof.check_nan("kernel", torch.ones(3), torch.arange(3))
        with pytest.raises(FloatingPointError, match="kernel"):
            tprof.check_nan("kernel", torch.ones(3), bad)


def _k0_args(n=64, num_zones=12):
    model = build_model(GATODEConfig(num_blocks=2), 7, 8, device="cpu")
    init_params(model, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(0)
    w = pack_weights_bf16(model)
    x = torch.randn(n, 32, generator=g)
    h = torch.randn(n, 32, generator=g)
    ze = torch.randn(num_zones, 64, generator=g).bfloat16()
    tf = time_feature_table(torch.from_numpy(
        interval_stage_times(np.float32(6.5), np.float32(0.125), 1)), w[3],
        w[4])
    return x, h, ze, w, tf, 0.125


def test_nan_mode_sees_k0_plain_version():
    """K0's wrapper on CPU tensors (its plain version) under the mode on a
    state holding one NaN raises before it returns; without the mode it
    returns a state holding NaN; on a finite state the mode changes no
    bit."""
    x, h, ze, w, tf, dt = _k0_args()
    bad = x.clone()
    bad[5, 3] = float("nan")
    with torch.no_grad():
        want = rk4_step_fused(x, h, ze, w, tf, dt)
        with tprof.debug_nan_mode():
            got = rk4_step_fused(x, h, ze, w, tf, dt)
            assert _raises_nan(
                lambda: rk4_step_fused(bad, h, ze, w, tf, dt)) is not None
        assert torch.isnan(rk4_step_fused(bad, h, ze, w, tf, dt)).any()
    assert torch.equal(got, want)
    assert rk4_step_fused.launches == 0


# ---- AsyncCheckpointer ------------------------------------------------------

def test_async_checkpoint_holds_the_state_at_save(tmp_path):
    """save, then an in-place update at once (an optimizer's next step),
    then wait: the file holds the values from before the update, and
    loads in both packages' load_checkpoint."""
    p = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
    arr = np.ones(3)
    ck = tckpt.AsyncCheckpointer()
    path = str(tmp_path / "a.ckpt")
    ck.save({"step": 1, "params": {"w": p}, "moments": [p.detach() * 2],
             "host": arr}, path)
    with torch.no_grad():
        p.add_(100.0)
    arr += 5
    ck.wait()
    for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
        obj = load(path)
        assert obj["step"] == 1
        np.testing.assert_array_equal(obj["params"]["w"], np.arange(6.0))
        np.testing.assert_array_equal(obj["moments"][0], 2 * np.arange(6.0))
        np.testing.assert_array_equal(obj["host"], np.ones(3))
    assert not os.path.exists(path + ".tmp")


def test_async_checkpoints_cross_both_ways(tmp_path):
    """Three saves in a row (each waits for the last), as the reference's
    test; the JAX package's AsyncCheckpointer's file loads in the port."""
    ck = tckpt.AsyncCheckpointer()
    p = str(tmp_path / "t.ckpt")
    for step in range(3):
        ck.save({"step": step, "x": torch.ones(4) * step}, p)
    ck.wait()
    obj = jckpt.load_checkpoint(p)
    assert obj["step"] == 2
    np.testing.assert_array_equal(obj["x"], np.ones(4) * 2)
    jck = jckpt.AsyncCheckpointer()
    q = str(tmp_path / "j.ckpt")
    jck.save({"step": 5, "x": jnp.arange(3.0)}, q)
    jck.wait()
    obj = tckpt.load_checkpoint(q)
    assert obj["step"] == 5
    np.testing.assert_array_equal(obj["x"], np.arange(3.0))


def test_package_reexports_match_the_reference():
    """``utils`` and ``ops`` re-export the reference's names; importing
    ``ops`` imports nothing of ``ops.cuda``."""
    import subprocess
    import sys

    import ananke_abm_tpu.ops as jops
    import ananke_abm_tpu.utils as jutils
    import ananke_abm_tpu_torch.ops as tops
    import ananke_abm_tpu_torch.utils as tutils

    assert tutils.__all__ == jutils.__all__
    assert tops.__all__ == jops.__all__
    assert all(callable(getattr(tutils, n)) for n in tutils.__all__)
    assert all(callable(getattr(tops, n)) for n in tops.__all__)
    assert isinstance(tutils.set_seed(3), torch.Generator)
    code = ("import sys, ananke_abm_tpu_torch.ops, ananke_abm_tpu_torch.utils;"
            "print(sorted(m for m in sys.modules if 'ops.cuda' in m))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
