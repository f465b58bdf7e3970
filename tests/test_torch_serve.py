"""Serving checkpoints across the two packages, and the port's freedom
from JAX."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import TINY, agreement, make_pair
from ananke_abm_tpu.models.gnn_embed.train import serve as jax_serve
from ananke_abm_tpu.utils import save_checkpoint as jax_save
from ananke_abm_tpu_torch.device import resolve_device
from ananke_abm_tpu_torch.models.gnn_embed.params import to_flax_params
from ananke_abm_tpu_torch.models.gnn_embed.train import (
    GATODEConfig,
    build_model,
    init_params,
    serve,
)
from ananke_abm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ananke_abm_tpu_torch"
F32_IDS_MIN = 0.999
WORLD = dict(num_zones=12, num_times=10)


def _ckpt_dict(params, config, world_seed=0):
    """The keys ``ananke_abm_tpu...train.train()`` writes to
    gatode_best.ckpt."""
    return {
        "params": params,
        "config": dataclasses.asdict(config),
        "num_zones": WORLD["num_zones"],
        "num_times": WORLD["num_times"],
        "history": [{"epoch": 1, "loss": 1.0, "acc": 0.5}],
        "world_seed": world_seed,
        "sparse_world": False,
    }


def _port_ckpt(path, num_blocks=1, **ck_overrides):
    config = GATODEConfig(num_blocks=num_blocks, **TINY)
    model = build_model(config, 7, 8, device="cpu")
    init_params(model, torch.Generator().manual_seed(3))
    ck = {**_ckpt_dict(to_flax_params(model), config), **ck_overrides}
    save_checkpoint(ck, str(path))
    return path


def _served(out):
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_jax_checkpoint_is_served_by_both_packages(tmp_path, num_blocks):
    pair = make_pair(num_blocks=num_blocks, n_agents=16,
                     num_zones=WORLD["num_zones"])
    ckpt = tmp_path / "jax.ckpt"
    jax_save(_ckpt_dict(pair.params, pair.jcfg), str(ckpt))
    jax_serve(str(ckpt), str(tmp_path / "jax.npz"), n_agents=128, seed=4,
              use_pallas=False)
    info = serve(str(ckpt), str(tmp_path / "port.npz"), n_agents=128,
                 seed=4, use_kernel=False, device="cpu")
    want, got = _served(tmp_path / "jax.npz"), _served(tmp_path / "port.npz")
    assert got.keys() == want.keys() == {"zone_ids", "times"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["times"], want["times"])
    assert agreement(got["zone_ids"], want["zone_ids"]) >= F32_IDS_MIN
    assert info["n_agents"] == 128 and info["num_times"] == 10


def test_port_checkpoint_is_served_by_jax(tmp_path):
    ckpt = _port_ckpt(tmp_path / "port.ckpt", num_blocks=2)
    jax_serve(str(ckpt), str(tmp_path / "jax.npz"), n_agents=64, seed=2,
              use_pallas=False)
    serve(str(ckpt), str(tmp_path / "port.npz"), n_agents=64, seed=2,
          use_kernel=False, device="cpu")
    want, got = _served(tmp_path / "jax.npz"), _served(tmp_path / "port.npz")
    assert want["zone_ids"].shape == (64, 10)
    assert agreement(got["zone_ids"], want["zone_ids"]) >= F32_IDS_MIN


def test_checkpoint_holds_host_numpy_and_replaces_atomically(tmp_path):
    path = tmp_path / "c.ckpt"
    save_checkpoint({"w": torch.zeros(1)}, str(path))
    save_checkpoint({"w": torch.arange(3.0), "n": 2,
                     "nested": [{"b": torch.ones(2, dtype=torch.int32)}]},
                    str(path))
    assert sorted(os.listdir(tmp_path)) == ["c.ckpt"]  # no temp file left
    ck = load_checkpoint(str(path))
    assert ck["n"] == 2
    assert isinstance(ck["w"], np.ndarray) and ck["w"].dtype == np.float32
    np.testing.assert_array_equal(ck["w"], [0.0, 1.0, 2.0])
    assert isinstance(ck["nested"][0]["b"], np.ndarray)


def test_serve_refuses_a_checkpoint_without_its_world_seed(tmp_path):
    ckpt = tmp_path / "old.ckpt"
    _port_ckpt(ckpt)
    ck = load_checkpoint(str(ckpt))
    del ck["world_seed"]
    save_checkpoint(ck, str(ckpt))
    with pytest.raises(ValueError, match="world_seed"):
        serve(str(ckpt), str(tmp_path / "o.npz"), n_agents=8, device="cpu")
    serve(str(ckpt), str(tmp_path / "o.npz"), n_agents=8, world_seed=0,
          use_kernel=False, device="cpu")


def test_serve_rejects_sparse_world_checkpoints(tmp_path):
    """A sparse-world checkpoint of the port, once refused, is served by
    both packages from its regenerated edge-list world."""
    ckpt = _port_ckpt(tmp_path / "s.ckpt", num_blocks=2, sparse_world=True)
    jax_serve(str(ckpt), str(tmp_path / "jax.npz"), n_agents=64, seed=3,
              use_pallas=False)
    info = serve(str(ckpt), str(tmp_path / "o.npz"), n_agents=64, seed=3,
                 device="cpu")
    want, got = _served(tmp_path / "jax.npz"), _served(tmp_path / "o.npz")
    assert got["zone_ids"].shape == want["zone_ids"].shape == (64, 10)
    assert agreement(got["zone_ids"], want["zone_ids"]) >= F32_IDS_MIN
    assert info["num_times"] == WORLD["num_times"]


def test_port_serves_without_importing_jax(tmp_path):
    ckpt = _port_ckpt(tmp_path / "p.ckpt")
    code = (
        "import sys\n"
        "from ananke_abm_tpu_torch.models.gnn_embed.train import serve\n"
        f"info = serve({str(ckpt)!r}, {str(tmp_path / 'o.npz')!r}, "
        "n_agents=32, use_kernel=True, device='cpu')\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('served', info['num_times'])\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 10" in proc.stdout
    assert _served(tmp_path / "o.npz")["zone_ids"].shape == (32, 10)


def test_port_source_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax or anything of the JAX package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    ref = re.compile(r"^\s*(?:import|from)\s+(ananke_abm_tpu(?:\.\w+)*)\b",
                     re.M)
    allowed = ()
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 10
    for f in files:
        src = f.read_text()
        assert not bad.search(src), f
        for mod in ref.findall(src):
            assert mod in allowed, (f, mod)


def test_resolve_device_never_falls_back_to_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device is required"):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
