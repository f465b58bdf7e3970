"""The port is whole: every public top-level function and class of every
module of the JAX package, and every name an ``__init__`` re-exports, has
a counterpart of the same name in the port's module of the same path
(``ananke_abm_tpu/x/y.py`` -> ``ananke_abm_tpu_torch/x/y.py``), but for the
exceptions below, each with its reason. Both packages are read with
``ast``; nothing is imported."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "ananke_abm_tpu"
PORT = ROOT / "ananke_abm_tpu_torch"

# {module path, or "module path::name": why the port has no counterpart
# of that name at that path}
EXCEPTIONS = {
    "ops/pallas/": "the Pallas TPU kernels; each is a hand-written CUDA "
                   "kernel under ops/cuda/ (csrc/*.cu), whose wrappers are "
                   "named for the port's kernels (PERF.md's kernel table)",
    "ops/pallas/tiling.py": "TPU BlockSpec tiling helpers: a CUDA kernel "
                            "sizes its own blocks",
    "ops/_platform.py": "the TPU platform probe; the port's device.py "
                        "resolves the device",
    "ode/tree.py::tree_add": "a pytree helper: the port's ODE states are "
                             "tensors, added with tensor ops",
    "ode/tree.py::tree_sub": "a pytree helper: the port's ODE states are "
                             "tensors, subtracted with tensor ops",
    "ode/tree.py::tree_scale": "a pytree helper: the port's ODE states are "
                               "tensors, scaled with tensor ops",
    "ode/tree.py::tree_stack_buffer": "a pytree helper: the port stacks "
                                      "its tensor states with torch.stack",
    "ode/tree.py::tree_buffer_set": "a pytree helper: the port writes its "
                                    "tensor buffers by index",
    "parallel/halo.py::ring_encoder_shard_map":
        "shard_map's form of the ring encoder; the port's is "
        "parallel/halo.py::ring_encoder over torch.distributed",
    "models/gen_schedule/pipeline/train.py::make_chunked_train_fn":
        "JAX's chunked scan of epochs; the port's train() runs its epochs "
        "eagerly and keeps the scan's checkpoint cadence through "
        "_last_ckpt_due",
}


def _public(path: Path) -> set:
    """The module's public top-level functions and classes, and for an
    ``__init__`` the names it imports too."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _defined(path: Path) -> set:
    """Every top-level name the module binds: functions, classes,
    assignments and imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def _excepted(rel: str) -> bool:
    return any(rel == k or (k.endswith("/") and rel.startswith(k))
               for k in EXCEPTIONS if "::" not in k)


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _missing(rel: str) -> list:
    counterpart = PORT / rel
    if not counterpart.exists():
        return [f"{rel} (the module)"]
    have = _defined(counterpart)
    return sorted(n for n in _public(REF / rel) - have
                  if f"{rel}::{n}" not in EXCEPTIONS)


@pytest.mark.parametrize("rel", [m for m in MODULES if not _excepted(m)])
def test_module_has_its_counterpart(rel):
    assert _missing(rel) == [], (
        f"ananke_abm_tpu/{rel}: no counterpart in ananke_abm_tpu_torch/"
        f"{rel} for {_missing(rel)}")


def test_every_exception_names_a_gap_of_the_port():
    """No stale exception: each names a module or a public name of the JAX
    package that the port's module of the same path lacks."""
    for key in EXCEPTIONS:
        if "::" in key:
            rel, name = key.split("::")
            assert name in _public(REF / rel), key
            assert name not in _defined(PORT / rel), key
        elif key.endswith("/"):
            assert (REF / key).is_dir() and not (PORT / key).exists(), key
        else:
            assert (REF / key).exists() and not (PORT / key).exists(), key


def test_the_walk_sees_both_packages():
    assert len(MODULES) > 100
    assert "dataio/vista.py" in MODULES and "utils/__init__.py" in MODULES
    assert "load_checkpoint" in _public(REF / "utils" / "__init__.py")
    assert "AsyncCheckpointer" in _defined(PORT / "utils" / "ckpt.py")
