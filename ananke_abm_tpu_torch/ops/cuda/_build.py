"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` at first use into its own
shared library with a plain C interface, loaded through ``ctypes``. The
libraries land in ``build/ananke_abm_tpu_torch/`` at the repository root,
under names that hash the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once. Nothing is
compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ananke_abm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# kernel library -> its source
NAMES = ("fused_step", "fused_rhs", "fused_train", "fused_gat", "fused_dopri5",
         "edge_segment")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# the C interface of each library: {function: (argument types, result)}
_ENTRY = {
    "fused_step": {
        "ananke_rk4_interval_decode": (
            [_P] * 15 + [_I] * 5 + [ctypes.c_float] + [_I] * 4 + [_P], _I),
        "ananke_rk4_step": ([_P] * 13 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
                            _I),
        "ananke_day_forward": ([_P] * 19 + [_I] * 9 + [_P], _I),
        "ananke_drift_rhs": ([_P] * 18 + [_I] * 8 + [_P], _I),
        "ananke_dopri5_step_bf16": (
            [_P] * 24 + [_I] * 6 + [_F] * 3 + [_I] * 4 + [_P], _I),
        "ananke_dopri5_step_bf16_ctas": ([_I], _I),
    },
    "fused_rhs": {
        "ananke_drift_rhs_and_vjp": ([_P] * 23 + [_I] * 9 + [_P], _I),
        "ananke_drift_rhs_tile_rows": ([_I], _I),
    },
    "fused_train": {
        "ananke_day_backward": ([_P] * 23 + [_I] * 10 + [_P], _I),
        "ananke_day_bwd_tile_rows": ([_I], _I),
        "ananke_day_bwd_slab_size": ([_I] * 3, _L),
        "ananke_ce_forward": ([_P] * 6 + [_I] * 5 + [_P], _I),
        "ananke_ce_backward": ([_P] * 10 + [_I] * 6 + [_P], _I),
        "ananke_ce_bwd_tile_rows": ([], _I),
    },
    "fused_gat": {
        "ananke_gat_forward": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "ananke_gat_backward": ([_P] * 14 + [_I] * 6 + [_P], _I),
        "ananke_gat_param_size": ([_I] * 2, _L),
        "ananke_gat_bwd_tile_rows": ([], _I),
    },
    "fused_dopri5": {
        "ananke_dopri5_step": (
            [_P] * 24 + [_I] * 6 + [_F] * 3 + [_I] * 4 + [_P], _I),
        "ananke_dopri5_step_vjp": (
            [_P] * 28 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
        "ananke_dopri5_backward_all": ([_P] * 26 + [_I] * 13 + [_P], _I),
        "ananke_dopri5_tile_rows": ([_I] * 2, _I),
        "ananke_dopri5_scratch_floats": ([_I] * 2, _L),
        "ananke_dopri5_slab_size": ([_I] * 3, _L),
    },
    "edge_segment": {
        "ananke_edge_csr_forward": ([_P] * 7 + [_I] * 3 + [_P], _I),
        "ananke_edge_csr_backward": ([_P] * 13 + [_I] * 5 + [_P], _I),
        "ananke_segment_sum": ([_P] * 4 + [_L] + [_I] * 3 + [_P], _I),
        "ananke_segment_sum_max_features": ([], _I),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=NAMES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.

    Returns ``{name: (library path, compiler output, seconds compiling --
    0.0 when it was already built)}``. Raises ``RuntimeError`` with the
    compiler's output when a build fails.
    """
    out, running = {}, {}
    for name in names:
        lib = _target(name)
        if lib.exists():
            out[name] = (lib, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, lib, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, lib, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare its C
    interface."""
    path, _, _ = build_all((name,))[name]
    lib = ctypes.CDLL(str(path))
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    for entry, (argtypes, restype) in _ENTRY[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.ananke_cuda_error_string.argtypes = [_I]
    lib.ananke_cuda_error_string.restype = ctypes.c_char_p
    return lib
