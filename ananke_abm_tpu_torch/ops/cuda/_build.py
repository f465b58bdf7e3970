"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` at first use into a shared library
with a plain C interface, loaded through ``ctypes``. The library lands in
``build/ananke_abm_tpu_torch/`` at the repository root, under a name that
hashes the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is compiled when a module is imported.
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
SOURCE = _PKG / "csrc" / "fused_step.cu"
BUILD_DIR = _PKG.parent / "build" / "ananke_abm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def build(verbose: bool = False) -> tuple[Path, str, float]:
    """Compile ``SOURCE`` unless an up-to-date library exists.

    Returns (library path, compiler output, seconds spent compiling — 0.0
    when the library was already built). Raises ``RuntimeError`` with the
    compiler's output when the build fails.
    """
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"fused_step-{digest[:16]}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    if verbose:
        print(log, end="")
    return lib, log, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.ananke_rk4_interval_decode
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [_P] * 15 + [_I] * 5 + [ctypes.c_float] + [_I] * 4 + [_P]
    fn.restype = _I
    lib.ananke_cuda_error_string.argtypes = [_I]
    lib.ananke_cuda_error_string.restype = ctypes.c_char_p
    return lib
