"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/nnc_tpu_torch/
libnnc_kernels.so`` at the repository root, on first use. The library is
rebuilt whenever a source is newer than it (as the codec's native CABAC
library is, nnc_tpu/coder/cabac.py). It is loaded with ctypes; every pointer
and the CUDA stream pass as ``c_void_p``.

Each kernel wrapper adds one to its launch count (:func:`count_launch`)
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nnc_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libnnc_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("render_pass", "mlp_from_points")

_lock = threading.Lock()
_lib = None
_launches = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of nnc_tpu_torch "
                       "are built from source on a machine with the CUDA "
                       "toolkit")


def _lib_is_fresh() -> bool:
    if not os.path.exists(LIB_PATH):
        return False
    built = os.path.getmtime(LIB_PATH)
    return all(os.path.getmtime(src) <= built for src in _sources())


def build(force: bool = False) -> float:
    """Compile the kernels if stale (or ``force``). Returns the seconds the
    compiler took (0.0 when the library was fresh). The compiler's output,
    with ``-Xptxas -v`` register and spill counts, goes to ``BUILD_LOG``."""
    if not force and _lib_is_fresh():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(BUILD_LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return seconds


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        handle = ctypes.CDLL(LIB_PATH)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.nnc_params_size.argtypes = []
        handle.nnc_params_size.restype = ci
        handle.nnc_mlp_from_points.argtypes = [vp, vp, vp, vp, ci, vp]
        handle.nnc_mlp_from_points.restype = ci
        handle.nnc_render_pass.argtypes = [vp, vp, vp, vp, vp, vp, vp, cf,
                                           vp, vp, ci, ci, vp]
        handle.nnc_render_pass.restype = ci
        _lib = handle
        return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
