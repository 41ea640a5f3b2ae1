"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc -c`` per ``.cu`` file, all started together, and linked into one
shared library with a plain C interface, ``build/nnc_tpu_torch/
libnnc_kernels.so`` at the repository root, on first use. The library is
rebuilt whenever a source is newer than it (as the codec's native CABAC
library is, coder/cabac.py). It is loaded with ctypes; every pointer
and the CUDA stream pass as ``c_void_p``.

Each kernel wrapper adds one to its launch count (:func:`count_launch`)
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. A launch captured in a CUDA graph is
counted at every replay of the graph instead (:func:`recording_launches`,
:func:`add_launches`).
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nnc_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libnnc_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

KERNELS = ("render_pass", "mlp_from_points", "mlp_int8_from_points",
           "mlp_embedded", "mlp_train_fwd", "mlp_train_bwd",
           "mlp_train_bwd_dw", "mlp_tp_pair",
           "mlp_from_points_bf16", "render_pass_bf16", "mlp_train_fwd_bf16",
           "mlp_train_bwd_bf16", "mlp_train_bwd_dw_bf16", "mlp_embedded_bf16",
           "mlp_tp_pair_bf16", "mlp_train_fwd_ipe", "mlp_train_bwd_ipe",
           "render_pass_packed", "lsa_epilogue")

_lock = threading.Lock()
_lib = None
_launches = {name: 0 for name in KERNELS}


_recording = None   # the counts of a CUDA graph being captured


def count_launch(name: str) -> None:
    counts = _launches if _recording is None else _recording
    counts[name] += 1


class _Recording:
    def __enter__(self):
        global _recording
        _recording = collections.Counter()
        return _recording

    def __exit__(self, *_exc):
        global _recording
        _recording = None
        return False


def recording_launches() -> _Recording:
    """A block for a CUDA graph's capture, which launches nothing: inside
    it the launches that :func:`count_launch` sees go into the Counter that
    ``with`` gives, not into the counts, and :func:`add_launches` adds them
    at every replay."""
    return _Recording()


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a CUDA graph (``counts``: those
    recorded while it was captured)."""
    for name, n in counts.items():
        _launches[name] += n


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


def cuobjdump() -> str:
    """The CUDA toolkit's ``cuobjdump``, beside its nvcc."""
    return os.path.join(os.path.dirname(_nvcc()), "cuobjdump")


def opcodes(so: str, function: str = "", sass: str | None = None):
    """Counter of the SASS opcodes (without modifiers: ``IDP`` for
    ``IDP.4A``) in a built library (or in its dump ``sass``, the text of
    ``cuobjdump -sass``), of the kernels whose (mangled) name contains
    ``function``."""
    if sass is None:
        sass = subprocess.run([cuobjdump(), "-sass", so], capture_output=True,
                              text=True, check=True, timeout=300).stdout
    ops = collections.Counter()
    for part in sass.split("Function : ")[1:]:
        if function in part.split("\n", 1)[0]:
            ops.update(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_.]*)",
                part))
    return ops


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
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        so = os.path.join(tmp, os.path.basename(LIB_PATH))
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                for s, o in zip(srcs, objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        rcs = [p.returncode for p in procs]
        if not any(rcs):
            cmds.append([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs])
            proc = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            outs.append(proc.stdout)
            rcs.append(proc.returncode)
        seconds = time.perf_counter() - t0
        with open(BUILD_LOG, "w") as f:
            f.writelines(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        if any(rcs):
            raise RuntimeError("nvcc failed:\n" + "".join(
                f"{' '.join(c)} ({r}):\n{o}"
                for c, o, r in zip(cmds, outs, rcs) if r))
        os.replace(so, LIB_PATH)
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
        handle.nnc_mma_params_size.argtypes = []
        handle.nnc_mma_params_size.restype = ci
        handle.nnc_mlp_from_points.argtypes = [vp, vp, vp, vp, ci, vp]
        handle.nnc_mlp_from_points.restype = ci
        handle.nnc_mlp_embedded.argtypes = [vp, vp, vp, vp, ci, vp]
        handle.nnc_mlp_embedded.restype = ci
        handle.nnc_int8_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        handle.nnc_int8_sizes.restype = ci
        handle.nnc_int8_mma_size.argtypes = []
        handle.nnc_int8_mma_size.restype = ci
        handle.nnc_mlp_int8_from_points.argtypes = [vp, vp, vp, vp, ci, vp]
        handle.nnc_mlp_int8_from_points.restype = ci
        handle.nnc_render_pass.argtypes = [vp, vp, vp, vp, vp, vp, vp, cf,
                                           vp, vp, ci, ci, vp]
        handle.nnc_render_pass.restype = ci
        # (the packed pass: the plan's bounds after live, stats after maps)
        handle.nnc_render_pass_packed.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                  vp, vp, vp, ci, ci, vp]
        handle.nnc_render_pass_packed.restype = ci
        handle.nnc_bf16_params_size.argtypes = []
        handle.nnc_bf16_params_size.restype = ci
        handle.nnc_bf16_tile_points.argtypes = []
        handle.nnc_bf16_tile_points.restype = ci
        handle.nnc_bf16_wgmma_size.argtypes = []
        handle.nnc_bf16_wgmma_size.restype = ci
        # (K-B3 bf16 takes its wgmma slabs after the weights)
        handle.nnc_mlp_from_points_bf16.argtypes = [vp, vp, vp, vp, vp, ci,
                                                    vp]
        handle.nnc_mlp_from_points_bf16.restype = ci
        # (the bf16 kernel takes its ray queue's counter after the weights)
        handle.nnc_render_pass_bf16.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                cf, vp, vp, vp, ci, ci, vp]
        handle.nnc_render_pass_bf16.restype = ci
        handle.nnc_train_sizes.argtypes = [ctypes.POINTER(ci)] * 2
        handle.nnc_train_sizes.restype = ci
        handle.nnc_train_wgmma_sizes.argtypes = [ctypes.POINTER(ci)] * 2
        handle.nnc_train_wgmma_sizes.restype = ci
        handle.nnc_mlp_train_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                             vp]
        handle.nnc_mlp_train_fwd.restype = ci
        handle.nnc_mlp_train_bwd_mma.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                 vp, ci, ci, vp]
        handle.nnc_mlp_train_bwd_mma.restype = ci
        # K-B1's IPE instantiation (mip-NeRF): pts (n, 6)
        handle.nnc_train_wgmma_ipe_size.argtypes = [ctypes.POINTER(ci)]
        handle.nnc_train_wgmma_ipe_size.restype = ci
        handle.nnc_mlp_train_fwd_ipe.argtypes = \
            handle.nnc_mlp_train_fwd.argtypes
        handle.nnc_mlp_train_fwd_ipe.restype = ci
        handle.nnc_mlp_train_dw.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                            ci, ci, vp]
        handle.nnc_mlp_train_dw.restype = ci
        handle.nnc_train_bf16_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        handle.nnc_train_bf16_sizes.restype = ci
        handle.nnc_mlp_train_fwd_bf16.argtypes = \
            handle.nnc_mlp_train_fwd.argtypes
        handle.nnc_mlp_train_fwd_bf16.restype = ci
        handle.nnc_mlp_train_bwd_bf16.argtypes = \
            handle.nnc_mlp_train_bwd_mma.argtypes
        handle.nnc_mlp_train_bwd_bf16.restype = ci
        handle.nnc_mlp_train_dw_bf16.argtypes = \
            handle.nnc_mlp_train_dw.argtypes
        handle.nnc_mlp_train_dw_bf16.restype = ci
        handle.nnc_mlp_tp_pair.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, vp]
        handle.nnc_mlp_tp_pair.restype = ci
        handle.nnc_mlp_embedded_bf16.argtypes = \
            handle.nnc_mlp_embedded.argtypes
        handle.nnc_mlp_embedded_bf16.restype = ci
        handle.nnc_mlp_tp_pair_bf16.argtypes = handle.nnc_mlp_tp_pair.argtypes
        handle.nnc_mlp_tp_pair_bf16.restype = ci
        # K-B7 (lsa_epilogue.cu): n as long long
        cll = ctypes.c_longlong
        handle.nnc_lsa_epilogue_fwd.argtypes = [vp, vp, vp, vp, cll, ci, ci,
                                                vp]
        handle.nnc_lsa_epilogue_fwd.restype = ci
        handle.nnc_lsa_epilogue_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                vp, cll, ci, ci, ci, cll, vp]
        handle.nnc_lsa_epilogue_bwd.restype = ci
        _lib = handle
        return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
