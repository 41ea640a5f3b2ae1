"""Python bindings for the native DeepCABAC-style codec (ctypes).

Mirrors the call surface the reference uses from the external `deepCABAC`
pybind11 module (reference: SURVEY §2.2; call sites
nnc_core/approximator/baseline.py:42-98, nnc_core/coder/baseline.py:5-59),
with one documented divergence: ``dequantLayer`` takes an explicit ``dq_flag``
because the dependent-quantization reconstruction is state-dependent.

The shared library is compiled on demand from ``native/deepcabac.cpp`` at the
repository root into ``build/nnc_tpu_torch/``, a directory of the port's own,
so that it never shares a loaded library or a file with another binding of
the same source.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "deepcabac.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "nnc_tpu_torch")
_LIB = os.path.join(_BUILD_DIR, "libdeepcabac.so")
_lock = threading.Lock()
_lib = None


def _host_key() -> str:
    """CPU identity the -march=native build is valid for. A build
    directory can be carried to a host with another CPU; a library built
    for the wrong one runs slower or dies with SIGILL."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def _build_library() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build beside the target and rename: a second process loading the
    # library never sees a half-written file
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    with open(_LIB + ".hostkey", "w") as f:
        f.write(_host_key())


def _lib_is_fresh() -> bool:
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        return False
    try:
        with open(_LIB + ".hostkey") as f:
            return f.read() == _host_key()
    except OSError:
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _lib_is_fresh():
            _build_library()
        lib = ctypes.CDLL(_LIB)

        c = ctypes
        i8p, i32p, f32p, u64p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
                                 c.POINTER(c.c_float), c.POINTER(c.c_uint64))
        sigs = {
            "dc_enc_new": ([], c.c_void_p),
            "dc_enc_delete": ([c.c_void_p], None),
            "dc_enc_init_ctx": ([c.c_void_p, c.c_int, c.c_int], None),
            "dc_quant_layer": ([f32p, i32p, c.c_int64, c.c_int64, c.c_int,
                                c.c_int, c.c_int, c.c_double, c.c_int,
                                c.c_int], c.c_int),
            "dc_enc_encode_layer": ([c.c_void_p, i32p, c.c_int64, c.c_int64,
                                     c.c_int, c.c_int], None),
            "dc_enc_iae_v": ([c.c_void_p, c.c_int, c.c_int32], None),
            "dc_enc_finish": ([c.c_void_p], c.c_int64),
            "dc_enc_data": ([c.c_void_p], i8p),
            "dc_enc_bytes_written": ([c.c_void_p], c.c_int64),
            "dc_enc_terminate_segment": ([c.c_void_p], None),
            "dc_enc_num_entry_points": ([c.c_void_p], c.c_int),
            "dc_enc_get_entry_points": ([c.c_void_p, u64p], None),
            "dc_dec_new": ([], c.c_void_p),
            "dc_dec_delete": ([c.c_void_p], None),
            "dc_dec_set_stream": ([c.c_void_p, i8p, c.c_int64], None),
            "dc_dec_init_ctx": ([c.c_void_p, c.c_int], None),
            "dc_dec_iae_v": ([c.c_void_p, c.c_int], c.c_int32),
            "dc_dec_decode_layer": ([c.c_void_p, i32p, c.c_int64, c.c_int64,
                                     c.c_int, c.c_int], None),
            "dc_dec_decode_layer_and_create_eps": (
                [c.c_void_p, i32p, c.c_int64, c.c_int64, c.c_int, c.c_int],
                None),
            "dc_dec_num_entry_points": ([c.c_void_p], c.c_int),
            "dc_dec_get_entry_points": ([c.c_void_p, u64p], None),
            "dc_dec_set_entry_points": ([c.c_void_p, u64p, c.c_int], None),
            "dc_dec_decode_rows": ([c.c_void_p, i32p, c.c_int64, c.c_int64,
                                    c.c_int, c.c_int, c.c_int64, c.c_int64],
                                   c.c_int),
            "dc_dec_terminate_segment": ([c.c_void_p], None),
            "dc_dec_finish": ([c.c_void_p], c.c_int64),
            "dc_dequant_layer": ([f32p, i32p, c.c_int64, c.c_int64, c.c_int,
                                  c.c_int, c.c_int, c.c_int], None),
            "dc_stepsize_from_qp": ([c.c_int, c.c_int], c.c_double),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def _hw(shape) -> tuple[int, int]:
    """Split a tensor shape into (rows, row-width) for scan purposes."""
    if len(shape) <= 1:
        return 1, int(np.prod(shape)) if shape else 1
    return int(shape[0]), int(np.prod(shape[1:]))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class Encoder:
    """CABAC encoder accumulating one payload stream (one NDU)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.dc_enc_new()

    def __del__(self):
        try:
            self._lib.dc_enc_delete(self._h)
        except Exception:
            pass

    def initCtxModels(self, cabac_unary_length_minus1: int, param_opt_flag: int = 0):
        self._lib.dc_enc_init_ctx(self._h, cabac_unary_length_minus1, param_opt_flag)

    def quantLayer(self, values: np.ndarray, out_int32: np.ndarray, dq_flag: int,
                   qp_density: int, qp: int, lambda_scale: float,
                   cabac_unary_length_minus1: int, scan_order: int) -> int:
        values = np.ascontiguousarray(values, dtype=np.float32)
        assert out_int32.dtype == np.int32 and out_int32.flags["C_CONTIGUOUS"]
        h, w = _hw(values.shape)
        return self._lib.dc_quant_layer(
            _f32p(values), _i32p(out_int32), h, w, int(dq_flag),
            int(qp_density), int(qp), float(lambda_scale),
            int(cabac_unary_length_minus1), int(scan_order))

    def encodeLayer(self, values: np.ndarray, dq_flag: int, scan_order: int):
        values = np.ascontiguousarray(values, dtype=np.int32)
        h, w = _hw(values.shape)
        self._lib.dc_enc_encode_layer(self._h, _i32p(values), h, w,
                                      int(dq_flag), int(scan_order))

    def iae_v(self, nbits: int, value: int):
        self._lib.dc_enc_iae_v(self._h, int(nbits), int(value))

    def terminate_segment(self):
        """End the current arithmetic-engine run (byte-aligns the stream)."""
        self._lib.dc_enc_terminate_segment(self._h)

    def getEntryPoints(self) -> np.ndarray:
        n = self._lib.dc_enc_num_entry_points(self._h)
        out = np.zeros(n, dtype=np.uint64)
        if n:
            self._lib.dc_enc_get_entry_points(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    def finish(self) -> np.ndarray:
        n = self._lib.dc_enc_finish(self._h)
        ptr = self._lib.dc_enc_data(self._h)
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


class Decoder:
    """CABAC decoder over a payload stream."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.dc_dec_new()

    def __del__(self):
        try:
            self._lib.dc_dec_delete(self._h)
        except Exception:
            pass

    def setStream(self, stream):
        buf = np.frombuffer(bytes(stream), dtype=np.uint8)
        self._lib.dc_dec_set_stream(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size)

    def initCtxModels(self, cabac_unary_length_minus1: int):
        self._lib.dc_dec_init_ctx(self._h, cabac_unary_length_minus1)

    def iae_v(self, nbits: int) -> int:
        return int(self._lib.dc_dec_iae_v(self._h, int(nbits)))

    def decodeLayer(self, out_int32: np.ndarray, dq_flag: int, scan_order: int):
        assert out_int32.dtype == np.int32 and out_int32.flags["C_CONTIGUOUS"]
        h, w = _hw(out_int32.shape)
        self._lib.dc_dec_decode_layer(self._h, _i32p(out_int32), h, w,
                                      int(dq_flag), int(scan_order))

    def decodeLayerAndCreateEPs(self, out_int32: np.ndarray, dq_flag: int,
                                scan_order: int) -> np.ndarray:
        assert out_int32.dtype == np.int32 and out_int32.flags["C_CONTIGUOUS"]
        h, w = _hw(out_int32.shape)
        self._lib.dc_dec_decode_layer_and_create_eps(
            self._h, _i32p(out_int32), h, w, int(dq_flag), int(scan_order))
        n = self._lib.dc_dec_num_entry_points(self._h)
        out = np.zeros(n, dtype=np.uint64)
        if n:
            self._lib.dc_dec_get_entry_points(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    def setEntryPoints(self, eps):
        eps = np.ascontiguousarray(eps, dtype=np.uint64)
        self._lib.dc_dec_set_entry_points(
            self._h, eps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            eps.size)

    def decodeLayerRows(self, out_int32: np.ndarray, dq_flag: int,
                        scan_order: int, chunk_begin: int, chunk_end: int):
        """Random access: decode only block-row chunks [begin, end) of a
        scan_order>0 layer, seeking via setEntryPoints offsets. Rows outside
        the range are left untouched. (reference capability:
        setEntryPoints -> decodeLayer, nnc_core/coder/__init__.py:439)"""
        assert out_int32.dtype == np.int32 and out_int32.flags["C_CONTIGUOUS"]
        h, w = _hw(out_int32.shape)
        rc = self._lib.dc_dec_decode_rows(
            self._h, _i32p(out_int32), h, w, int(dq_flag), int(scan_order),
            int(chunk_begin), int(chunk_end))
        if rc != 0:
            raise ValueError("decodeLayerRows requires matching entry points"
                             " and a chunked (scan_order>0) layer")

    def terminate_segment(self):
        self._lib.dc_dec_terminate_segment(self._h)

    def dequantLayer(self, out_f32: np.ndarray, values: np.ndarray,
                     qp_density: int, qp: int, scan_order: int,
                     dq_flag: int = 1):
        assert out_f32.dtype == np.float32 and out_f32.flags["C_CONTIGUOUS"]
        values = np.ascontiguousarray(values, dtype=np.int32)
        h, w = _hw(values.shape)
        self._lib.dc_dequant_layer(_f32p(out_f32), _i32p(values), h, w,
                                   int(qp_density), int(qp), int(scan_order),
                                   int(dq_flag))

    def finish(self) -> int:
        """Bytes consumed so far (exact)."""
        return int(self._lib.dc_dec_finish(self._h))


def stepsize_from_qp(qp: int, qp_density: int) -> float:
    return float(_load().dc_stepsize_from_qp(int(qp), int(qp_density)))
