"""mlp360_roofline: mip-NeRF 360's two MLPs' share of the port's float32
ceiling in the LSA window: the least time for their layers' operations,
forward and backward, at 165 TFLOP/s (a float32 product as three TF32
products, as the K-B1 rooflines read), over the device time of every kernel
that computes those layers (cuBLAS's GEMMs and K-B7)."""
from benchmark import trace
from benchmark.counts import mlp360
from benchmark.metrics._common import _window


def read(ctx):
    t, ops = _window(ctx), ctx["counts"].get("mlp360_ops")
    if t is None or not ops:
        return None
    seconds = trace.device_seconds(t, mlp360.GEMM_KERNELS
                                   + mlp360.KB7_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ops / mlp360.PEAK_FLOPS / seconds
