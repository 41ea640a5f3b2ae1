"""kb7_roofline: K-B7's share of its roofline in mip-NeRF 360's LSA
window: the least time for the bytes it has to move (benchmark/counts/
mlp360.py) at the card's bandwidth over its device time."""
from benchmark import trace
from benchmark.counts import mlp360
from benchmark.metrics._common import _window


def read(ctx):
    t, nbytes = _window(ctx), ctx["counts"].get("kb7_bytes")
    if t is None or not nbytes:
        return None
    seconds = trace.device_seconds(t, mlp360.KB7_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / ctx["peak"]["bytes"] / seconds
