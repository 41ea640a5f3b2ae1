"""kb1_roofline: K-B1's share of its roofline in the LSA window: the least
time for the steps' forward and backward operations (or bytes) over the
device time of its kernels."""
from benchmark.counts import kb1
from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, kb1.KERNELS, "kb1_ops", "kb1_bytes")
