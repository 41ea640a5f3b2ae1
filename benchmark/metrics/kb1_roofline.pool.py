"""kb1_roofline.pool: K-B1's share of its roofline in the window of the
cells that batch from a pool of rays (as ``kb1_roofline``)."""
from benchmark.counts import kb1
from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, kb1.KERNELS, "kb1_ops", "kb1_bytes")
