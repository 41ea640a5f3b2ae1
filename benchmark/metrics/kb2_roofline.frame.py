"""kb2_roofline.frame: K-B2's share of its roofline in the frame window, on
the filled sample slots (counted by the reference)."""
from benchmark.counts import kb2
from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, kb2.KERNELS, "kb2_ops", "kb2_bytes")
