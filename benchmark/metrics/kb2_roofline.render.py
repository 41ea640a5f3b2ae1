"""kb2_roofline.render: K-B2's share of its roofline in the test-view
window, on the points the rays need (counted by the reference)."""
from benchmark.counts import kb2
from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, kb2.KERNELS, "kb2_ops", "kb2_bytes")
