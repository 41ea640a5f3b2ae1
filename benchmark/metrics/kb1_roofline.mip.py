"""kb1_roofline.mip: K-B1's IPE instantiation's share of its roofline in
mip-NeRF's LSA window: the least time for the steps' forward and backward
operations (or bytes) over the device time of its kernels (the IPE
forward and the backward)."""
from benchmark.counts import kb1_ipe
from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, kb1_ipe.KERNELS, "kb1_ops", "kb1_bytes")
