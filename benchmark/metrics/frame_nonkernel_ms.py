"""frame_nonkernel_ms: device ms a frame outside K-B2 (selection, sort,
gathers, copies)."""
from benchmark.counts import kb2
from benchmark.metrics._common import nonkernel_ms


def read(ctx):
    return nonkernel_ms(ctx, kb2.KERNELS)
