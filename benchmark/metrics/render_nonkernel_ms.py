"""render_nonkernel_ms: device ms a test view outside K-B2 (sampling,
sample_pdf, sorts, culling, copies)."""
from benchmark.counts import kb2
from benchmark.metrics._common import nonkernel_ms


def read(ctx):
    return nonkernel_ms(ctx, kb2.KERNELS)
