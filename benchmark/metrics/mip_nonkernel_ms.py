"""mip_nonkernel_ms: device ms a mip-NeRF LSA step outside K-B1 (casting
the frusta, the blurred resample, compositing, the loss, Adam)."""
from benchmark.counts import kb1_ipe
from benchmark.metrics._common import nonkernel_ms


def read(ctx):
    return nonkernel_ms(ctx, kb1_ipe.KERNELS)
