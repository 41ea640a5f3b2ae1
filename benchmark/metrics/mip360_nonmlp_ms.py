"""mip360_nonmlp_ms: device ms a mip-NeRF 360 LSA step outside the MLPs'
kernels (cuBLAS's GEMMs and K-B7): the contraction, the basis and the
encoding, dilation, resampling, compositing, the three losses and Adam."""
from benchmark.counts import mlp360
from benchmark.metrics._common import nonkernel_ms


def read(ctx):
    return nonkernel_ms(ctx, mlp360.GEMM_KERNELS + mlp360.KB7_KERNELS)
