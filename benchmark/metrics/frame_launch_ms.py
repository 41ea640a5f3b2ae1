"""frame_launch_ms: median ms over the window's frames from the span
``nnc.frame``'s start to its ``nnc.frame.wait``'s start: the host's
selection, sort, K-B2 and unpack launches before the frame waits."""
from benchmark.metrics._spans import median_ms_to


def read(ctx):
    return median_ms_to(ctx, "nnc.frame", False, "nnc.frame.wait")
