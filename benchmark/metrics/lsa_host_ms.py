"""lsa_host_ms: median ms of the window's LSA calls from the call's start
to its steps' start (the span ``nnc.lsa.call`` to ``nnc.lsa.steps``): the
batches, their packing, the draws and the upload, before the replay."""
from benchmark.metrics._spans import median_ms_to


def read(ctx):
    return median_ms_to(ctx, "nnc.lsa.call", True, "nnc.lsa.steps")
