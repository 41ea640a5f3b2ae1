"""reshuffle_share.lsa_pool: % of the window's wall, from its first LSA
call's start to its last call's end, inside ``RayBatcher``'s reshuffles of
the pool (the spans ``nnc.rays.shuffle`` under the window's calls)."""
from benchmark.metrics._spans import log, window


def read(ctx):
    found = window(ctx, "nnc.lsa.call", by_steps=True)
    if found is None:
        return None
    calls, _children = found
    ids = {c.index for c in calls}
    shuffled = sum(s.end_ns - s.start_ns for s in log()
                   if s.name == "nnc.rays.shuffle" and s.request in ids)
    return 100.0 * shuffled / (calls[-1].end_ns - calls[0].start_ns)
