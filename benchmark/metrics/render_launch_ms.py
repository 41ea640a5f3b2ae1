"""render_launch_ms: median ms of the span ``nnc.render.view`` over the
window's test views: the host's dispatch of a view's chunks
(``renderer.render_image`` does not wait for the device)."""
import statistics

from benchmark.metrics._spans import ms, window


def read(ctx):
    found = window(ctx, "nnc.render.view")
    if found is None:
        return None
    return statistics.median(ms(v.start_ns, v.end_ns) for v in found[0])
