"""frame_copy_ms: median ms over the window's frames of the span
``nnc.frame.copy``: the maps' copies to the host after the frame's wait,
and their joining."""
import statistics

from benchmark.metrics._spans import child, ms, window


def read(ctx):
    found = window(ctx, "nnc.frame")
    if found is None:
        return None
    frames, children = found
    copies = [child(children, f, "nnc.frame.copy") for f in frames]
    if any(c is None for c in copies):
        return None
    return statistics.median(ms(c.start_ns, c.end_ns) for c in copies)
