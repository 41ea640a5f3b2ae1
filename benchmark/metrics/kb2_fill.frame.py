"""kb2_fill.frame: the share of the points K-B2 computes in the frame window
that are filled sample slots, in %: over the window's frames, the sum of the
``slots`` counts of their ``nnc.frame.kb2`` spans over the sum of their
``points``. The packed render pass counts both; a program whose spans carry
no such counts reads None."""
from benchmark.metrics._spans import window


def read(ctx):
    found = window(ctx, "nnc.frame")
    if found is None:
        return None
    frames, children = found
    slots = points = 0
    for f in frames:
        kb2 = [s for s in children[f.index] if s.name == "nnc.frame.kb2"]
        if not kb2 or any("slots" not in s.counts or "points" not in s.counts
                          for s in kb2):
            return None
        slots += sum(s.counts["slots"] for s in kb2)
        points += sum(s.counts["points"] for s in kb2)
    return 100.0 * slots / points if points else None
