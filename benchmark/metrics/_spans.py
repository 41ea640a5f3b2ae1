"""What the readers of the program's spans share. The program records its
spans (``nnc_tpu_torch.utils.profiling``) while a profiler records, which in
a traced run is the window (and, in the LSA cells, the compared steps before
it). The window's requests are the trailing request spans of the cell's
kind in the log: the last ``requests`` of them, or, for the LSA calls, the
last whose ``steps`` sum to ``requests``. Where the program records no
spans, or the log does not hold the whole window, a reader returns None."""
import collections
import statistics


def log():
    """The program's span log, or None where the program keeps none."""
    from nnc_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def window(ctx, name, by_steps=False):
    """(the window's request spans named ``name``, oldest first, {parent
    index: its child spans}) or None."""
    records, n = log(), ctx["counts"].get("requests")
    if not records or not n:
        return None
    requests = [s for s in records if s.name == name
                and s.request == s.index and s.end_ns is not None]
    picked, total = [], 0
    for s in reversed(requests):
        if total >= n:
            break
        picked.append(s)
        total += s.counts.get("steps", 0) if by_steps else 1
    if total != n:
        return None
    children = collections.defaultdict(list)
    for s in records:
        if s.parent is not None:
            children[s.parent].append(s)
    return picked[::-1], children


def ms(a_ns, b_ns):
    return (b_ns - a_ns) / 1e6


def child(children, parent, name):
    """The first child of ``parent`` named ``name``, or None."""
    return next((s for s in children[parent.index] if s.name == name), None)


def median_ms_to(ctx, name, by_steps, phase):
    """Median ms over the window's requests from each request's start to
    the start of its first child ``phase``."""
    found = window(ctx, name, by_steps)
    if found is None:
        return None
    requests, children = found
    to = [child(children, r, phase) for r in requests]
    if any(c is None for c in to):
        return None
    return statistics.median(ms(r.start_ns, c.start_ns)
                             for r, c in zip(requests, to))
