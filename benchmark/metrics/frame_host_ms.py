"""frame_host_ms: ms a frame in which the device ran nothing: the frames'
latencies summed, less the device's busy time in the window, over the
frames (host copies and launches)."""
from benchmark.metrics._common import _window


def read(ctx):
    t, lat = _window(ctx), ctx["counts"].get("latencies_s")
    if t is None or not lat:
        return None
    return 1e3 * (sum(lat) - t["busy_s"]) / len(lat)
