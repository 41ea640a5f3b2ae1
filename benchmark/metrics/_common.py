"""Arithmetic that several metric readers share. Each reader takes the
run's context: ``trace`` (the traced window's summary, or None), ``counts``
(what the driver counted in the window) and ``peak`` (the card's published
peaks for the configuration's type). Without something to read a reader
returns None, and the metric is left out of the line."""
from benchmark import trace


def _window(ctx):
    t = ctx["trace"]
    return t if t and t["window_s"] > 0 and t["busy_s"] > 0 else None


def idle_share(ctx):
    """% of the window in which no operation ran on the device."""
    t = _window(ctx)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx):
    """% of the peak that the model's operations in the window would take
    at the window's length."""
    t, flops = _window(ctx), ctx["counts"].get("model_flops")
    if t is None or not flops:
        return None
    return 100.0 * flops / (t["window_s"] * ctx["peak"]["flops"])


def roofline(ctx, kernels, ops_key, bytes_key):
    """% of the kernels' device time that the least time the card could
    take for their operations or their bytes, the larger, would be."""
    t = _window(ctx)
    ops, nbytes = ctx["counts"].get(ops_key), ctx["counts"].get(bytes_key)
    if t is None or not ops:
        return None
    seconds = trace.device_seconds(t, kernels)
    if seconds <= 0:
        return None
    least = max(ops / ctx["peak"]["flops"], nbytes / ctx["peak"]["bytes"])
    return 100.0 * least / seconds


def nonkernel_ms(ctx, kernels):
    """Device ms a request outside ``kernels``."""
    t, n = _window(ctx), ctx["counts"].get("requests")
    if t is None or not n:
        return None
    other = sum(t["ops"].values()) - trace.device_seconds(t, kernels)
    return 1e3 * other / n
