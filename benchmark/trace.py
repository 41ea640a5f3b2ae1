"""The measured window and, in a traced run, the device's work inside it.

:class:`Window` marks the window's start and end on the host clock. With
tracing on it also runs ``torch.profiler`` (CPU and CUDA activities) from
before the window to after it, and marks the window as a profiler range, so
that only the device's operations inside the range count. :meth:`summary`
reduces the trace: the window's length on the profiler's clock, the
union of the device's busy intervals in it (kernels, copies and memsets),
each operation's device seconds, and the longest idle gaps named by the
innermost host range open at the gap's start.
"""
from __future__ import annotations

import collections
import time

import torch

MARK = "benchmark.window"


def _ns(evt, what):
    f = getattr(evt, what + "_ns", None)
    return f() if f is not None else 1e3 * getattr(evt, what + "_us")()


class Window:
    """Use as ``with Window(trace) as w: ...; w.start(); ...; w.stop()``;
    ``seconds`` is the window's length on the host clock."""

    def __init__(self, trace: bool, device_kind: str = "cuda"):
        self.trace = trace
        self.t_start = self.t_stop = None
        self._prof = self._mark = None
        self._device_kind = device_kind

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self._device_kind == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def start(self):
        self.t_start = time.perf_counter()
        if self._prof is not None:
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()

    def stop(self):
        if self._device_kind == "cuda":
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return self.t_stop - self.t_start

    def summary(self):
        """None without a trace; else a dict: ``window_s``, ``busy_s``,
        ``ops`` {device op name: seconds}, ``gaps`` the ten longest idle
        gaps [(host range, seconds)], longest first."""
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == MARK]
        if not marks:
            return None
        w0 = _ns(marks[0], "start")
        w1 = w0 + _ns(marks[0], "duration")
        dev, host = [], []
        for e in events:
            a = _ns(e, "start")
            b = a + _ns(e, "duration")
            if b <= w0 or a >= w1 or e.name() == MARK:
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((max(a, w0), min(b, w1), e.name()))
            else:
                host.append((a, b, e.name()))
        # a host range (record_function) is mirrored on the device's
        # timeline; it is no work of the device
        ranges = {n for _a, _b, n in host}
        dev = [d for d in dev if d[2] not in ranges]
        dev.sort()
        busy, merged = 0.0, []
        for a, b, _n in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        ops = collections.Counter()
        for a, b, n in dev:
            ops[n] += (b - a) / 1e9
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                       if b > a), reverse=True)[:10]
        gaps = [(_host_at(host, a), d / 1e9) for d, a in gaps]
        return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
                "ops": dict(ops), "gaps": gaps}


def _host_at(host, t):
    """The innermost host range open at ``t``, else "host"."""
    best = None
    for a, b, n in host:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, n)
    return best[1] if best else "host"


def device_seconds(summary, names) -> float:
    """Device seconds of the operations whose names contain one of
    ``names``."""
    return sum(s for n, s in summary["ops"].items()
               if any(k in n for k in names))


def breakdown(summary) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps, in seconds."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in summary["gaps"]]}
