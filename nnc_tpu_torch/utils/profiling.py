"""Structured profiling: torch.profiler traces and the port's spans.

Counterpart of ``nnc_tpu/utils/profiling.py`` (there over
``jax.profiler``). Usage::

    with trace_if("/tmp/nnc_trace", enabled=args.profile):
        with request("nnc.run", rays=n):
            with span("nnc.run.phase"):
                run_pipeline()

The trace is a Chrome trace (``trace.json`` in ``log_dir``), which
chrome://tracing and Perfetto open. On a machine with CUDA it holds the
device's kernels beside the host's operators and the ``nnc.*`` spans.

A span records only while a torch profiler records (``trace_if``, or any
``torch.profiler.profile``); otherwise it reads one flag and does nothing
else. While recording it opens a ``record_function`` range of its name and
appends a :class:`Span` to an in-memory log of the last :data:`SPAN_LOG`
spans (:func:`spans`), stamped with ``time.time_ns()``, the clock of the
profiler's Kineto events.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType

TRACE_FILE = "trace.json"
SPAN_LOG = 65_536      # spans the log keeps, the newest

_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG)
_LATER: collections.deque = collections.deque(maxlen=SPAN_LOG)
_INDEX = itertools.count()
_OPEN = threading.local()          # .stack: this thread's open spans
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: ``index`` numbers the process's spans in the
    order they opened; ``parent`` is the index of the span open around it
    on its thread (None at the top); ``request`` the index of the request
    span it lies under (None outside one); ``end_ns`` is None while it is
    open; ``counts`` holds host-known integers."""
    name: str
    index: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    counts: dict


class _Recording:
    __slots__ = ("name", "counts", "new_request", "record", "_range")

    def __init__(self, name, counts, new_request):
        self.name, self.counts, self.new_request = name, counts, new_request

    def __enter__(self) -> Span:
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        parent = stack[-1] if stack else None
        index = next(_INDEX)
        if self.new_request:
            req = index
        else:
            req = parent.request if parent is not None else None
        self.record = Span(self.name, index,
                           parent.index if parent is not None else None,
                           req, 0, None, self.counts)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self.record)
        _LOG.append(self.record)
        self.record.start_ns = time.time_ns()
        return self.record

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        _OPEN.stack.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, **counts):
    """A context manager that, while a torch profiler records, records the
    block as a span named ``name`` (a child of the span open around it)
    with ``counts`` and yields its :class:`Span`, whose ``counts`` the block
    may add to; otherwise it yields None and records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, counts, False)


def request(name: str, **counts):
    """:func:`span` that starts a request: the spans under it share its
    index as their ``request``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, counts, True)


def count_later(record: Span, values, names) -> None:
    """Counts of the recorded span ``record`` that a device computes: the
    tensor ``values`` (one entry a name of ``names``), read into its
    ``counts`` by :func:`settle_counts`, once the device has been waited
    for."""
    _LATER.append((record, values, names))


def settle_counts() -> None:
    """Read the counts of :func:`count_later` into their spans (call after
    a synchronisation: each read copies to the host)."""
    while _LATER:
        record, values, names = _LATER.popleft()
        record.counts.update(zip(names, values.tolist()))


def spans() -> list:
    """The log: the last :data:`SPAN_LOG` spans recorded in this process,
    in the order they opened."""
    return list(_LOG)


@contextlib.contextmanager
def trace_if(log_dir: Optional[str], enabled: bool = True):
    """Profile the block when ``enabled``, with CPU and CUDA activities
    where PyTorch sees a CUDA device (synchronised before the profiler
    stops), and write ``log_dir``/trace.json unless ``log_dir`` is None.
    Yields the ``torch.profiler.profile`` (its ``key_averages()`` hold the
    times), or None when not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_us(evt) -> float:
    """Microseconds on the device of a ``key_averages()`` entry that stands
    for device work (a kernel, a memcpy, a memset). The entries of host
    operators carry the time of the kernels launched inside them as well,
    and count for nothing here."""
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0
