"""Structured profiling: torch.profiler traces, named regions, throughput.

Counterpart of ``nnc_tpu/utils/profiling.py`` (there over
``jax.profiler``). Usage::

    with trace_if("/tmp/nnc_trace", enabled=args.profile):
        with annotate("lsa"):
            run_pipeline()

The trace is a Chrome trace (``trace.json`` in ``log_dir``), which
chrome://tracing and Perfetto open. On a machine with CUDA it holds the
device's kernels beside the host's operators.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.autograd import DeviceType

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's trace, and an NVTX range where
    PyTorch sees a CUDA device."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


class Throughput:
    """Simple rays/sec (or items/sec) meter over a window."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int):
        self.items += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.items = 0
