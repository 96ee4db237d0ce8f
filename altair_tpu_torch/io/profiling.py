"""Profiling/tracing instrumentation — the counterpart of
``altair_tpu/io/profiling.py`` (SURVEY.md §5.1).

The reference wraps every phase in manual ``TStopwatch`` timers and writes
them into CSV footers (``fluxAtObserverOptimize.C:524-531,657-670``).  The
sweep functions keep that footer contract; this module adds the device-level
layer the reference never had: ``torch.profiler`` traces (CPU and CUDA
activities) viewable in Perfetto or ``chrome://tracing``, plus a lightweight
phase timer with the same wall/CPU reporting style.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time


class PhaseTimer:
    """Named phase timing with the reference's report style."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{k}: {v:.6g} seconds" for k, v in self.phases.items()]
        total = sum(self.phases.values())
        lines.append(f"Total execution time: {total:.6g} seconds")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block: CPU
    activity, and CUDA activity when a card is present.  Yields ``log_dir``
    (default: ``altair_tpu_torch_trace`` under the temporary directory);
    on exit the chrome trace is written there as ``trace.json`` (open it in
    Perfetto or ``chrome://tracing``).  The profiler object is reachable as
    ``device_trace.last`` afterwards, for ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "altair_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    device_trace.last = prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_busy_s(prof) -> float | None:
    """Seconds the card was busy under a finished ``torch.profiler`` run
    (``device_trace.last``): the union of its device activities'
    intervals (kernels and copies; the device-side span of an ``annotate``
    label covers its whole block and is left out).  None when the profiler
    saw no device activity (a CPU run, or no CUPTI)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    if not spans:
        return None
    busy_us, end = 0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us * 1e-6


def annotate(name: str):
    """``torch.profiler.record_function`` pass-through for labelling custom
    phases inside a device trace."""
    from torch.profiler import record_function

    return record_function(name)
