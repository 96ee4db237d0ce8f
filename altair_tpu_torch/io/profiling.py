"""Profiling/tracing instrumentation — the counterpart of
``altair_tpu/io/profiling.py`` (SURVEY.md §5.1), plus the port's own tracer.

The reference wraps every phase in manual ``TStopwatch`` timers and writes
them into CSV footers (``fluxAtObserverOptimize.C:524-531,657-670``).  The
sweep functions keep that footer contract; this module adds the device-level
layer the reference never had: ``torch.profiler`` traces (CPU and CUDA
activities) viewable in Perfetto or ``chrome://tracing``, plus a lightweight
phase timer with the same wall/CPU reporting style.

The tracer: the trace and score paths open ``span(name, **attrs)`` at their
stage boundaries and call ``count(name, n)`` where they do countable work.
Tracing is off until a ``tracing()`` block turns it on; while it is off
a span site costs one test of a module flag (no clock read, no record, no
device op).
While on, a span records its name, an id, its parent's id, the id of its
root (the outermost span, which starts a request), its start and end on
``time.perf_counter_ns()`` and its attributes, and opens a
``torch.profiler.record_function`` label when a profiler is recording.  A
span never synchronises the device: its duration is the host's time in
that stage.  Counters are kept as process totals always and, while on, per
root span.  ``records()`` returns both; ``clear()`` empties them.  The
state is the process's: one thread traces at a time.

Counters the port keeps (names as ``records()`` gives them):

* ``host_syncs``: device-to-host reads on the trace and score paths
  (``host_bool`` / ``host_int``), always;
* ``kernel.bounce.launches``, ``kernel.refill.launches``,
  ``kernel.finish.launches`` and ``kernel.<name>.rays`` (the rays those
  launches took), always; each launch's size is also the ``n`` of its
  ``kernel.<name>`` span (``kernel.finish`` also says ``exact_rim``,
  ``entry``: ``source`` or ``state``, and ``lanes_per_thread``: the
  launch's pool depth, 1 where every lane has a thread of its own);
* ``kernel.finish.pooled``: the finish launches whose buffer was wider
  than the card's resident threads, so that threads took further lanes
  (``lanes_per_thread`` above 1), always;
* ``kernel.score.launches``, always, and ``kernel.score.pairs`` (the
  launch's rows times its positions, a device count), only while
  tracing; a launch's rows and positions are also the ``n`` and
  ``positions`` of its ``kernel.score`` span;
* ``insphere.disk_tests``: ray-disk pairs the in-sphere sweep tested
  (rays times the disks each was tested against), always;
* ``lane_steps_issued`` and ``lane_steps_live``: per eager or waves loop,
  its width times the iterations run (host), and the lane-steps whose ray
  was running at the step's start (summed on the device, read when
  ``records()`` is called), only while tracing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import time

import torch

_on = False
_ids = itertools.count(1)
_stack: list = []           # the open spans, innermost last
_spans: list = []           # finished spans, in the order they ended
_totals: collections.Counter = collections.Counter()
_by_root: dict = collections.defaultdict(collections.Counter)
_pending: list = []         # (root, name, 0-d device tensor), read lazily


class _Off:
    """What ``span`` returns while tracing is off: a block that records
    nothing."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    on = True

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.label = None
        if torch.autograd._profiler_enabled():
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack.remove(self)
        if self.label is not None:
            self.label.__exit__(*exc)
        _spans.append({"name": self.name, "id": self.id,
                       "parent": self.parent, "root": self.root,
                       "start_ns": self.start, "end_ns": end,
                       "attrs": self.attrs})
        return False

    def set(self, **attrs):
        """Add attributes known only once the stage has run."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A ``with`` block recorded as a span while tracing is on (see the
    module's docstring).  The block's target has ``on`` (whether it
    records) and ``set(**attrs)``."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
    """Turn the tracer on for the enclosed block (records accumulate until
    ``clear()``)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``: to the process total, and while
    tracing to the current root span's count.  ``n`` may be a 0-d device
    tensor; it is then read when ``records()`` is called, not here."""
    root = _stack[0].root if (_on and _stack) else None
    if isinstance(n, torch.Tensor):
        _pending.append((root, name, n))
        return
    _totals[name] += n
    if _on:
        _by_root[root][name] += n


def host_bool(t) -> bool:
    """``bool(t)`` of a device tensor, counted as a host sync."""
    count("host_syncs")
    return bool(t)


def host_int(t) -> int:
    """``int(t)`` of a device tensor, counted as a host sync."""
    count("host_syncs")
    return int(t)


def records() -> dict:
    """``{"spans": [...], "counters": {root: {name: n}}, "totals": {name:
    n}}``: every finished span (a dict of ``name``, ``id``, ``parent``,
    ``root``, ``start_ns``, ``end_ns``, ``attrs``) in order of start, the
    counts per root span (root None: counted while tracing outside any
    span) and the process totals.  Reads the device counts still pending,
    which waits for the device."""
    for root, name, t in _pending:
        v = int(t)
        _totals[name] += v
        _by_root[root][name] += v
    _pending.clear()
    return {"spans": sorted((dict(s) for s in _spans),
                            key=lambda s: s["start_ns"]),
            "counters": {r: dict(c) for r, c in _by_root.items()},
            "totals": dict(_totals)}


def clear() -> None:
    """Empty the spans and every counter, process totals included."""
    _spans.clear()
    _totals.clear()
    _by_root.clear()
    _pending.clear()


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
    intervals (kernels and copies; the device-side span of a ``span``
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
