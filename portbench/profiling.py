"""The traced run's reading of ``torch.profiler``: device intervals, the
benchmark's spans put on the profiler's clock, and the breakdown.

Device busy time is the union of the device activities' intervals
(kernels, copies, sets), leaving out the device-side spans of annotation
labels, which cover their whole block: a copy of
``altair_tpu_torch.io.profiling.device_busy_s`` working on intervals, so
that a span can take its own share.
"""

from __future__ import annotations

import bisect
import collections
import time

from . import arith


class Spans:
    """The benchmark's spans on the host clock: ``(name, job, start, end,
    meta)``.  Only a traced run records them, and every span ends in a
    device sync, so the device work it launched lies inside it."""

    def __init__(self, device, active: bool):
        self.device = device
        self.active = active
        self.items = []

    def sync(self):
        import torch

        if self.active and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add(self, name, job, start, end, **meta):
        if self.active:
            self.items.append([name, job, start, end, meta])

    def timed(self, name, job, fn, *args, **meta):
        """Run ``fn(*args)``; when active, sync and record its span."""
        if not self.active:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        self.sync()
        self.add(name, job, t0, time.perf_counter(), **meta)
        return out


class Recorder:
    """``torch.profiler`` over a stretch of the window.  ``start`` and
    ``stop`` bracket it; ``read`` returns the device's merged busy
    intervals and the per-kernel totals on the host clock."""

    def __init__(self):
        self.prof = None
        self.anchor_host = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # device activity only: recording every aten call on the host as
        # well slowed the eager loops 2.4x against 1.7x (H100, torch 2.11)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # the anchor: the profile's first synchronize call, whose end on
        # the profiler's clock is taken together with the host clock
        torch.cuda.synchronize()
        self.anchor_host = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def read(self):
        """``(busy, kernels)``: busy intervals ``[(start, end)]`` in host
        seconds, merged, and ``[(name, start, end)]`` of every device
        activity, also in host seconds."""
        from torch.autograd import DeviceType

        dev, syncs = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((e.name(), e.start_ns(),
                                e.start_ns() + e.duration_ns()))
            elif "Synchronize" in e.name():
                syncs.append(e.start_ns() + e.duration_ns())
        if not syncs:
            raise RuntimeError("the profile holds no synchronize call to "
                               "anchor its clock")
        anchor_ns = min(syncs)

        def host(ns):
            return self.anchor_host + (ns - anchor_ns) * 1e-9

        kernels = [(n, host(s), host(t)) for n, s, t in dev]
        busy = arith.merge((s, t) for _, s, t in kernels)
        return busy, kernels


def short_name(name: str) -> str:
    """A kernel's name without the namespaces and wrappers that every
    eager PyTorch kernel shares, so that the functor shows."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "vectorized_elementwise_kernel<4, ", "std::array<char*, "):
        name = name.replace(noise, "")
    return name[:120]


def span_label(spans, t: float) -> str:
    """The name of the span that holds host time ``t``, else
    ``between_jobs`` (outside every span of a job)."""
    for name, _, s, e, _ in spans:
        if s <= t <= e:
            return name
    return "between_jobs"


def breakdown(busy, kernels, spans, lo: float, hi: float, top: int = 10):
    """The ``breakdown`` of a traced run over ``[lo, hi]``: the device
    operations that took the most time, by kernel name, and the longest
    idle gaps, each named by the span it fell in and the kernel before
    it."""
    by_name = collections.defaultdict(float)
    for name, s, e in kernels:
        if s >= lo and e <= hi:
            by_name[short_name(name)] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ends = sorted((e, name) for name, _, e in kernels)
    end_times = [e for e, _ in ends]
    longest = sorted(arith.gaps(busy, lo, hi), key=lambda g: g[0] - g[1])
    idle = []
    for s, e, _ in longest[:top]:
        label = span_label(spans, 0.5 * (s + e))
        k = bisect.bisect_right(end_times, s) - 1
        before = short_name(ends[k][1])[:60] if k >= 0 else None
        idle.append([f"{label} after {before}" if before else label, e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}
