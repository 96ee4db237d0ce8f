"""What the per-layer metric files share: span times, the device's busy
time inside spans, and the two rooflines.  Each metric file under
``metrics/`` calls one of these; a reader that finds nothing to read
returns None and the harness leaves the metric out."""

from __future__ import annotations

from . import arith

# Bytes one ray's TraceResult writes: status and n_bounces (int32) and
# three float32 3-vectors (last point, segment start, direction).  The
# inputs are the source's scalars: nothing per ray.
TRACE_BYTES_PER_RAY = 4 + 4 + 3 * 3 * 4
# Bytes the scorer reads and writes once: each exit's line (point and
# direction, float32), each position (centre and normal, float32) and its
# int32 count.
SCORE_BYTES_PER_EXIT = 6 * 4
SCORE_BYTES_PER_POSITION = 6 * 4 + 4


def timed_spans(run, name: str):
    """The traced run's spans called ``name`` outside the profiled jobs
    (the profiler slows the eager loops), or all of them where there are
    no others."""
    spans = [s for s in run.spans if s[0] == name]
    if run.profiled is not None:
        outside = [s for s in spans if s[3] <= run.profiled[0]]
        spans = outside or spans
    return spans


def span_mean_ms(run, name: str):
    spans = timed_spans(run, name)
    if not spans:
        return None
    return 1e3 * sum(s[3] - s[2] for s in spans) / len(spans)


def profiled_spans(run, name: str):
    """The spans called ``name`` that lie inside the profiled stretch."""
    if run.busy is None:
        return []
    lo, hi = run.profiled
    return [s for s in run.spans if s[0] == name and s[2] >= lo
            and s[3] <= hi]


def busy_in(run, spans) -> float:
    return sum(arith.covered(run.busy, s[2], s[3]) for s in spans)


def roofline(run, name: str, work):
    """Least time of the work of the profiled ``name`` spans over the
    device-busy time inside them, in percent.  ``work(meta)`` gives one
    span's ``(flops, bytes)`` or None."""
    spans = profiled_spans(run, name)
    flops = nbytes = 0.0
    for s in spans:
        w = work(s[4])
        if w is None:
            return None
        flops, nbytes = flops + w[0], nbytes + w[1]
    busy = busy_in(run, spans)
    if not spans or busy <= 0:
        return None
    pct, _ = arith.roofline_pct(flops, nbytes, busy)
    return pct


def idle_pct(run):
    if run.busy is None:
        return None
    lo, hi = run.profiled
    return arith.idle_pct(arith.covered(run.busy, lo, hi), hi - lo)
