"""The benchmark's arithmetic: end-to-end numbers from the window's job
records, device busy time from profiler intervals, and least times
against the H100's published peaks.  Plain Python, no torch."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def window_s(jobs) -> float:
    """Seconds from the first job's start to the end of the last job;
    ``jobs`` holds ``(start, end)`` pairs of host-clock seconds."""
    return max(e for _, e in jobs) - min(s for s, _ in jobs)


def seconds_per_job(jobs, completed: int) -> float | None:
    """The window's length over the jobs completed in it."""
    if not jobs or completed <= 0:
        return None
    return window_s(jobs) / completed


def per_second(amount: float, jobs) -> float | None:
    """``amount`` (rays of the completed jobs) over the window's length."""
    if not jobs:
        return None
    w = window_s(jobs)
    return amount / w if w > 0 else None


def merge(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of the part of ``[lo, hi]`` the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged, lo: float, hi: float):
    """The idle stretches of ``[lo, hi]`` between merged busy intervals,
    as ``(start, end, index of the busy interval before it or -1)``."""
    out, t, before = [], lo, -1
    for i, (s, e) in enumerate(merged):
        if e <= lo:
            before = i
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s, before))
        t = max(t, e)
        before = i
    if t < hi:
        out.append((t, hi, before))
    return out


def idle_pct(busy_s: float, wall_s: float) -> float | None:
    """100 x (1 - busy / wall)."""
    if wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / wall_s)


def least_time(flops: float, nbytes: float):
    """The least time the card could take for the work: the larger of the
    operations at the float32 peak and the bytes at the HBM peak.  Returns
    ``(seconds, "compute" or "memory")``."""
    t_c = flops / PEAK_FLOPS
    t_m = nbytes / PEAK_BYTES_PER_S
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")


def roofline_pct(flops: float, nbytes: float, busy_s: float):
    """Least time over the device-busy time, in percent, and the bound
    that binds; None where the device was never busy."""
    if busy_s <= 0:
        return None, None
    t, bound = least_time(flops, nbytes)
    return 100.0 * t / busy_s, bound
