"""Stdout progress protocol (SURVEY.md §5.5).

A copy of ``altair_tpu/io/progress.py`` (standard library only, no JAX),
so that ``altair_tpu_torch`` never imports the JAX package.

Reproduces the reference's observability contract: per-position
``theta, phi: hits/total = fraction`` lines (``fluxAtObserver.C:367-371``),
``[DEBUG TIME HH:MM:SS]`` phase stamps (``fluxAtObserverFast.C:509-515``),
completion percent, rolling-average ETA over the last 20 points
(``fluxAtObserverOptimize.C:533-535,599-627``) and the terminal-bell
completion notification (``'\\a'``, ``:692-698``).
"""

from __future__ import annotations

import sys
import time
from collections import deque


def debug_stamp(msg: str, stream=sys.stdout):
    """``[DEBUG TIME HH:MM:SS] msg`` (``fluxAtObserverFast.C:509-515``)."""
    stream.write(f"[DEBUG TIME {time.strftime('%H:%M:%S')}] {msg}\n")
    stream.flush()


class EtaTracker:
    """Rolling-average ETA over the last ``window`` point times
    (``fluxAtObserverOptimize.C:533-535,599-627``)."""

    def __init__(self, total: int, window: int = 20):
        self.total = total
        self.done = 0
        self.times: deque[float] = deque(maxlen=window)
        self._last = time.time()

    def tick(self) -> str | None:
        now = time.time()
        self.times.append(now - self._last)
        self._last = now
        self.done += 1
        if len(self.times) <= 5:
            return None
        avg = sum(self.times) / len(self.times)
        remaining = avg * (self.total - self.done)
        h = int(remaining // 3600)
        m = int((remaining - h * 3600) // 60)
        s = int(remaining - h * 3600 - m * 60)
        eta = time.strftime("%Y-%m-%d %H:%M:%S",
                            time.localtime(now + remaining))
        parts = []
        if h > 0:
            parts.append(f"{h}h")
        if h > 0 or m > 0:
            parts.append(f"{m}m")
        parts.append(f"{s}s")
        return f"Estimated remaining time: {' '.join(parts)} (ETA: {eta})"

    @property
    def percent(self) -> float:
        return 100.0 * self.done / self.total


def position_line(theta: float, phi: float, hits: int, total: int) -> str:
    """``theta, phi: hits/total = fraction`` (``fluxAtObserver.C:367-371``)."""
    return (f"{theta:.1f}°, {phi:.1f}°: {hits}/{total} = "
            f"{hits / total:.8f}")


def notify_bell(stream=sys.stdout):
    """Terminal-bell completion notification
    (``fluxAtObserverOptimize.C:692-698``)."""
    stream.write("\n***** SWEEP COMPLETE *****\n\n\a\n")
    stream.flush()
