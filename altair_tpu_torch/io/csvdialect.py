"""The reference CSV dialect — a public interface (SURVEY.md §5.5).

A copy of ``altair_tpu/io/csvdialect.py`` (numpy only, no JAX), so
that ``altair_tpu_torch`` never imports the JAX package.

Every sweep writes ``theta,phi,fraction`` rows bracketed by ``#`` comment
metadata (header keys written at ``fluxAtObserverOptimize.C:504-518``,
completion footer at ``:667-669`` / ``fluxAtObserverFast.C:1374-1382``) that
the analysis layer parses back (``flux_analysis.py:16-25``).  This module
reproduces the dialect byte-compatibly: key names, value formatting
(``%.6f`` data rows), unique-filename suffixing (``_1``, ``_2``, ...,
``fluxAtObserverOptimize.C:336-387``) and immediate row flushing so a killed
run keeps its partial sweep (``fluxAtObserver.C:376-377``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import IO

import numpy as np


def unique_filename(base_path: str) -> str:
    """``getUniqueFilename`` (``fluxAtObserverOptimize.C:336-387``): if the
    target exists, suffix the stem with ``_1``, ``_2``, ... until free."""
    if not os.path.exists(base_path):
        return base_path
    directory, filename = os.path.split(base_path)
    stem, ext = os.path.splitext(filename)
    counter = 1
    while True:
        candidate = os.path.join(directory, f"{stem}_{counter}{ext}")
        if not os.path.exists(candidate):
            return candidate
        counter += 1


def timestamp(t: float | None = None) -> str:
    """``%Y-%m-%d %H:%M:%S`` as in every reference header/footer."""
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))


def fluxmap_filename(n_rays: int, n_theta: int, n_phi: int, src_cm,
                     trace_once: bool) -> str:
    """Filename convention of the sweep entry points
    (``fluxAtObserverOptimize.C:474-479``, ``fluxAtObserverFast.C:1100-1105``):
    ``fluxmap[_traceonce]_{n}rays_{T}x{P}_src{x}_{y}_{z}.csv`` with source
    coordinates truncated to int centimetres."""
    tag = "fluxmap_traceonce_" if trace_once else "fluxmap_"
    sx, sy, sz = (int(v) for v in src_cm)
    return f"{tag}{n_rays}rays_{n_theta}x{n_phi}_src{sx}_{sy}_{sz}.csv"


@dataclass
class FluxmapMetadata:
    """Header metadata block (keys exactly as written at
    ``fluxAtObserverOptimize.C:504-518`` / ``fluxAtObserverFast.C:1117-1133``).
    """

    n_rays: int
    detector_width_cm: float
    detector_height_cm: float
    inner_radius_cm: float
    outer_radius_cm: float
    exit_port_angle_deg: float
    n_theta: int
    n_phi: int
    reflectance: float
    roughness: float
    source_pos_cm: tuple
    source_dir: tuple
    max_reflections: int
    trace_once: bool = True
    generated: str = field(default_factory=timestamp)
    style: str = "v2"   # "v1" = fluxAtObserver.C:335-344 header variant

    def header_lines(self) -> list[str]:
        if self.style == "v1":
            # the original sweep's shorter header (fluxAtObserver.C:335-344)
            # — no reflectance/roughness/source lines, plus the odd
            # "# y direction" key recording the source dir-y component
            return [
                f"# Flux Map Data - Generated: {self.generated}",
                f"# Number of rays per position: {self.n_rays}",
                (f"# Detector dimensions: {_num(self.detector_width_cm)}cm x "
                 f"{_num(self.detector_height_cm)}cm"),
                f"# Sphere inner radius: {_num(self.inner_radius_cm)}cm",
                f"# Sphere outer radius: {_num(self.outer_radius_cm)}cm",
                f"# Exit port angle: {_num(self.exit_port_angle_deg)} degrees",
                f"# Theta bins: {self.n_theta}",
                f"# Phi bins: {self.n_phi}",
                f"# y direction: {_num(self.source_dir[1])}",
                "theta,phi,fraction",
            ]
        method = " (Trace-Once Method)" if self.trace_once else ""
        lines = [
            f"# Flux Map Data{method} - Generated: {self.generated}",
        ]
        if self.trace_once:
            lines.append(f"# Number of rays: {self.n_rays}")
            lines.append(
                f"# Detector dimensions: {_num(self.detector_width_cm)}cm x "
                f"{_num(self.detector_height_cm)}cm")
        else:
            lines.append(f"# Number of rays per position: {self.n_rays}")
            lines.append(
                f"# Detector dimensions: {_num(self.detector_width_cm)}cm x "
                f"{_num(self.detector_height_cm)}cm")
        lines += [
            f"# Sphere inner radius: {_num(self.inner_radius_cm)}cm",
            f"# Sphere outer radius: {_num(self.outer_radius_cm)}cm",
            f"# Exit port angle: {_num(self.exit_port_angle_deg)} degrees",
            f"# Theta bins: {self.n_theta}",
            f"# Phi bins: {self.n_phi}",
            f"# Mirror reflectance: {_num(self.reflectance)}",
            f"# Gaussian roughness: {_num(self.roughness)}",
            "# Lambertian scattering: enabled",
            (f"# Source position (x,y,z): {_num(self.source_pos_cm[0])}cm, "
             f"{_num(self.source_pos_cm[1])}cm, {_num(self.source_pos_cm[2])}cm"),
            (f"# Source direction (x,y,z): {_num(self.source_dir[0])}, "
             f"{_num(self.source_dir[1])}, {_num(self.source_dir[2])}"),
            f"# Max reflections: {self.max_reflections}",
        ]
        if self.trace_once:
            lines.append(
                "# Method: Trace-Once (single trace, multiple detector positions)")
        lines.append("theta,phi,fraction")
        return lines


def _num(v) -> str:
    """ROOT stream formatting of doubles: trailing-zero-free."""
    f = float(v)
    if f == int(f):
        return str(int(f))
    return repr(round(f, 10))


class FluxmapWriter:
    """Streaming CSV writer with the crash-resilience contract of the
    reference: each ``write_row`` is flushed immediately
    (``fluxAtObserverOptimize.C:578-579``), and ``write_rows_batch`` mirrors
    the trace-once batched rewrite (``fluxAtObserverFast.C:1318-1340``)."""

    def __init__(self, path: str, metadata: FluxmapMetadata,
                 make_unique: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = unique_filename(path) if make_unique else path
        self.metadata = metadata
        self._fh: IO[str] = open(self.path, "w")
        for line in metadata.header_lines():
            self._fh.write(line + "\n")
        self._fh.flush()

    def write_row(self, theta: float, phi: float, fraction: float):
        self._fh.write(f"{theta:.6f},{phi:.6f},{fraction:.6f}\n")
        self._fh.flush()

    def write_map(self, theta_centers, phi_centers, fractions):
        """Write a whole [n_theta, n_phi] map theta-major (the sweep loop
        order)."""
        fractions = np.asarray(fractions)
        rows = []
        for i, th in enumerate(np.asarray(theta_centers)):
            for j, ph in enumerate(np.asarray(phi_centers)):
                rows.append(f"{th:.6f},{ph:.6f},{fractions[i, j]:.6f}")
        self._fh.write("\n".join(rows) + "\n")
        self._fh.flush()

    def write_footer(self, total_time_s: float, *,
                     ray_time_s: float | None = None,
                     sweep_time_s: float | None = None,
                     total_hits: int | None = None,
                     n_total: int | None = None,
                     exited: int | None = None,
                     n_rays: int | None = None,
                     completed: str | None = None):
        """Completion footer (``fluxAtObserverOptimize.C:667-669`` retrace
        variant, ``fluxAtObserverFast.C:1374-1382`` trace-once variant)."""
        fh = self._fh
        fh.write(f"# Sweep completed at: {completed or timestamp()}\n")
        fh.write(f"# Total execution time: {_num(round(total_time_s, 6))} seconds\n")
        if ray_time_s is not None:
            fh.write(f"# Ray tracing time: {_num(round(ray_time_s, 6))} seconds\n")
        if sweep_time_s is not None:
            fh.write(f"# Detector sweep time: {_num(round(sweep_time_s, 6))} seconds\n")
        if total_hits is not None and n_total is not None:
            fh.write(f"# Total ray hits: {total_hits} out of {n_total}\n")
        if exited is not None and n_rays is not None:
            fh.write(f"# Total rays exiting port: {exited} out of {n_rays}\n")
        fh.flush()

    def close(self):
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fluxmap(filepath: str):
    """Parse a dialect CSV back into (theta, phi, fraction arrays, metadata
    dict) — the ``process_file`` contract of ``flux_analysis.py:11-57``
    (``#`` lines anywhere are comments; ``key: value`` pairs collected)."""
    metadata: dict[str, str] = {}
    data_rows: list[tuple[float, float, float]] = []
    with open(filepath) as fh:
        header_seen = False
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if ":" in line:
                    k, v = line[1:].split(":", 1)
                    metadata[k.strip()] = v.strip()
                continue
            if line.startswith("theta"):
                header_seen = True
                continue
            if header_seen:
                parts = line.split(",")
                data_rows.append(tuple(float(p) for p in parts[:3]))
    arr = np.asarray(data_rows, dtype=np.float64)
    if arr.size == 0:
        arr = np.zeros((0, 3))
    return arr[:, 0], arr[:, 1], arr[:, 2], metadata
