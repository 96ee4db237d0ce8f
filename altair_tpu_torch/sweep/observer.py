"""Observer flux-map sweep — ``sweep_detector_trace_once``, the counterpart
of the same entry point in ``altair_tpu/sweep/observer.py``
(``sweepDetectorTraceOnce``, ``fluxAtObserverFast.C:1068-1397``): trace all
rays once, score every grid position, write the reference CSV dialect.
The other sweeps of the JAX module are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..config import DetectorGrid, SphereScene, Source, TraceConfig, validate
from ..core.score import exit_capacity, fluxmap_trace_once_compact
from ..core.trace_waves import trace_rays_auto
from ..io.csvdialect import FluxmapMetadata, FluxmapWriter, fluxmap_filename


@dataclasses.dataclass
class SweepResult:
    path: str | None
    fluxmap: np.ndarray          # [n_theta, n_phi] fractions
    n_exited: int
    n_rays: int
    trace_time_s: float
    score_time_s: float
    total_time_s: float


def _metadata(scene: SphereScene, source: Source, grid: DetectorGrid,
              n_rays: int, trace_once: bool) -> FluxmapMetadata:
    return FluxmapMetadata(
        n_rays=n_rays,
        detector_width_cm=grid.width,
        detector_height_cm=grid.height,
        inner_radius_cm=float(scene.inner_radius),
        outer_radius_cm=float(scene.outer_radius),
        exit_port_angle_deg=float(scene.theta_max_deg),
        n_theta=grid.n_theta,
        n_phi=grid.n_phi,
        reflectance=float(scene.reflectance),
        roughness=float(scene.roughness),
        source_pos_cm=(float(source.x), float(source.y), float(source.z)),
        source_dir=(float(source.dir_x), float(source.dir_y),
                    float(source.dir_z)),
        max_reflections=scene.max_bounces,
        trace_once=trace_once,
    )


def _debug_stamp(msg: str):
    """``[DEBUG TIME HH:MM:SS] msg`` (``fluxAtObserverFast.C:509-515``)."""
    sys.stdout.write(f"[DEBUG TIME {time.strftime('%H:%M:%S')}] {msg}\n")
    sys.stdout.flush()


def _wait(device):
    """Wait for the device's queued work, so a phase's wall time is its
    own."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sweep_detector_trace_once(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    verbose: bool = True,
) -> SweepResult:
    """Trace once on ``device``, score the whole grid, write the CSV.

    The trace and score phases are timed separately, like the reference's
    TStopwatch pair (``fluxAtObserverFast.C:1374-1382``).  A compaction or
    deferred-rim overflow raises: either would leave rays unscored or
    unfinished."""
    validate(scene, source)
    t_setup0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    cap = exit_capacity(scene, n_rays)

    if verbose:
        _debug_stamp("Tracing all rays once")
    t0 = time.perf_counter()
    res, rim_overflow = trace_rays_auto(gen, scene, source, n_rays, cfg,
                                        device=device)
    _wait(device)
    t_trace = time.perf_counter() - t0
    if verbose:
        _debug_stamp(f"Ray tracing completed in {t_trace:.4f} s")

    t1 = time.perf_counter()
    counts, overflow = fluxmap_trace_once_compact(res, grid, cap,
                                                  scene.exit_port_z)
    n_exit = int(res.exited_port_mask(scene.exit_port_z).sum())
    fm = counts.cpu().numpy().astype(np.float64) / n_rays
    t_score = time.perf_counter() - t1
    if int(overflow) or int(rim_overflow):
        raise RuntimeError(
            f"overflow: {int(overflow)} exit rays unscored, "
            f"{int(rim_overflow)} rim-clipped rays unfinished — "
            "statistically impossible at the planned capacities; investigate")
    if verbose:
        _debug_stamp(f"Detector sweep completed in {t_score:.4f} s")
        print(f"Total rays exiting port: {n_exit} out of {n_rays}")

    total = time.perf_counter() - t_setup0
    path = None
    if save_folder is not None:
        meta = _metadata(scene, source, grid, n_rays, trace_once=True)
        fname = fluxmap_filename(
            n_rays, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=True)
        with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
            w.write_map(grid.theta_centers().numpy(),
                        grid.phi_centers().numpy(), fm)
            w.write_footer(total, ray_time_s=t_trace, sweep_time_s=t_score,
                           exited=n_exit, n_rays=n_rays)
            path = w.path
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    return SweepResult(path, fm, n_exit, n_rays, t_trace, t_score, total)
