"""Observer flux-map sweeps — the counterparts of the entry points of
``altair_tpu/sweep/observer.py``, same knobs, CSV dialect and stdout
protocol:

* ``sweep_detector_trace_once`` <- ``sweepDetectorTraceOnce``
  (``fluxAtObserverFast.C:1068-1397``): trace all rays once, score every
  grid position;
* ``fluxmap_replicates``: K independent trace-once maps, their mean and
  standard error;
* ``sweep_detector_retrace`` <- ``sweepDetector``
  (``fluxAtObserverOptimize.C:433-702``): fresh rays per position, theta
  rows in chunks with the CSV flushed per chunk (crash-resume contract),
  or the binomial engine's one-shot map;
* ``sweep_detector_twofold`` <- ``sweepDetectorTwofold``
  (``fluxAtObserverFast.C:518-865``): one batch per antipodal pair.

Every sweep but the replicates takes ``mesh=`` (a
``altair_tpu_torch.parallel.Mesh``): all ranks call it with the same
arguments, each traces its share of the rays on the mesh's device, and the
counts are summed over the ranks.  Rank 0 alone prints the stamps and
writes the CSV; every rank returns the same map and counts and rank 0's
``path`` (the times are each rank's own clock).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import DetectorGrid, SphereScene, Source, TraceConfig, validate
from ..core.geometry import detector_position
from ..core.score import (exit_capacity, fluxmap_retrace,
                          fluxmap_retrace_binomial, fluxmap_trace_once_compact,
                          grid_centers_normals, hits_single_detector)
from ..core.trace import fold_in
from ..core.route import trace_rays_auto
from ..io import (EtaTracker, FluxmapMetadata, FluxmapWriter, debug_stamp,
                  fluxmap_filename, notify_bell, read_fluxmap)
from ..io.profiling import host_int
from ..parallel.mesh import is_rank0, on_rank0


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
    notify: bool = False,
    mesh=None,
    verbose: bool = True,
) -> SweepResult:
    """Trace once on ``device``, score the whole grid, write the CSV.
    Pass ``mesh`` (from ``altair_tpu_torch.parallel.make_mesh``) to split
    the rays over its ranks (``sharded_trace``, then
    ``sharded_score_traced``).

    The trace and score phases are timed separately, like the reference's
    TStopwatch pair (``fluxAtObserverFast.C:1374-1382``); under a mesh the
    score phase ends after the sum over the ranks.  A compaction or
    deferred-rim overflow raises (on every rank): either would leave rays
    unscored or unfinished."""
    validate(scene, source)
    t_setup0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    verbose = verbose and is_rank0(mesh)

    if verbose:
        debug_stamp("Starting sweep setup")

    if mesh is not None:
        from ..parallel import sharded_score_traced, sharded_trace

        mesh.check_device(device)

        def run_trace():
            # the routes sum their overflow counts over the ranks and raise
            return sharded_trace(mesh, gen, scene, source, n_rays, cfg), 0

        def run_score(res):
            counts, n_exit = sharded_score_traced(mesh, res, scene, grid)
            return counts, n_exit, 0
    else:
        cap = exit_capacity(scene, n_rays)

        def run_trace():
            return trace_rays_auto(gen, scene, source, n_rays, cfg,
                                   device=device)

        def run_score(res):
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z)
            return (counts, res.exited_port_mask(scene.exit_port_z).sum(),
                    overflow)

    if verbose:
        debug_stamp("Tracing all rays once")
    t0 = time.perf_counter()
    res, rim_overflow = run_trace()
    _wait(device)
    t_trace = time.perf_counter() - t0
    if verbose:
        debug_stamp(f"Ray tracing completed in {t_trace:.4f} s")

    t1 = time.perf_counter()
    counts, n_exit, overflow = run_score(res)
    n_exit = host_int(n_exit)
    fm = counts.cpu().numpy().astype(np.float64) / n_rays
    t_score = time.perf_counter() - t1
    overflow, rim_overflow = host_int(overflow), host_int(rim_overflow)
    if overflow or rim_overflow:
        raise RuntimeError(
            f"overflow: {overflow} exit rays unscored, "
            f"{rim_overflow} rim-clipped rays unfinished — "
            "statistically impossible at the planned capacities; investigate")
    if verbose:
        debug_stamp(f"Detector sweep completed in {t_score:.4f} s")
        print(f"Total rays exiting port: {n_exit} out of {n_rays}")

    total = time.perf_counter() - t_setup0
    path = on_rank0(mesh, lambda: write_fluxmap_csv(
        save_folder, scene, source, grid, n_rays, fm, trace_once=True,
        footer=dict(total_time_s=total, ray_time_s=t_trace,
                    sweep_time_s=t_score, exited=n_exit, n_rays=n_rays),
        verbose=verbose))
    if notify and is_rank0(mesh):
        notify_bell()
    return SweepResult(path, fm, n_exit, n_rays, t_trace, t_score, total)


def fluxmap_replicates(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    replicates: int = 8,
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
):
    """``replicates`` independent trace-once maps on ``device``; returns
    ``(mean_fraction, sem)``, each ``[n_theta, n_phi]`` numpy.

    Replicate ``i`` traces from ``fold_in(key, i)``; the per-cell standard
    error of the mean comes from the replicate spread (the reference's
    repeat-runs workflow, ``flux_analysis.py:133-164``).  With ``cfg.qmc``
    each replicate is its own Sobol randomisation, so the error bars
    measure the QMC accuracy itself.  The maps stay on the device until
    the last one is scored; any overflow raises."""
    if replicates < 2:
        raise ValueError("need >= 2 replicates for a standard error")
    validate(scene, source)
    key = torch.Generator().manual_seed(seed)
    cap = exit_capacity(scene, n_rays)
    counts, overflow = [], torch.zeros((), dtype=torch.int32, device=device)
    for i in range(replicates):
        res, rim = trace_rays_auto(fold_in(key, i), scene, source, n_rays,
                                   cfg, device=device)
        c, ovf = fluxmap_trace_once_compact(res, grid, cap, scene.exit_port_z)
        counts.append(c)
        overflow = overflow + ovf + rim.total
    overflow = host_int(overflow)
    if overflow:
        raise RuntimeError(f"replicates: {overflow} rays unscored or "
                           "unfinished — statistically impossible at the "
                           "planned capacities; investigate")
    frac = torch.stack(counts).cpu().numpy().astype(np.float64) / n_rays
    return frac.mean(axis=0), frac.std(axis=0, ddof=1) / np.sqrt(replicates)


def write_fluxmap_csv(save_folder, scene: SphereScene, source: Source,
                      grid: DetectorGrid, n_rays: int, fm, *,
                      trace_once: bool, footer: dict | None = None,
                      verbose: bool = False) -> str | None:
    """Write a whole ``[n_theta, n_phi]`` map ``fm`` in the reference CSV
    dialect under ``save_folder`` (a fresh ``_1``-style name if the file
    exists): the metadata header for ``n_rays`` rays in the trace-once or
    retrace form, the rows, and the footer when ``footer`` gives
    ``FluxmapWriter.write_footer``'s arguments.  Returns the path, or None
    without a ``save_folder``."""
    if save_folder is None:
        return None
    meta = _metadata(scene, source, grid, n_rays, trace_once=trace_once)
    fname = fluxmap_filename(
        n_rays, grid.n_theta, grid.n_phi,
        (float(source.x), float(source.y), float(source.z)),
        trace_once=trace_once)
    with FluxmapWriter(os.path.join(save_folder, fname), meta) as w:
        w.write_map(grid.theta_centers().numpy(), grid.phi_centers().numpy(),
                    fm)
        if footer is not None:
            w.write_footer(**footer)
        path = w.path
    if verbose:
        print(f"\nFlux map data saved to '{path}'")
    return path


def _retrace_footer(total_s: float, fm, n_rays_per_pos: int,
                    n_positions: int) -> dict:
    """The retrace dialect's footer: hits summed over the map of
    fractions, out of ``n_rays_per_pos`` rays at every position."""
    return dict(total_time_s=total_s,
                total_hits=int(round(fm.sum() * n_rays_per_pos)),
                n_total=n_rays_per_pos * n_positions)


def sweep_detector_retrace(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays_per_pos: int = 50_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    notify: bool = False,
    pos_chunk: int | None = None,
    verbose: bool = True,
    resume_path: str | None = None,
    engine: str = "simulate",
    oversample: int = 128,
    mesh=None,
) -> SweepResult:
    """Fresh rays for every detector position on ``device``, in chunks of
    theta rows (one row by default; ``pos_chunk`` a multiple of ``n_phi``
    dividing the grid), each flushed to the CSV as it completes.  Chunk
    ``ci`` traces from ``fold_in(key, ci)``, so ``resume_path`` (a partial
    CSV of a killed run) continues exactly: its complete chunks are kept,
    a partial chunk is redone, and the result is written under a fresh
    ``_1``-style name.

    ``engine="simulate"`` (default) traces ``n_rays_per_pos`` rays per
    position, the exact law of ``sweepDetector``; ``engine="binomial"``
    draws each cell around one shared ``oversample * n_rays_per_pos``-ray
    trace (``fluxmap_retrace_binomial``): one shot, so no resume.

    ``mesh``: split each position's rays over the mesh's ranks
    (``parallel.sharded_retrace`` / ``sharded_retrace_binomial``: counts
    add across ranks, one sum).  The sharded simulate sweep computes the
    whole map in one call, so the per-chunk flush and ``resume_path`` do
    not apply."""
    validate(scene, source)
    if engine == "binomial":
        if resume_path is not None:
            raise ValueError(
                "engine='binomial' computes the whole map at once — there "
                "is no chunked flush to resume; drop resume_path "
                "(re-running is cheaper than the partial CSV)")
        return _retrace_binomial(scene, source, n_rays_per_pos, grid, seed,
                                 cfg, save_folder, notify, verbose,
                                 oversample, device, mesh)
    if engine != "simulate":
        raise ValueError(f"unknown retrace engine {engine!r}")
    if mesh is not None:
        if resume_path is not None:
            raise ValueError("mesh retrace computes the whole map in one "
                             "sharded call — no chunked flush to resume")
        return _retrace_sharded(scene, source, n_rays_per_pos, grid, seed,
                                cfg, save_folder, notify, verbose, mesh,
                                device)
    t_all0 = time.perf_counter()
    key = torch.Generator().manual_seed(seed)
    P = grid.n_positions
    if pos_chunk is None:
        rows_per_chunk = 1
        pos_chunk = grid.n_phi
    else:
        if P % pos_chunk:
            raise ValueError("pos_chunk must divide n_theta*n_phi")
        if pos_chunk % grid.n_phi:
            raise ValueError("pos_chunk must be a multiple of n_phi "
                             "(chunking is by theta rows)")
        rows_per_chunk = pos_chunk // grid.n_phi
    n_chunks = P // pos_chunk
    C_all, N_all = grid_centers_normals(grid, scene.exit_port_z, device)
    sub_shape = dataclasses.replace(grid, n_theta=rows_per_chunk)
    th = grid.theta_centers().numpy()
    ph = grid.phi_centers().numpy()
    meta = _metadata(scene, source, grid, n_rays_per_pos, trace_once=False)

    done_rows = 0
    writer = None
    fm = np.zeros((grid.n_theta, grid.n_phi))
    if resume_path is not None and os.path.exists(resume_path):
        _, _, frac_r, _ = read_fluxmap(resume_path)
        done_rows = len(frac_r) // grid.n_phi
        # align to the chunk boundary: a partial chunk's rows are redone
        done_rows -= done_rows % rows_per_chunk
        fm[:done_rows] = frac_r[:done_rows * grid.n_phi].reshape(
            done_rows, grid.n_phi)
        writer = FluxmapWriter(resume_path, meta, make_unique=True)
        writer.write_map(th[:done_rows], ph, fm[:done_rows])
        if verbose:
            print(f"Resuming after {done_rows} completed theta rows")
    if writer is None and save_folder is not None:
        fname = fluxmap_filename(
            n_rays_per_pos, grid.n_theta, grid.n_phi,
            (float(source.x), float(source.y), float(source.z)),
            trace_once=False)
        writer = FluxmapWriter(os.path.join(save_folder, fname), meta)

    eta = EtaTracker(total=n_chunks)
    eta.done = done_rows // rows_per_chunk
    t_trace = 0.0
    for ci in range(done_rows // rows_per_chunk, n_chunks):
        row0 = ci * rows_per_chunk
        sl = slice(row0 * grid.n_phi, (row0 + rows_per_chunk) * grid.n_phi)
        t0 = time.perf_counter()
        counts = fluxmap_retrace(
            fold_in(key, ci), scene, source, sub_shape, n_rays_per_pos, cfg,
            pos_chunk=min(32, pos_chunk),
            centers_normals=(C_all[sl], N_all[sl]), device=device)
        rows = counts.cpu().numpy().astype(np.float64) / n_rays_per_pos
        t_trace += time.perf_counter() - t0
        fm[row0:row0 + rows_per_chunk] = rows
        if writer is not None:
            writer.write_map(th[row0:row0 + rows_per_chunk], ph, rows)
        line = eta.tick()
        if verbose:
            print(f"Completed theta rows {row0}-{row0 + rows_per_chunk - 1}"
                  f" ({eta.percent:.1f}%)")
            if line:
                print("  " + line)

    total = time.perf_counter() - t_all0
    path = None
    if writer is not None:
        writer.write_footer(**_retrace_footer(total, fm, n_rays_per_pos, P))
        path = writer.path
        writer.close()
        if verbose:
            print(f"\nFlux map data saved to '{path}'")
    if notify:
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pos, t_trace,
                       total - t_trace, total)


def _whole_map_retrace(run, stamps, scene, source, n_rays_per_pos, grid,
                       save_folder, notify, verbose, mesh):
    """A retrace map computed in one call, ``run() -> counts``: timed
    between the two ``stamps``, written in the retrace CSV dialect with
    its footer (by rank 0 under a mesh)."""
    t_all0 = time.perf_counter()
    verbose = verbose and is_rank0(mesh)
    if verbose:
        debug_stamp(stamps[0])
    t0 = time.perf_counter()
    fm = run().cpu().numpy().astype(np.float64) / n_rays_per_pos
    t_trace = time.perf_counter() - t0
    if verbose and stamps[1]:
        debug_stamp(stamps[1].format(t_trace))
    total = time.perf_counter() - t_all0
    path = on_rank0(mesh, lambda: write_fluxmap_csv(
        save_folder, scene, source, grid, n_rays_per_pos, fm,
        trace_once=False, verbose=verbose,
        footer=_retrace_footer(total, fm, n_rays_per_pos, grid.n_positions)))
    if notify and is_rank0(mesh):
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pos, t_trace,
                       total - t_trace, total)


def _retrace_sharded(scene, source, n_rays_per_pos, grid, seed, cfg,
                     save_folder, notify, verbose, mesh, device):
    """``mesh`` body of the simulate-engine ``sweep_detector_retrace``:
    the whole honest retrace map as one sharded call (each position's rays
    split over the ranks, one sum), same CSV dialect and footer."""
    from ..parallel import sharded_retrace

    mesh.check_device(device)
    key = torch.Generator().manual_seed(seed)
    return _whole_map_retrace(
        lambda: sharded_retrace(mesh, key, scene, source, grid,
                                n_rays_per_pos, cfg),
        (f"Sharded retrace over {mesh.world_size} devices", None),
        scene, source, n_rays_per_pos, grid, save_folder, notify, verbose,
        mesh)


def _retrace_binomial(scene, source, n_rays_per_pos, grid, seed, cfg,
                      save_folder, notify, verbose, oversample, device,
                      mesh=None):
    """The ``engine="binomial"`` body of ``sweep_detector_retrace``: the
    whole map at once, same CSV dialect and footer."""
    key = torch.Generator().manual_seed(seed)
    if mesh is not None:
        from ..parallel import sharded_retrace_binomial

        mesh.check_device(device)

        def run():
            return sharded_retrace_binomial(mesh, key, scene, source, grid,
                                            n_rays_per_pos, cfg,
                                            oversample=oversample)
    else:
        def run():
            return fluxmap_retrace_binomial(key, scene, source, grid,
                                            n_rays_per_pos, cfg, oversample,
                                            device=device)
    return _whole_map_retrace(
        run, (f"Binomial retrace: sampling {oversample}x{n_rays_per_pos} "
              "shared rays", "Binomial retrace completed in {:.4f} s"),
        scene, source, n_rays_per_pos, grid, save_folder, notify, verbose,
        mesh)


def sweep_detector_twofold(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays_per_pair: int = 50_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    save_folder: str | None = "results",
    notify: bool = False,
    verbose: bool = True,
    mesh=None,
) -> SweepResult:
    """Twofold reuse: one fresh batch per antipodal position pair (phi,
    phi + 180), scored against both (``sweepDetectorTwofold``,
    ``fluxAtObserverFast.C:656-714``).  Pair ``i * n_phi/2 + j`` traces
    from ``fold_in(key, i * n_phi/2 + j)``.  Needs an even ``n_phi`` over a
    full 360-degree phi span.  ``mesh``: split each pair's batch over the
    mesh's ranks (``parallel.sharded_twofold_pair``, one sum per pair)."""
    if grid.n_phi % 2:
        raise ValueError("twofold needs an even n_phi")
    if abs((grid.phi_hi - grid.phi_lo) - 360.0) > 1e-9:
        raise ValueError(
            "twofold pairs detectors 180 deg apart, which maps onto the "
            "j + n_phi/2 column only for a full 360-degree phi span")
    if grid.n_positions > 1000:
        import warnings

        warnings.warn(
            "twofold re-traces a fresh batch per antipodal position pair "
            f"({grid.n_positions // 2} traces) — it exists for methodology "
            "parity with sweepDetectorTwofold; use sweep_detector_trace_once "
            "for production maps", stacklevel=2)
    validate(scene, source)
    t0_all = time.perf_counter()
    key = torch.Generator().manual_seed(seed)
    th_host = grid.theta_centers()
    th = th_host.to(device)
    ph = grid.phi_centers().to(device)
    half = grid.n_phi // 2
    half_w = grid.width / 2.0

    if mesh is not None:
        from ..parallel import sharded_twofold_pair

        mesh.check_device(device)

        def pair_counts(k, theta, phi):
            # the route sums the rim overflow over the ranks and raises
            return sharded_twofold_pair(mesh, k, scene, source, grid,
                                        n_rays_per_pair, cfg, theta,
                                        phi).tolist() + [0]
    else:
        def pair_counts(k, theta, phi):
            res, rim = trace_rays_auto(k, scene, source, n_rays_per_pair,
                                       cfg, device=device)
            out = []
            for p in (phi, phi + 180.0):
                c, n = detector_position(theta, p, grid.radius,
                                         scene.exit_port_z)
                out.append(hits_single_detector(res, c, n, half_w,
                                                scene.exit_port_z))
            return torch.stack(out + [rim.total]).tolist()

    fm = np.zeros((grid.n_theta, grid.n_phi))
    eta = EtaTracker(total=grid.n_theta * half)
    t_trace = 0.0
    for i in range(grid.n_theta):
        for j in range(half):
            t0 = time.perf_counter()
            cnt = pair_counts(fold_in(key, i * half + j), th[i], ph[j])
            t_trace += time.perf_counter() - t0
            if cnt[2]:
                raise RuntimeError(f"twofold: {cnt[2]} rim-clipped rays "
                                   "unfinished; investigate")
            fm[i, j] = cnt[0] / n_rays_per_pair
            fm[i, j + half] = cnt[1] / n_rays_per_pair
            eta.tick()
        if verbose and is_rank0(mesh):
            print(f"theta={float(th_host[i]):.2f} done "
                  f"({eta.percent:.1f}%)")

    total = time.perf_counter() - t0_all
    path = on_rank0(mesh, lambda: write_fluxmap_csv(
        save_folder, scene, source, grid, n_rays_per_pair, fm,
        trace_once=False,
        footer=_retrace_footer(total, fm, n_rays_per_pair, grid.n_positions)))
    if notify and is_rank0(mesh):
        notify_bell()
    return SweepResult(path, fm, -1, n_rays_per_pair, t_trace,
                       total - t_trace, total)
