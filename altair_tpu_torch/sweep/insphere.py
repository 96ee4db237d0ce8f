"""In-geometry detector-disk sweep — the counterpart of
``altair_tpu/sweep/insphere.py`` (``integratingSphereDetectorSweep.C``).

The reference rebuilds the TGeo geometry for every disk position and
re-traces 100k rays per position (``:31-105``), detecting hits by scanning
the ray node history for a node named "detector" (``:134-143``).  The disk
sits outside the sphere (placed at r = 200 cm from the origin,
``:145-172``), so it cannot shadow the interior physics, and one traced
batch scored against every disk position is equivalent; the per-position
re-trace is kept too (``retrace=True``) for methodology parity.

Output: the ``detector_sweep3.txt`` dialect — ``Theta(deg)\\tPhi(deg)\\t
HitFraction`` rows over theta in [-thetaMax, thetaMax] (step dtheta) x
phi in {0, 180}.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import SphereScene, Source, TraceConfig
from ..core.geometry import Vec3
from ..core.score import (_lap_clock, _pad_positions, hits_insphere_disks,
                          insphere_disk_hit_mask, insphere_disk_position)
from ..core.trace import fold_in
from ..io.profiling import count, span
from ..parallel.mesh import on_rank0
# the disk lives outside the sphere, so any route's final-segment
# contract feeds the disk test (the corpus scene's thick shell takes the
# finish kernel from the source in float32, the in-loop rim tracers
# otherwise; thin-shell scenes get the direct sampler or the kernels)
from ..core.route import trace_rays_auto


@dataclasses.dataclass
class InsphereSweepResult:
    thetas: np.ndarray         # flattened sweep order (theta-major)
    phis: np.ndarray
    fractions: np.ndarray
    n_rays: int
    wall_time_s: float


def _score(res, cen, nrm, disk_radius, chunk=None):
    """The disk test of one traced batch under the span ``score.insphere``
    (``disks``, ``rays``), counted in ``insphere.disk_tests``: with
    ``chunk``, the batch's rays in ``chunk`` runs of fresh rays, each
    tested against its own disk (``cen``/``nrm`` per ray; ``[chunk]``
    counts); else every ray against every disk (``cen``/``nrm`` the
    ``[P, 3]`` placements; ``[P]`` counts)."""
    rays = res.status.shape[0]
    disks = cen.shape[0] if chunk is None else chunk
    with span("score.insphere", disks=disks, rays=rays):
        if chunk is None:
            counts = hits_insphere_disks(res, cen, nrm, disk_radius)
            count("insphere.disk_tests", rays * disks)
        else:
            ok = insphere_disk_hit_mask(res, cen, nrm, disk_radius)
            counts = ok.view(chunk, rays // chunk).sum(1, dtype=torch.int32)
            count("insphere.disk_tests", rays)
    return counts


def _retrace_counts(key, scene, source, C, Nrm, disk_radius, n_rays, cfg,
                    chunk, device, laps=None):
    """Fresh rays for every disk: chunk ``i`` traces ``n_rays * chunk`` rays
    from ``fold_in(key, i)``, and ray ``j`` belongs to disk ``i * chunk +
    j // n_rays``.  Returns ``([P] int32 counts, overflow)`` on the device.
    ``laps``: see ``sweep_insphere_detector``'s ``stats``; the chunks'
    bounce sums stay on the device until the caller reads them."""
    P = C.shape[0]
    n_chunks = -(-P // chunk)
    C, Nrm = _pad_positions(C, Nrm, n_chunks * chunk)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    counts = []
    lap = _lap_clock(laps, device)
    for i in range(n_chunks):
        t0 = time.perf_counter()
        res, rim = trace_rays_auto(fold_in(key, i), scene, source,
                                   n_rays * chunk, cfg, device=device)
        t1 = lap()
        overflow = overflow + rim.total
        sl = slice(i * chunk, (i + 1) * chunk)
        cen = Vec3(*C[sl].repeat_interleave(n_rays, 0).unbind(1))
        nrm = Vec3(*Nrm[sl].repeat_interleave(n_rays, 0).unbind(1))
        counts.append(_score(res, cen, nrm, disk_radius, chunk))
        if laps is not None:
            _add_laps(laps, lap, res, (t0, t1), chunk)
    return torch.cat(counts)[:P], overflow


def _add_laps(laps, lap, res, trace_lap, n_disks):
    """Record one batch's trace lap and the disk count's lap after it
    (both ended by a device sync, ``lap`` of ``_lap_clock``); the bounce
    sum is taken after both."""
    t2 = lap()
    rays = res.status.shape[0]
    laps["trace"].append({"start": trace_lap[0], "end": trace_lap[1],
                          "rays": rays,
                          "bounce_steps": res.n_bounces.sum(
                              dtype=torch.int64)})
    laps["score"].append({"start": trace_lap[1], "end": t2,
                          "disks": n_disks, "rays": rays})


def sweep_insphere_detector(
    scene: SphereScene,
    source: Source,
    *,
    device,
    disk_radius: float = 5.0,
    n_rays: int = 100_000,
    dtheta: float = 0.5,
    theta_max: float = 45.0,
    dphi: float = 180.0,
    placement_radius: float = 200.0,
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    retrace: bool = False,
    pos_chunk: int | None = None,
    save_path: str | None = "detector_sweep3.txt",
    aimed: bool = False,
    mesh=None,
    stats: dict | None = None,
) -> InsphereSweepResult:
    """Sweep the focal-surface disk over theta in [-theta_max, theta_max]
    (inclusive, like the reference's ``theta <= thetaMax`` loop) x phi in
    [0, 360) step dphi, tracing and scoring on ``device``.  Defaults
    replicate ``integratingSphereDetectorSweep():119-129`` (100k rays,
    dtheta 0.5, theta 45, disk r = 5 cm).

    ``aimed``: the aim-at-port disk normal instead of the reference's
    faithful (phi-independent, tilted) one; see ``insphere_disk_position``.
    ``retrace``: fresh rays per position, ``pos_chunk`` positions (default
    8) per trace with the key folded per chunk and the last chunk padded
    with disks that nothing hits; the positions are independent under the
    pseudorandom engines, and with ``cfg.qmc`` the direct sampler gives the
    positions of a chunk one Sobol block (unbiased means, correlated
    chunk-mates).  A nonzero trace overflow raises.
    ``mesh``: split the ray axis over the mesh's ranks for both
    methodologies (``parallel.sharded_insphere``, one sum); ``pos_chunk``
    is then per device (None: ``sharded_insphere``'s default), and rank 0
    writes ``save_path``.
    ``stats``: a dict to time the single-device sweep in; it receives
    ``"trace"`` and ``"score"``, one lap per traced batch each (a chunk, or
    the one trace-once batch): ``start`` and ``end`` on the host clock
    (``time.perf_counter``), each ended by a device sync, with ``rays`` and
    ``bounce_steps`` (the batch's ``n_bounces`` sum) for the trace and
    ``disks`` and ``rays`` for the disk count.  The syncs and the bounce
    sums are only taken when ``stats`` is given; the results are the same.

    The span ``sweep.insphere`` (``positions``, ``chunks``, ``n_rays``,
    ``retrace``) holds each batch's ``trace`` and ``score.insphere``."""
    if stats is not None and mesh is not None:
        raise ValueError("stats= times the single-device sweep")
    thetas = np.arange(-theta_max, theta_max + dtheta / 2, dtheta)
    phis = np.arange(0.0, 360.0, dphi)
    with span("sweep.insphere", positions=len(thetas) * len(phis),
              n_rays=n_rays, retrace=bool(retrace)) as sp:
        return _sweep(sp, scene, source, device, disk_radius, n_rays,
                      thetas, phis, placement_radius, seed, cfg, retrace,
                      pos_chunk, save_path, aimed, mesh, stats)


def _sweep(sp, scene, source, device, disk_radius, n_rays, thetas, phis,
           placement_radius, seed, cfg, retrace, pos_chunk, save_path, aimed,
           mesh, stats):
    """``sweep_insphere_detector``'s body; names the chunks on ``sp``."""
    t0 = time.perf_counter()
    key = torch.Generator().manual_seed(seed)
    laps = (None if stats is None
            else {k: stats.setdefault(k, []) for k in ("trace", "score")})

    # disk centres/normals for all positions
    tt = np.repeat(thetas, len(phis))
    pp = np.tile(phis, len(thetas))
    centers, normals = insphere_disk_position(
        torch.tensor(tt, dtype=torch.float32, device=device),
        torch.tensor(pp, dtype=torch.float32, device=device),
        placement_radius, scene.exit_port_z, aimed=aimed)
    C, Nrm = centers.stack(), normals.stack()

    if mesh is not None:
        from ..parallel import sharded_insphere

        mesh.check_device(device)
        # the route sums the overflow over the ranks and raises
        counts = sharded_insphere(mesh, key, scene, source, C, Nrm,
                                  disk_radius, n_rays, cfg, retrace=retrace,
                                  pos_chunk=pos_chunk)
        overflow = torch.zeros_like(counts[0])
    elif retrace:
        chunk = min(8 if pos_chunk is None else pos_chunk, len(tt))
        sp.set(chunks=-(-len(tt) // chunk))
        counts, overflow = _retrace_counts(key, scene, source, C, Nrm,
                                           float(disk_radius), n_rays, cfg,
                                           chunk, device, laps)
    else:
        sp.set(chunks=1)
        lap = _lap_clock(laps, device)
        t_tr = time.perf_counter()
        res, rim = trace_rays_auto(key, scene, source, n_rays, cfg,
                                   device=device)
        t_end = lap()
        counts = _score(res, C, Nrm, float(disk_radius))
        overflow = rim.total
        if laps is not None:
            _add_laps(laps, lap, res, (t_tr, t_end), len(tt))
    *counts, overflow = torch.cat([counts, overflow.reshape(1)]).tolist()
    if laps is not None:
        for lap in laps["trace"]:
            if isinstance(lap["bounce_steps"], torch.Tensor):
                lap["bounce_steps"] = int(lap["bounce_steps"])
    if overflow:
        raise RuntimeError(
            f"in-sphere sweep: {overflow} rays unfinished — statistically "
            "impossible at the planned capacities; investigate")
    frac = np.asarray(counts, np.float64) / n_rays

    wall = time.perf_counter() - t0

    def write():
        with open(save_path, "w") as fh:
            fh.write("Theta(deg)\tPhi(deg)\tHitFraction\n")
            for th, ph_, fr in zip(tt, pp, frac):
                fh.write(f"{_fmt(th)}\t{_fmt(ph_)}\t{_fmt(fr)}\n")

    if save_path:
        on_rank0(mesh, write)
    return InsphereSweepResult(tt, pp, frac, n_rays, wall)


def _fmt(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits,
    trailing-zero free) used by the reference's ``outFile << theta``."""
    return f"{v:.6g}"


def read_detector_sweep(path: str):
    """Parse the ``detector_sweep*.txt`` dialect back."""
    rows = []
    with open(path) as fh:
        header = fh.readline()
        assert "Theta" in header
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                rows.append([float(p) for p in parts[:3]])
    a = np.asarray(rows)
    return a[:, 0], a[:, 1], a[:, 2]
