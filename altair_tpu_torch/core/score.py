"""Detector readout — the counterpart of ``altair_tpu/core/score.py``.

Trace-once: every exiting ray's final segment is tested against all
detector positions at once.  The production scorer ("mxu" in the JAX
package) writes the disk test as a quadratic form in the ray's Plucker
coordinates, so a chunk of positions costs one ``[N, 21] x [21, P]``
float32 matrix product plus a ``[N, 3] x [3, P]`` parallel guard; "exact"
keeps the direct per-pair plane/disk arithmetic.  Positions are scored in
chunks to bound the ``[N, P_chunk]`` working set.

Retrace: fresh rays per position (``fluxmap_retrace``), or each cell drawn
from its binomial law around one shared trace's hit probabilities
(``fluxmap_retrace_binomial``).  Exit histograms: the signed port-axis
angle and the cos-z payloads of the distribution run.  The in-sphere
focal-surface disk of ``integratingSphereDetectorSweep.C`` closes the file.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..config import DetectorGrid, SphereScene, Source, SurfaceModel, TraceConfig
from .geometry import Vec3, detector_position, line_hits_disk
from .trace import (EXITED, TraceResult, device_generator, f32, fold_in,
                    split)

PARALLEL_EPS = 1e-10  # fluxAtObserver.C:78


def _check_matmul_precision():
    """The pair terms cancel: reduced-precision matmul inputs produced up
    to 40% spurious hits per detector row on the TPU (bf16).  TF32 is the
    same hazard on the card, so the scorer refuses to run under it."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the scorer needs full float32 matmuls: set "
            "torch.set_float32_matmul_precision('highest') and "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def grid_centers_normals(grid: DetectorGrid, exit_port_z=-100.0,
                         device="cpu"):
    """All P = n_theta*n_phi detector centres/normals as ``[P, 3]`` tensors
    on ``device``, theta-major like the reference's sweep loops."""
    th = grid.theta_centers().to(device)
    ph = grid.phi_centers().to(device)
    th2 = th.repeat_interleave(grid.n_phi)
    ph2 = ph.repeat(grid.n_theta)
    c, n = detector_position(th2, ph2, grid.radius, exit_port_z)
    return c.stack(), n.stack()


def _pad_positions(C, Nrm, n_rows: int):
    """Pad ``[P, 3]`` centres with zeros and normals with +z up to
    ``n_rows`` rows: the padded positions are valid but never hit."""
    pad = n_rows - C.shape[0]
    if not pad:
        return C, Nrm
    padn = Nrm.new_zeros((pad, 3))
    padn[:, 2] = 1.0
    return torch.cat([C, C.new_zeros((pad, 3))]), torch.cat([Nrm, padn])


def _hits_block(E, D, rowmask, C, Nrm, half_w):
    """Hit counts of every (ray, position) pair of one position block by
    the direct plane/disk arithmetic (``Detector::checkIntersection``,
    ``fluxAtObserver.C:70-107``).  Returns ``[P]`` int32 counts."""
    dn = D @ Nrm.T                          # [N,P]  d . n_p
    en = E @ Nrm.T                          # [N,P]  e . n_p
    ec = E @ C.T                            # [N,P]  e . c_p
    dc = D @ C.T                            # [N,P]  d . c_p
    cn = (C * Nrm).sum(dim=1)               # [P]
    c2 = (C * C).sum(dim=1)                 # [P]
    e2 = (E * E).sum(dim=1)                 # [N]
    ed = (E * D).sum(dim=1)                 # [N]
    safe_dn = torch.where(dn == 0, torch.ones_like(dn), dn)
    t = -(en - cn[None, :]) / safe_dn
    # |e + t d - c|^2 with |d| = 1
    r2 = (e2[:, None] + c2[None, :] - 2.0 * ec) + t * (2.0 * (ed[:, None] - dc) + t)
    hit = (torch.abs(dn) >= PARALLEL_EPS) & (r2 <= half_w * half_w)
    hit &= rowmask[:, None]
    return hit.sum(dim=0, dtype=torch.int32)


def _plucker_weights(C, Nrm, half_w):
    """``[P, 21]`` upper-triangle weights of the symmetric 6x6 form M_p with
    r^T M_p r <= 0  <=>  the line r = (m, d) hits disk p (off-diagonals
    doubled); see the JAX function for the derivation."""
    P = C.shape[0]
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    nnT = Nrm[:, :, None] * Nrm[:, None, :]                 # [P,3,3]
    A = eye[None] - nnT
    cxn = torch.linalg.cross(C, Nrm, dim=1)
    cn = (C * Nrm).sum(dim=1)
    zeros = torch.zeros((P,), dtype=C.dtype, device=C.device)
    nx, ny, nz = Nrm[:, 0], Nrm[:, 1], Nrm[:, 2]
    n_x = torch.stack([
        torch.stack([zeros, -nz, ny], dim=-1),
        torch.stack([nz, zeros, -nx], dim=-1),
        torch.stack([-ny, nx, zeros], dim=-1),
    ], dim=-2)                                              # [P,3,3]
    B = -(cxn[:, :, None] * Nrm[:, None, :]) - cn[:, None, None] * n_x
    BtB = (B[:, :, :, None] * B[:, :, None, :]).sum(dim=1)  # B^T B
    M = torch.cat([
        torch.cat([A, B], dim=2),
        torch.cat([B.transpose(1, 2), BtB - (half_w * half_w) * nnT], dim=2),
    ], dim=1)                                               # [P,6,6]
    iu0, iu1 = torch.triu_indices(6, 6, device=C.device)
    w = M[:, iu0, iu1]
    return torch.where((iu0 != iu1)[None, :], 2.0 * w, w)   # [P,21]


def _plucker_features(E, D):
    """``[N, 21]`` upper-triangle products of r = (m, d), m = E x D."""
    r6 = torch.cat([torch.linalg.cross(E, D, dim=1), D], dim=1)
    iu0, iu1 = torch.triu_indices(6, 6, device=E.device)
    return r6[:, iu0] * r6[:, iu1]


def _hits_block_mxu(Phi, D, rowmask, W, Nrm):
    """Plucker pair test for one position block: one ``[N,21] x [21,P]``
    product for the disk condition (multiplied through by (d.n)^2, so no
    division) plus the ``[N,3] x [3,P]`` parallel guard."""
    s = Phi @ W.T                          # [N,P]  r^T M_p r
    dn = D @ Nrm.T                         # [N,P]  d . n_p
    hit = (s <= 0.0) & (torch.abs(dn) >= PARALLEL_EPS) & rowmask[:, None]
    return hit.sum(dim=0, dtype=torch.int32)


def _score_grid(E, D, rowmask, grid: DetectorGrid, exit_port_z, pos_chunk,
                method: str = "mxu"):
    """Chunked [rays x positions] scoring core of the trace-once scorers;
    returns ``[n_theta, n_phi]`` int32 counts."""
    if method not in ("mxu", "exact"):
        raise ValueError(f"unknown scoring method {method!r}")
    _check_matmul_precision()
    dev = E.device
    D = D.to(torch.float32)
    C, Nrm = grid_centers_normals(grid, exit_port_z, dev)
    P = grid.n_positions
    chunk = min(pos_chunk, P)
    n_chunks = -(-P // chunk)
    C, Nrm = _pad_positions(C, Nrm, n_chunks * chunk)
    half_w = grid.width / 2.0

    if method == "mxu":
        # anchor the Plucker frame at the port centre: the moment features
        # shrink ~34x, so f32 rounding at the disk edge shrinks with them
        anchor = torch.tensor([0.0, 0.0, f32(exit_port_z)], device=dev)
        W = _plucker_weights(C - anchor, Nrm, half_w)
        # subtract in E's own dtype, then cast: for a float64 trace the
        # anchoring cancellation runs at full precision and the float32
        # features carry the small relative coordinates
        E_rel = (E - anchor.to(E.dtype)).to(torch.float32)
        Phi = _plucker_features(E_rel, D)
        counts = [_hits_block_mxu(Phi, D, rowmask, W[i:i + chunk],
                                  Nrm[i:i + chunk])
                  for i in range(0, n_chunks * chunk, chunk)]
    else:
        E = E.to(torch.float32)
        counts = [_hits_block(E, D, rowmask, C[i:i + chunk],
                              Nrm[i:i + chunk], half_w)
                  for i in range(0, n_chunks * chunk, chunk)]
    return torch.cat(counts)[:P].reshape(grid.n_theta, grid.n_phi)


def fluxmap_trace_once(result: TraceResult, grid: DetectorGrid,
                       exit_port_z=-100.0, pos_chunk: int = 1080,
                       method: str = "mxu"):
    """The trace-once flux map: ``[n_theta, n_phi]`` hit COUNTS from a traced
    batch (``sweepDetectorTraceOnce``, ``fluxAtObserverFast.C:1068-1341``)."""
    mask = result.exited_port_mask(exit_port_z)
    return _score_grid(result.last_point.stack(), result.direction.stack(),
                       mask, grid, exit_port_z, pos_chunk, method)


def exit_capacity(scene: SphereScene, n_rays: int, sigmas: float = 6.0,
                  margin: float = 1.05) -> int:
    """Static upper bound on the exit count for compaction: the Lambertian
    exit fraction p/(p + 1-rho) plus ``sigmas`` binomial deviations and a
    relative margin; the full batch for other scatter laws."""
    from ..config import expected_exit_fraction

    if callable(scene.surface_model) or \
            SurfaceModel(scene.surface_model) != SurfaceModel.LAMBERTIAN:
        return n_rays
    p = expected_exit_fraction(scene.theta_max_deg, scene.reflectance)
    cap = p * n_rays * margin + sigmas * math.sqrt(
        max(p * (1 - p) * n_rays, 1.0))
    return min(n_rays, int(-(-cap // 8) * 8))


def fluxmap_trace_once_compact(result: TraceResult, grid: DetectorGrid,
                               capacity: int, exit_port_z=-100.0,
                               pos_chunk: int = 1080, method: str = "mxu"):
    """Trace-once scoring over the exit subset compacted into a
    ``capacity``-sized buffer.  Returns ``(counts, n_overflow)``;
    ``n_overflow > 0`` means that many exit rays went unscored — treat it
    as an error at the call site."""
    from .compact import nonzero_indices

    mask = result.exited_port_mask(exit_port_z)
    n = mask.shape[0]
    idx = nonzero_indices(mask, capacity, n)
    valid = idx < n
    take = torch.clamp(idx, max=n - 1)
    E = result.last_point.stack()[take]
    D = result.direction.stack()[take]
    n_overflow = mask.sum(dtype=torch.int32) - valid.sum(dtype=torch.int32)
    counts = _score_grid(E, D, valid, grid, exit_port_z, pos_chunk, method)
    return counts, n_overflow


def hits_single_detector(result: TraceResult, center: Vec3, normal: Vec3,
                         half_width, exit_port_z=-100.0) -> torch.Tensor:
    """Hit count for one detector position (the per-position scoring of
    ``traceRaysParallel``, ``fluxAtObserverOptimize.C:298-327``);
    ``center``/``normal`` broadcast against the rays."""
    mask = result.exited_port_mask(exit_port_z)
    hit = line_hits_disk(result.last_point, result.direction, center, normal,
                         half_width, PARALLEL_EPS)
    return (hit & mask).sum(dtype=torch.int32)


def fluxmap_retrace(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int | None = None,
    centers_normals=None,
    *,
    device,
) -> torch.Tensor:
    """The honest retrace sweep: fresh rays for every detector position
    (``sweepDetector``, ``fluxAtObserverOptimize.C:433-702``).  Returns
    ``[n_theta, n_phi]`` int32 hit counts on ``device``.

    Positions go in chunks of ``pos_chunk`` (default: 32, capped so a
    chunk stays under 2^22 rays); chunk ``i`` traces ``n_per_pos *
    pos_chunk`` rays from ``fold_in(gen, i)``, and ray ``j`` belongs to
    position ``i * pos_chunk + j // n_per_pos``.  ``centers_normals``
    overrides the placement with ``([P, 3], [P, 3])`` tensors on
    ``device``.  A nonzero overflow of any chunk's trace raises."""
    counts, overflow = fluxmap_retrace_counts(
        gen, scene, source, grid, n_per_pos, cfg, pos_chunk,
        centers_normals, device=device)
    if int(overflow):
        raise RuntimeError(
            f"retrace overflow: {int(overflow)} rays unfinished — "
            "statistically impossible at the planned capacities; investigate")
    return counts


def fluxmap_retrace_counts(gen, scene, source, grid, n_per_pos,
                           cfg=TraceConfig(), pos_chunk=None,
                           centers_normals=None, *, device):
    """``fluxmap_retrace`` without its check: ``(counts, overflow)``, the
    map and the rays its traces left unfinished (a 0-d int32 tensor), for
    a caller that sums the overflow over ranks before it tests it."""
    from .trace_waves import trace_rays_auto

    if pos_chunk is None:
        pos_chunk = max(1, min(32, (1 << 22) // max(n_per_pos, 1)))
    if centers_normals is not None:
        C, Nrm = centers_normals
    else:
        C, Nrm = grid_centers_normals(grid, scene.exit_port_z, device)
    P = grid.n_positions
    chunk = min(pos_chunk, P)
    n_chunks = -(-P // chunk)
    C, Nrm = _pad_positions(C, Nrm, n_chunks * chunk)
    half_w = grid.width / 2.0
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    counts = []
    for i in range(n_chunks):
        res, rim = trace_rays_auto(fold_in(gen, i), scene, source,
                                   n_per_pos * chunk, cfg, device=device)
        overflow = overflow + rim.total
        sl = slice(i * chunk, (i + 1) * chunk)
        cen = Vec3(*C[sl].repeat_interleave(n_per_pos, 0).unbind(1))
        nrm = Vec3(*Nrm[sl].repeat_interleave(n_per_pos, 0).unbind(1))
        hit = line_hits_disk(res.last_point, res.direction, cen, nrm, half_w,
                             PARALLEL_EPS)
        hit &= res.exited_port_mask(scene.exit_port_z)
        counts.append(hit.view(chunk, n_per_pos).sum(1, dtype=torch.int32))
    return (torch.cat(counts)[:P].reshape(grid.n_theta, grid.n_phi),
            overflow)


def binomial_pos_chunk(capacity: int) -> int:
    """``fluxmap_retrace_binomial``'s default position chunk for a shared
    sample of ``capacity`` exit slots: the ``[capacity, pos_chunk]``
    float32 block is capped at ~3 GB."""
    return max(8, min(256, (3 << 28) // max(capacity, 1)))


def _lap_clock(stats: dict | None, device):
    """``lap(name)``: when ``stats`` is a dict, wait for ``device`` and
    store the wall seconds since the previous lap (or since this call)
    under ``name``; otherwise do nothing."""
    last = [time.perf_counter()]

    def lap(name):
        if stats is None:
            return
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stats[name] = now - last[0]
        last[0] = now

    return lap


def fluxmap_retrace_binomial(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    oversample: int = 128,
    pos_chunk: int | None = None,
    method: str = "mxu",
    qmc: bool = True,
    *,
    device,
    stats: dict | None = None,
) -> torch.Tensor:
    """Retrace-statistics flux map sampled from the per-position binomial
    law: trace ``M = oversample * n_per_pos`` fresh rays once, score them
    against every position (hit counts ``X_p``, ``pi_hat = X_p / M``), and
    draw each cell from ``Binomial(n_per_pos, pi_hat_p)``.  Marginal means
    are exact and the relative excess variance over the true retrace cell
    is ``1 / oversample``; see the JAX function for the derivation.

    ``qmc=True`` draws the shared sample with Sobol uniforms (``cfg.qmc =
    1``) where the direct engine applies.  The trace and the draws take
    separate streams of ``gen``.  A compaction overflow is spread into
    ``pi_hat`` as in the JAX package; a nonzero overflow of the trace
    (``RimOverflow``) raises.  Returns ``[n_theta, n_phi]`` int32 counts
    (cells <= n_per_pos) on ``device``.

    ``stats``, when a dict, receives the wall seconds of the call's
    stages, each ended by a device sync: ``trace_s`` (the shared trace
    with its rim post-pass), ``score_s`` (the scoring chunks) and
    ``draw_s``; and ``compaction_overflow``, the exits the scorer's
    buffer could not hold."""
    from .trace_waves import trace_rays_auto

    if oversample < 2:
        raise ValueError("oversample must be >= 2: the shared "
                         "sample must exceed the per-position count")
    lap = _lap_clock(stats, device)
    M = int(oversample) * int(n_per_pos)
    cap = exit_capacity(scene, M)
    if pos_chunk is None:
        pos_chunk = binomial_pos_chunk(cap)
    if qmc and not cfg.qmc:
        cfg = dataclasses.replace(cfg, qmc=1)
    k_trace, k_draw = split(fold_in(gen, 0x51), 2)
    res, rim = trace_rays_auto(k_trace, scene, source, M, cfg, device=device)
    lap("trace_s")
    counts_M, overflow = fluxmap_trace_once_compact(
        res, grid, cap, scene.exit_port_z, pos_chunk, method)
    lap("score_s")
    cells = binomial_cells_from_counts(k_draw, counts_M, overflow, M,
                                       n_per_pos, grid.n_positions)
    lap("draw_s")
    if stats is not None:
        stats["compaction_overflow"] = int(overflow)
    if int(rim.total):
        raise RuntimeError(
            f"binomial retrace: {int(rim.total)} rim-clipped rays unfinished "
            "— statistically impossible at the planned capacity; investigate")
    return cells


def pi_hat(counts_M: torch.Tensor, overflow: torch.Tensor, M: int,
           n_positions: int) -> torch.Tensor:
    """Per-cell hit probability from the shared ``M``-ray sample, float32:
    the unscored ``overflow`` exits are spread over the cells, so the
    estimate stays conservative rather than silently low."""
    return (counts_M.to(torch.float32)
            + overflow.to(torch.float32) / n_positions) / M


def binomial_cells_from_counts(k_draw: torch.Generator, counts_M, overflow,
                               M: int, n_per_pos: int, n_positions: int):
    """The draw stage of the binomial retrace: ``pi_hat``, then an
    independent ``Binomial(n_per_pos, pi_hat)`` per cell from a generator
    on the counts' device seeded from the CPU key ``k_draw``."""
    p = pi_hat(counts_M, overflow, M, n_positions).clamp(0.0, 1.0)
    draws = torch.binomial(torch.full_like(p, float(n_per_pos)), p,
                           generator=device_generator(k_draw, p.device))
    return torch.nan_to_num(draws).to(torch.int32)


# ---------------------------------------------------------------------------
# Exit-direction histograms (distributionSphereDetectorSweep.C, 3dRayLog)
# ---------------------------------------------------------------------------

def _bin_counts(idx: torch.Tensor, take: torch.Tensor, n_bins: int):
    """``[n_bins]`` int32 counts of the ``idx`` entries where ``take``
    holds, accumulated on the device."""
    return torch.zeros((n_bins,), dtype=torch.int32,
                       device=idx.device).index_add_(
        0, idx.to(torch.int64), take.to(torch.int32))


def exit_angle_histogram(result: TraceResult, n_bins: int = 180,
                         lo: float = -90.0, hi: float = 90.0,
                         exit_port_z=-100.0) -> torch.Tensor:
    """Signed exit-angle histogram of port-exiting rays, 180 bins on
    [-90, 90] (``distributionSphereDetectorSweep.C:80-99``): theta =
    sign(dx) * (180 - acos(dz)) degrees, the angle from the -z port axis
    signed by the x-direction (the corrected convention of
    ``3drayanalysis.py:16``; see the JAX function)."""
    mask = result.exited_port_mask(exit_port_z)
    d = result.direction.normalized()
    theta = torch.sign(d.x) * (
        180.0 - torch.rad2deg(torch.arccos(torch.clamp(d.z, -1.0, 1.0))))
    idx = torch.clamp(((theta - lo) / (hi - lo) * n_bins).to(torch.int32),
                      0, n_bins - 1)
    in_range = (theta >= lo) & (theta < hi) & mask & torch.isfinite(theta)
    return _bin_counts(idx, in_range, n_bins)


def exit_directions(result: TraceResult, exit_port_z=-100.0):
    """(mask, dx, dy, dz) of exiting rays — the ``3dRayLog.txt`` payload
    (``3drayanalysis.py:5``)."""
    mask = result.exited_port_mask(exit_port_z)
    d = result.direction.normalized()
    return mask, d.x, d.y, d.z


def z_angle_histogram(dz, mask, n_bins: int = 100) -> torch.Tensor:
    """The cos-z binned ``angular_dist.txt`` payload: 100 bins over dz."""
    idx = torch.clamp(((dz + 1.0) / 2.0 * n_bins).to(torch.int32), 0,
                      n_bins - 1)
    return _bin_counts(idx, mask, n_bins)


# ---------------------------------------------------------------------------
# In-sphere focal-surface disk (integratingSphereDetectorSweep.C)
# ---------------------------------------------------------------------------

def insphere_disk_position(theta_deg, phi_deg, radius=200.0,
                           exit_port_z=-100.0, aimed: bool = False):
    """Disk placement of ``addDetectorDisk``
    (``integratingSphereDetectorSweep.C:145-172``): centre at spherical
    coordinates about the ORIGIN (r = 200 cm, theta from -z); ``theta_deg``
    and ``phi_deg`` are tensors.

    The normal reproduces the macro's actual rotation: ``rot->RotateZ(
    rotPhi); rot->RotateY(rotTheta)`` with ROOT's left-multiplying
    ``TGeoRotation::Rotate*``, so the composed matrix is ``R_y(rotTheta) @
    R_z(rotPhi)`` and the tube axis lands at ``(sin rotTheta, 0, cos
    rotTheta)`` with ``rotTheta = -atan2(hypot(dx, dy), dz)``: independent
    of phi.  The disks are aimed at the port only on the phi = 0 / theta >
    0 ray of the sweep and tilted everywhere else, and the retained
    ``detector_sweep*.txt`` corpus was produced with these tilted disks.
    ``aimed=True`` gives the aim-at-port normal the macro's comment
    describes."""
    th = torch.deg2rad(theta_deg)
    ph = torch.deg2rad(phi_deg)
    cx = radius * torch.sin(th) * torch.cos(ph)
    cy = radius * torch.sin(th) * torch.sin(ph)
    cz = -radius * torch.cos(th)
    d = Vec3(0.0 - cx, 0.0 - cy, exit_port_z - cz)
    if aimed:
        return Vec3(cx, cy, cz), d.normalized()
    rot_theta = -torch.atan2(torch.sqrt(d.x * d.x + d.y * d.y), d.z)
    normal = Vec3(torch.sin(rot_theta), torch.zeros_like(rot_theta),
                  torch.cos(rot_theta))
    return Vec3(cx, cy, cz), normal


def insphere_disk_hit_mask(result: TraceResult, center: Vec3, normal: Vec3,
                           disk_radius) -> torch.Tensor:
    """Bool per ray: the final segment hits the focal-surface disk.

    ``center``/``normal`` broadcast against the rays: scalars (0-d tensors
    or floats) for one disk, per-ray ``[N]`` tensors for a batched sweep, or
    ``[P, 1]`` tensors for all ``P`` disks at once (a ``[P, N]`` mask).  The
    disk takes part in the geometry (it absorbs the ray), so unlike the
    observer test the intersection must lie forward on the final segment
    (t >= 0).  The disk sits outside the sphere, so it can only intercept
    port-exiting rays, and the forward segment test equals the reference's
    node-history scan (``integratingSphereDetectorSweep.C:134-143``)."""
    p = result.seg_start
    d = result.direction
    dot = d.dot(normal)
    rel = p - center
    t = -rel.dot(normal) / torch.where(dot == 0, torch.ones_like(dot), dot)
    hit_pt = p + d.scale(t)
    r2 = (hit_pt - center).norm2()
    exited = result.status == EXITED
    return ((torch.abs(dot) >= PARALLEL_EPS) & (t >= 0)
            & (r2 <= disk_radius * disk_radius) & exited)


def hits_insphere_disk(result: TraceResult, center: Vec3, normal: Vec3,
                       disk_radius) -> torch.Tensor:
    """Hit count for one disk position (see ``insphere_disk_hit_mask``)."""
    return insphere_disk_hit_mask(result, center, normal,
                                  disk_radius).sum(dtype=torch.int32)


def hits_insphere_disks(result: TraceResult, centers: torch.Tensor,
                        normals: torch.Tensor, disk_radius,
                        pos_block: int = 32) -> torch.Tensor:
    """Hit counts ``[P]`` of one traced batch against ``P`` disks given as
    ``[P, 3]`` tensors: ``hits_insphere_disk`` for every position, as
    ``[pos_block, N]`` masks (``pos_block`` bounds the working set; the
    arithmetic per pair is that of the single-disk test)."""
    counts = []
    for i in range(0, centers.shape[0], pos_block):
        c = centers[i:i + pos_block]
        nn = normals[i:i + pos_block]
        hit = insphere_disk_hit_mask(
            result, Vec3(c[:, 0:1], c[:, 1:2], c[:, 2:3]),
            Vec3(nn[:, 0:1], nn[:, 1:2], nn[:, 2:3]), disk_radius)
        counts.append(hit.sum(dim=1, dtype=torch.int32))
    return torch.cat(counts)
