"""Detector readout for the trace-once flux map — the counterpart of the
trace-once part of ``altair_tpu/core/score.py``.

Every exiting ray's final segment is tested against all detector positions
at once.  The production scorer ("mxu" in the JAX package) writes the disk
test as a quadratic form in the ray's Plucker coordinates, so a chunk of
positions costs one ``[N, 21] x [21, P]`` float32 matrix product plus a
``[N, 3] x [3, P]`` parallel guard; "exact" keeps the direct per-pair
plane/disk arithmetic.  Positions are scored in chunks to bound the
``[N, P_chunk]`` working set.
"""

from __future__ import annotations

import math

import torch

from ..config import DetectorGrid, SphereScene, SurfaceModel
from .geometry import detector_position
from .trace import TraceResult

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
    E = E.to(torch.float32)
    D = D.to(torch.float32)
    C, Nrm = grid_centers_normals(grid, exit_port_z, dev)
    P = grid.n_positions
    chunk = min(pos_chunk, P)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    if pad:
        C = torch.cat([C, C.new_zeros((pad, 3))])
        # pad normals with +z so padded positions are valid-but-missed
        padn = Nrm.new_zeros((pad, 3))
        padn[:, 2] = 1.0
        Nrm = torch.cat([Nrm, padn])
    half_w = grid.width / 2.0

    if method == "mxu":
        # anchor the Plucker frame at the port centre: the moment features
        # shrink ~34x, so f32 rounding at the disk edge shrinks with them
        C_rel = C.clone()
        C_rel[:, 2] -= exit_port_z
        E_rel = E.clone()
        E_rel[:, 2] -= exit_port_z
        W = _plucker_weights(C_rel, Nrm, half_w)
        Phi = _plucker_features(E_rel, D)
        counts = [_hits_block_mxu(Phi, D, rowmask, W[i:i + chunk],
                                  Nrm[i:i + chunk])
                  for i in range(0, n_chunks * chunk, chunk)]
    else:
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
