"""The plain reference's focal-surface disk of the in-sphere detector sweep,
in plain PyTorch, written from ``integratingSphereDetectorSweep.C``:
``addDetectorDisk`` (``:145-172``) places the disk and
``isRayHittingDetector`` (``:134-143``) decides a hit.  The tracer is
``portbench.reference``'s, which takes the thick rim in its loop.  Imports
nothing of ``altair_tpu_torch``.

``probabilities`` gives each disk's hit probability from one traced batch
(the disk sits outside the sphere, so one batch scored against every disk
has each disk's law); ``sweep`` runs the macro's method, fresh rays for
every disk.

Placement: the disk's centre lies at ``placement_radius`` from the
ORIGIN at polar angle theta (from -z) and azimuth phi.  Its axis is the
tube's local z turned by the macro's ``rot->RotateZ(rotPhi);
rot->RotateY(rotTheta)``: ROOT's ``TGeoRotation::Rotate*`` multiply on
the left, so the matrix is ``R_y(rotTheta) @ R_z(rotPhi)``, with
``rotTheta = -atan2(hypot(v_x, v_y), v_z)`` and ``rotPhi = atan2(v_y,
v_x)`` of the offset ``v`` from the centre to the port's centre.

Hit: a ray that left the sphere meets the disk when its final segment,
from its start forward along its direction (t >= 0; the disk absorbs it,
so the macro's node history holds the disk only on the way out), crosses
the disk's plane within the radius, and is not parallel to the plane
(``|d.n| >= 1e-10``).  In float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference

PARALLEL_EPS = 1e-10


def disk_angles(disks: dict):
    """The sweep's ``(theta, phi)`` in degrees, theta-major: theta over
    ``[-theta_max, theta_max]`` in steps of ``dtheta`` (the macro's
    ``theta <= thetaMax`` loop), phi over ``[0, 360)`` in steps of
    ``dphi``.  Numpy float64 arrays."""
    thetas = np.arange(-disks["theta_max"],
                       disks["theta_max"] + disks["dtheta"] / 2,
                       disks["dtheta"])
    phis = np.arange(0.0, 360.0, disks["dphi"])
    return np.repeat(thetas, len(phis)), np.tile(phis, len(thetas))


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def disk_positions(disks: dict, port_z: float, dtype=torch.float64,
                   device="cpu", aimed: bool = False):
    """Centres and unit normals ``[P, 3]`` of every disk of the sweep.
    ``aimed``: the normal along the offset to the port's centre, which the
    macro's comment describes and its rotation does not give."""
    th, ph = disk_angles(disks)
    r = float(disks["placement_radius"])
    centres, normals = [], []
    for t_deg, p_deg in zip(th, ph):
        t, p = math.radians(t_deg), math.radians(p_deg)
        c = np.array([r * math.sin(t) * math.cos(p),
                      r * math.sin(t) * math.sin(p), -r * math.cos(t)])
        v = np.array([0.0, 0.0, port_z]) - c
        if aimed:
            n = v / np.linalg.norm(v)
        else:
            rot_theta = -math.atan2(math.hypot(v[0], v[1]), v[2])
            rot_phi = math.atan2(v[1], v[0])
            n = _rot_y(rot_theta) @ _rot_z(rot_phi) @ np.array([0.0, 0.0, 1.0])
        centres.append(c)
        normals.append(n)
    return (torch.tensor(np.array(centres), dtype=dtype, device=device),
            torch.tensor(np.array(normals), dtype=dtype, device=device))


def hit(seg, direction, centre, normal, radius: float):
    """Whether each segment (start ``seg``, direction ``direction``) meets
    the disk of centre ``centre`` and normal ``normal`` (rows that
    broadcast against the segments), in float64."""
    s = seg.to(torch.float64)
    d = direction.to(torch.float64)
    c = centre.to(torch.float64)
    n = normal.to(torch.float64)
    dn = (d * n).sum(-1)
    t = -((s - c) * n).sum(-1) / torch.where(dn == 0, torch.ones_like(dn),
                                             dn)
    q = s + d * t[..., None] - c
    return ((dn.abs() >= PARALLEL_EPS) & (t >= 0)
            & ((q * q).sum(-1) <= radius * radius))


def score(seg, direction, centres, normals, radius: float,
          pair_block: int = 1 << 26):
    """Every exit segment against every disk.  Returns ``(counts [P]
    int64, per_ray [k] int64)``: the hits of each disk, and the disks each
    segment hits."""
    P = centres.shape[0]
    counts = torch.zeros(P, dtype=torch.int64, device=seg.device)
    per_ray = torch.zeros(seg.shape[0], dtype=torch.int64, device=seg.device)
    step = max(1, pair_block // max(1, P))
    for i in range(0, seg.shape[0], step):
        h = hit(seg[i:i + step, None, :], direction[i:i + step, None, :],
                centres[None], normals[None], radius)
        counts += h.sum(0)
        per_ray[i:i + step] = h.sum(1)
    return counts, per_ray


def probabilities(scene: dict, source: dict, disks: dict, n_rays: int,
                  gen: torch.Generator, device="cpu"):
    """``(p [P], hits_var, exit_fraction)`` from ``n_rays`` rays traced in
    float64: each disk's hit probability, the variance of one ray's number
    of disk hits (the disks overlap), and the share of rays that left."""
    ex = reference.trace(scene, source, n_rays, gen, torch.float64, device)
    centres, normals = disk_positions(disks, float(scene["exit_port_z"]),
                                      torch.float64, device)
    counts, per_ray = score(ex.seg_start, ex.direction, centres, normals,
                            float(disks["radius"]))
    h = per_ray.to(torch.float64)
    hits_var = float((h * h).sum()) / n_rays - (float(h.sum()) / n_rays) ** 2
    return (counts.to(torch.float64) / n_rays, hits_var,
            ex.seg_start.shape[0] / n_rays)


def sweep(scene: dict, source: dict, disks: dict, n_per_disk: int,
          gen: torch.Generator, dtype=torch.float64, device="cpu",
          aimed: bool = False):
    """The macro's sweep: ``n_per_disk`` fresh rays for every disk, traced
    in ``dtype`` as one batch whose rays are dealt to the disks in an order
    drawn from ``gen`` (the rays are exchangeable, so each disk's count is
    that of its own ``n_per_disk`` rays).  Returns ``[P]`` int64 hit
    counts."""
    centres, normals = disk_positions(disks, float(scene["exit_port_z"]),
                                      torch.float64, device, aimed)
    P = centres.shape[0]
    ex = reference.trace(scene, source, P * n_per_disk, gen, dtype, device)
    k = ex.seg_start.shape[0]
    slot = torch.randperm(P * n_per_disk, generator=gen, device=device)[:k]
    owner = slot // n_per_disk
    ok = hit(ex.seg_start, ex.direction, centres[owner], normals[owner],
             float(disks["radius"]))
    return torch.bincount(owner[ok], minlength=P)
