"""Analytic geometry primitives — the PyTorch counterpart of
``altair_tpu/core/geometry.py``.

The scene is one sphere shell with a polar-cap port inside a box, so the
intersections are closed form.  Vectors are structure-of-arrays: a ``Vec3``
holds three same-shaped ``[N]`` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector batch: three same-shaped tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def scale(self, s):
        return Vec3(self.x * s, self.y * s, self.z * s)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return torch.sqrt(self.norm2())

    def normalized(self, eps: float = 0.0):
        return self.scale(torch.rsqrt(self.norm2() + eps))

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, a.x, b.x),
                    torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))

    def stack(self):
        """Materialise as a dense ``[..., 3]`` tensor."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    """Branchless orthonormal basis about unit vector ``n`` (Duff et al.
    2017).  The sign is ``n.z >= 0`` (not ``copysign``: the two differ at
    -0.0, and parity with the JAX package needs the comparison)."""
    one = torch.ones_like(n.z)
    sign = torch.where(n.z >= 0, one, -one)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    u = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    v = Vec3(b, sign + n.y * n.y * a, -n.y)
    return u, v


def ray_sphere_exit_t(p: Vec3, d: Vec3, radius):
    """Distance along unit ``d`` from interior point ``p`` to ``|q| =
    radius``: t = -b + sqrt(b^2 - c), b = p.d, c = |p|^2 - r^2."""
    b = p.dot(d)
    c = p.norm2() - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return torch.clamp(-b + torch.sqrt(disc), min=0.0)


def sphere_hit(p: Vec3, d: Vec3, radius) -> Vec3:
    """Hit point on the sphere, re-projected onto the exact radius so fp32
    drift cannot accumulate over long bounce chains."""
    t = ray_sphere_exit_t(p, d, radius)
    q = p + d.scale(t)
    return q.scale(radius * torch.rsqrt(q.norm2()))


def in_port_cap(q: Vec3, radius, theta_max_rad):
    """True where sphere point ``q`` lies in the open polar cap (the exit
    port): polar angle from +z beyond ``theta_max`` (a tensor, radians).
    The shell of ``TGeoSphere(..., 0., thetaMax)``
    (``fluxAtObserverOptimize.C:204``) exists for theta in [0, thetaMax];
    the test is z < r*cos(theta_max), no acos."""
    return q.z < radius * torch.cos(theta_max_rad)


def ray_box_exit_t(p: Vec3, d: Vec3, half):
    """Distance from interior point ``p`` along unit ``d`` to the world box
    of half-width ``half`` (``fluxAtObserver.C:149``)."""

    def axis_t(pc, dc):
        face = torch.where(dc >= 0, half, -half)
        return torch.where(dc == 0, torch.full_like(pc, float("inf")),
                           (face - pc) / dc)

    return torch.minimum(axis_t(p.x, d.x),
                         torch.minimum(axis_t(p.y, d.y), axis_t(p.z, d.z)))


def cone_crossing_t(p: Vec3, d: Vec3, cos_theta_max, r_lo, r_hi,
                    inf: float = 1e30):
    """Smallest positive crossing of the port-rim cone (polar angle ==
    theta_max, z < 0 nappe) with radius in [r_lo, r_hi]; ``inf`` where
    none.  Cone: z^2 = cos^2(theta_max) |q|^2."""
    c2 = cos_theta_max * cos_theta_max
    dd = d.dot(d)
    A = d.z * d.z - c2 * dd
    B = 2.0 * (p.z * d.z - c2 * p.dot(d))
    C = p.z * p.z - c2 * p.norm2()
    one = torch.ones_like(A)
    big = torch.full_like(A, inf)
    small_a = torch.abs(A) < 1e-20
    safe_A = torch.where(small_a, one, A)
    disc = B * B - 4.0 * A * C
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_lin = torch.where(torch.abs(B) > 0, -C / torch.where(B == 0, one, B), big)
    roots = [
        torch.where(small_a, s_lin, (-B - sq) / (2.0 * safe_A)),
        torch.where(small_a, big, (-B + sq) / (2.0 * safe_A)),
    ]
    best = big
    for s in roots:
        q = p + d.scale(s)
        r = q.norm()
        ok = ((s > 1e-6) & (disc >= 0) & (q.z < 0)
              & (r >= r_lo - 1e-6) & (r <= r_hi + 1e-6))
        best = torch.where(ok & (s < best), s, best)
    return best


def cone_face_normal(p: Vec3) -> Vec3:
    """Unit normal of the rim cone face pointing into the hole side
    (theta_hat, the increasing-polar-angle direction)."""
    r = p.norm()
    rho = torch.sqrt(p.x * p.x + p.y * p.y)
    apex = rho < 1e-12
    safe_rho = torch.where(apex, torch.ones_like(rho), rho)
    nx = p.z / r * p.x / safe_rho
    ny = p.z / r * p.y / safe_rho
    nz = -rho / r
    return Vec3(torch.where(apex, torch.ones_like(nx), nx),
                torch.where(apex, torch.zeros_like(ny), ny),
                torch.where(apex, torch.zeros_like(nz), nz))


def sphere_crossing_t(p: Vec3, d: Vec3, radius, inf: float = 1e30):
    """Smallest positive crossing of ``|q| = radius`` from anywhere (inside
    or outside); ``inf`` where none."""
    b = p.dot(d)
    c = p.norm2() - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s1 = -b - sq
    s2 = -b + sq
    big = torch.full_like(b, inf)
    return torch.where((disc >= 0) & (s1 > 1e-6), s1,
                       torch.where((disc >= 0) & (s2 > 1e-6), s2, big))


def detector_position(theta_deg, phi_deg, radius, exit_port_z=-100.0):
    """Detector centre + plane normal for spherical placement about the
    port: a faithful port of ``Detector::setPosition`` (``fluxAtObserver.C:
    49-68``) INCLUDING its normal quirk — with dvec = centre - port centre,
    the stored normal is (-dvec.y, dvec.x, dvec.z)/|dvec| (x/y swapped and
    one sign flipped), which is what generated every reference flux map.

    Returns ``(center: Vec3, normal: Vec3)`` broadcast over the inputs."""
    th = torch.deg2rad(theta_deg)
    ph = torch.deg2rad(phi_deg)
    cx = radius * torch.sin(th) * torch.cos(ph)
    cy = radius * torch.sin(th) * torch.sin(ph)
    cz = exit_port_z - radius * torch.cos(th)
    dx, dy, dz = cx, cy, cz - exit_port_z
    mag = torch.sqrt(dx * dx + dy * dy + dz * dz)
    normal = Vec3(-dy / mag, dx / mag, dz / mag)   # fluxAtObserver.C:65-67
    return Vec3(cx, cy, cz), normal


def detector_position_aimed(theta_deg, phi_deg, radius, exit_port_z=-100.0):
    """Spherical placement with the normal aimed at the port centre (what
    ``setPosition``'s comment says it does, and ``detector_position`` does
    not)."""
    center, n = detector_position(theta_deg, phi_deg, radius, exit_port_z)
    # detector_position stores (-dy, dx, dz)/|dvec|; the aim is -dvec/|dvec|
    return center, Vec3(-n.y, n.x, -n.z)


def line_hits_disk(point: Vec3, direction: Vec3, center: Vec3, normal: Vec3,
                   disk_radius, parallel_eps: float = 1e-10):
    """``Detector::checkIntersection`` (``fluxAtObserver.C:70-107``): the
    infinite line through ``point`` meets the detector plane within
    ``disk_radius`` of the centre; lines with |d.n| < 1e-10 never hit."""
    dot = direction.dot(normal)
    rel = point - center
    t = -rel.dot(normal) / torch.where(dot == 0, torch.ones_like(dot), dot)
    hit_pt = point + direction.scale(t)
    r = hit_pt - center
    perp = normal.cross(r)
    r2 = perp.norm2()
    return (torch.abs(dot) >= parallel_eps) & (r2 <= disk_radius * disk_radius)
