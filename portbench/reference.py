"""The plain reference: an integrating-sphere photon tracer and a detector
scorer in plain PyTorch, written from the reference macros and imported by
nothing of ``altair_tpu_torch``.

Tracer: every ray of a batch flies from the point source through the shell
``TGeoSphere(r_in, r_out, 0, theta_max)`` of ``fluxAtObserverOptimize.C:
192-230``.  At each step a ray inside the sphere flies to the inner wall.
If it meets the wall (polar angle below theta_max) it bounces there; if
it crosses into the port and meets the shell's conical rim face between
the radii, it bounces on the rim face; otherwise it leaves through the
port and flies to the world box.  A ray that bounced on the rim face
travels in the gap between the radii until it meets the rim face again,
re-enters the sphere, or leaves past the outer radius.  Each bounce
survives with probability ``reflectance`` and then scatters by the wall
law about the surface normal: LAMBERTIAN (cosine-weighted) or MIXED_BRDF
(``nonLambertianFlux.C:147-211``: the mirror direction tilted by a
Gaussian angle with probability ``specular/(specular+diffuse)``, else
cosine-weighted).  Rays still running after ``max_bounces`` steps are
suspended, as ``SetLimit`` does.  The loop keeps only running rays, in
the tensor dtype it is given.

Scorer: ``Detector::checkIntersection`` (``fluxAtObserver.C:70-107``) for
every (exit ray, position) pair of the observer grid: the ray's line meets
the detector plane within half the width of the centre, and is not
parallel to it.  Positions follow ``Detector::setPosition``
(``fluxAtObserver.C:49-68``), normal quirk included.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

PARALLEL_EPS = 1e-10   # fluxAtObserver.C:78
_EPS = 1e-6            # crossings closer than this are the point itself
_INF = 1e30


class Exits(NamedTuple):
    """What the reference keeps of a traced batch: the ray count, the
    counts by end, and the final segment of every ray that left the
    sphere (``[k, 3]`` rows)."""

    n_rays: int
    n_absorbed: int
    n_suspended: int
    seg_start: torch.Tensor
    last_point: torch.Tensor
    direction: torch.Tensor
    n_bounces: torch.Tensor


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _basis(n):
    """Two unit vectors completing the unit ``n`` to an orthonormal frame
    (the helper axis is x unless n is close to it)."""
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    helper = torch.where((n[..., 0].abs() > 0.9)[..., None], e_y, e_x)
    u = _unit(_cross(n, helper))
    return u, _cross(n, u)


def _cosine_dir(n, u1, u2):
    """Cosine-weighted direction about the unit normal ``n``."""
    u, v = _basis(n)
    cos_t = torch.sqrt(u1)
    sin_t = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    phi = 2.0 * math.pi * u2
    out = (u * (sin_t * torch.cos(phi))[..., None]
           + v * (sin_t * torch.sin(phi))[..., None] + n * cos_t[..., None])
    return _unit(out)


def _mixed_dir(d, n, p_spec, sigma, draws):
    """``BRDF::SampleDirection``: the mirror direction plus a Gaussian
    angular perturbation of width ``sigma`` (``SampleSpecular``, added as
    sin(theta) along a random azimuth and renormalised), with probability
    ``p_spec``; else cosine-weighted (``SampleDiffuse``)."""
    u_pick, gauss, u_phi, u1, u2 = draws
    mirror = d - n * (2.0 * _dot(d, n))[..., None]
    p1, p2 = _basis(mirror)
    theta = sigma * gauss
    phi = 2.0 * math.pi * u_phi
    spec = _unit(mirror + (p1 * torch.cos(phi)[..., None]
                           + p2 * torch.sin(phi)[..., None])
                 * torch.sin(theta)[..., None])
    diff = _cosine_dir(n, u1, u2)
    return torch.where((u_pick < p_spec)[..., None], spec, diff)


def _leave_sphere(p, d, r):
    """Distance from a point inside ``|x| = r`` along unit ``d`` to the
    sphere (never negative)."""
    b = _dot(p, d)
    c = _dot(p, p) - r * r
    return torch.clamp(-b + torch.sqrt(torch.clamp(b * b - c, min=0.0)),
                       min=0.0)


def _meet_sphere(p, d, r):
    """Nearest crossing of ``|x| = r`` ahead of ``p`` (inside or out);
    ``_INF`` where there is none."""
    b = _dot(p, d)
    c = _dot(p, p) - r * r
    disc = b * b - c
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    near, far = -b - root, -b + root
    inf = torch.full_like(b, _INF)
    return torch.where((disc >= 0) & (near > _EPS), near,
                       torch.where((disc >= 0) & (far > _EPS), far, inf))


def _meet_rim(p, d, cos_tm, r_lo, r_hi):
    """Nearest crossing ahead of ``p`` of the rim face: the cone of polar
    angle theta_max (its z < 0 half) between the radii ``r_lo``, ``r_hi``;
    ``_INF`` where there is none.  On the cone z^2 = cos^2(theta_max)
    |x|^2, a quadratic in the distance."""
    k = cos_tm * cos_tm
    a = d[..., 2] * d[..., 2] - k * _dot(d, d)
    b = 2.0 * (p[..., 2] * d[..., 2] - k * _dot(p, d))
    c = p[..., 2] * p[..., 2] - k * _dot(p, p)
    inf = torch.full_like(a, _INF)
    flat = a.abs() < 1e-20
    a_safe = torch.where(flat, torch.ones_like(a), a)
    disc = b * b - 4.0 * a * c
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    linear = torch.where(b != 0, -c / torch.where(b == 0, torch.ones_like(b),
                                                  b), inf)
    best = inf
    for s in (torch.where(flat, linear, (-b - root) / (2.0 * a_safe)),
              torch.where(flat, inf, (-b + root) / (2.0 * a_safe))):
        x = p + d * s[..., None]
        r = torch.sqrt(_dot(x, x))
        ok = ((s > _EPS) & (flat | (disc >= 0)) & (x[..., 2] < 0)
              & (r >= r_lo - _EPS) & (r <= r_hi + _EPS))
        best = torch.where(ok & (s < best), s, best)
    return best


def _rim_normal(x):
    """Unit normal of the rim face at ``x``, pointing into the port (the
    direction of growing polar angle)."""
    r = torch.sqrt(_dot(x, x))
    rho = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    rho = torch.where(rho > 0, rho, torch.ones_like(rho))
    return torch.stack([x[..., 2] / r * x[..., 0] / rho,
                        x[..., 2] / r * x[..., 1] / rho, -rho / r], -1)


def _to_box(p, d, half):
    """Where the ray from ``p`` along ``d`` leaves the world box of
    half-width ``half``."""
    face = torch.where(d >= 0, half, -half).to(p.dtype)
    t = torch.where(d == 0, torch.full_like(p, _INF), (face - p) / d)
    return p + d * t.min(-1).values[..., None]


def source_ray(source: dict, dtype, device):
    """The source point and its unit direction, as 3-vectors."""
    pos = torch.tensor([source["x"], source["y"], source["z"]],
                       dtype=torch.float64)
    d = torch.tensor([source["dir_x"], source["dir_y"], source["dir_z"]],
                     dtype=torch.float64)
    return pos.to(dtype).to(device), (d / d.norm()).to(dtype).to(device)


def trace(scene: dict, source: dict, n_rays: int, gen: torch.Generator,
          dtype=torch.float64, device="cpu") -> Exits:
    """Trace ``n_rays`` from ``source`` through ``scene`` (the ``scene``
    object of a configuration file) in ``dtype``, drawing from ``gen`` (a
    generator on ``device``)."""
    law = scene["surface_model"]
    if law not in ("LAMBERTIAN", "MIXED_BRDF"):
        raise ValueError(f"the reference has no law {law!r}")
    r_in, r_out = float(scene["inner_radius"]), float(scene["outer_radius"])
    cos_tm = math.cos(math.radians(float(scene["theta_max_deg"])))
    cap_z = r_in * cos_tm
    half = float(scene["world_half"])
    rho = float(scene["reflectance"])
    p_spec = scene["specular_prob"] / (scene["specular_prob"]
                                       + scene["diffuse_prob"])
    sigma = scene["brdf_roughness"] * math.pi / 6.0
    exact_rim = bool(scene["exact_rim"])

    src_p, src_d = source_ray(source, dtype, device)
    p = src_p.expand(n_rays, 3).clone()
    d = src_d.expand(n_rays, 3).clone()
    gap = torch.zeros(n_rays, dtype=torch.bool, device=device)
    nb = torch.zeros(n_rays, dtype=torch.int32, device=device)
    out = {"seg": [], "last": [], "dir": [], "nb": []}
    n_absorbed = 0
    n_stuck = 0    # gap rays that meet no surface: suspended

    def uniform(m):
        return torch.rand(m, generator=gen, device=device,
                          dtype=torch.float32).to(dtype)

    for _ in range(int(scene["max_bounces"])):
        m = p.shape[0]
        if m == 0:
            break
        survive = uniform(m) < rho
        q = p + d * _leave_sphere(p, d, r_in)[..., None]
        q = q * (r_in / torch.sqrt(_dot(q, q)))[..., None]
        in_port = q[..., 2] < cap_z
        inside = ~gap
        if exact_rim:
            origin = torch.where(gap[..., None], p, q)
            s_rim = _meet_rim(origin, d, cos_tm, r_in, r_out)
            s_in = _meet_sphere(p, d, r_in)
            s_out = _meet_sphere(p, d, r_out)
        else:
            origin = q
            s_rim = s_in = s_out = torch.full_like(q[..., 0], _INF)
        rim_pt = origin + d * s_rim[..., None]
        rim_first = inside & in_port & (s_rim < _INF)
        gap_rim = gap & (s_rim < s_in) & (s_rim < s_out)
        gap_enter = gap & ~gap_rim & (s_in < s_out)
        gap_leave = gap & ~gap_rim & ~gap_enter & (s_out < _INF)
        stuck = gap & ~gap_rim & ~gap_enter & ~gap_leave
        on_rim = rim_first | gap_rim
        on_wall = inside & ~in_port
        leaves = (inside & in_port & ~rim_first) | gap_leave
        bounced = on_rim | on_wall

        normal = torch.where(on_rim[..., None], _rim_normal(rim_pt),
                             -q / r_in)
        if law == "LAMBERTIAN":
            new_d = _cosine_dir(normal, uniform(m), uniform(m))
        else:
            gauss = torch.randn(m, generator=gen, device=device,
                                dtype=torch.float32).to(dtype)
            new_d = _mixed_dir(d, normal, p_spec, sigma,
                               (uniform(m), gauss, uniform(m), uniform(m),
                                uniform(m)))

        if bool(leaves.any()):
            out["seg"].append(p[leaves])
            out["last"].append(_to_box(p[leaves], d[leaves], half))
            out["dir"].append(d[leaves])
            out["nb"].append(nb[leaves])
        absorbed = bounced & ~survive
        n_absorbed += int(absorbed.sum())

        enter_pt = p + d * s_in[..., None]
        enter_pt = enter_pt * (r_in / torch.sqrt(_dot(enter_pt, enter_pt))
                               )[..., None]
        p = torch.where(on_rim[..., None], rim_pt,
                        torch.where(gap_enter[..., None], enter_pt,
                                    torch.where(on_wall[..., None], q, p)))
        d = torch.where((bounced & survive)[..., None], new_d, d)
        nb = nb + bounced.to(torch.int32)
        gap = (on_rim & survive) | (gap & ~gap_rim & ~gap_enter)
        n_stuck += int(stuck.sum())
        keep = ~(leaves | absorbed | stuck)
        p, d, gap, nb = p[keep], d[keep], gap[keep], nb[keep]
    n_suspended = n_stuck + p.shape[0]

    def cat(key, width):
        if out[key]:
            return torch.cat(out[key])
        shape = (0, width) if width else (0,)
        return torch.zeros(shape, dtype=dtype if width else torch.int32,
                           device=device)

    return Exits(n_rays, n_absorbed, n_suspended, cat("seg", 3),
                 cat("last", 3), cat("dir", 3), cat("nb", 0))


def grid_positions(grid: dict, port_z: float, dtype=torch.float64,
                   device="cpu"):
    """Detector centres and normals ``[P, 3]``, theta-major, placed by
    ``Detector::setPosition``: the centre at ``radius`` from the port
    centre, the stored normal (-v_y, v_x, v_z)/|v| of the offset v."""
    n_t, n_p = int(grid["n_theta"]), int(grid["n_phi"])
    th = (torch.arange(n_t, dtype=torch.float64) + 0.5) * (
        (grid["theta_hi"] - grid["theta_lo"]) / n_t) + grid["theta_lo"]
    ph = (torch.arange(n_p, dtype=torch.float64) + 0.5) * (
        (grid["phi_hi"] - grid["phi_lo"]) / n_p) + grid["phi_lo"]
    th, ph = torch.deg2rad(th).repeat_interleave(n_p), torch.deg2rad(ph).repeat(n_t)
    r = float(grid["radius"])
    v = torch.stack([r * torch.sin(th) * torch.cos(ph),
                     r * torch.sin(th) * torch.sin(ph),
                     -r * torch.cos(th)], -1)
    centre = v + torch.tensor([0.0, 0.0, port_z], dtype=torch.float64)
    normal = torch.stack([-v[:, 1], v[:, 0], v[:, 2]], -1) / v.norm(dim=1,
                                                                  keepdim=True)
    return centre.to(dtype).to(device), normal.to(dtype).to(device)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the 10-bit mantissa of TF32, as the
    tensor cores round a matmul's inputs in that mode."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def score(seg, direction, grid: dict, port_z: float, dtype=torch.float64,
          tf32: bool = False, pair_block: int = 1 << 27):
    """Hits of every exit line (points ``seg``, directions ``direction``,
    ``[k, 3]``) on every grid position.  Returns ``(counts [n_theta,
    n_phi] int64, per_ray [k] int64)``.  Computed in ``dtype``; with
    ``tf32`` the four products of rays with positions take their float32
    inputs rounded to TF32 (the control's scorer)."""
    dev = seg.device
    centre, normal = grid_positions(grid, port_z, dtype, dev)
    e = seg.to(dtype)
    d = direction.to(dtype)
    half2 = (float(grid["width"]) / 2.0) ** 2
    c_n = _dot(centre, normal)
    c_c = _dot(centre, centre)

    def mm(a, b):
        if tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b.T

    counts = torch.zeros(centre.shape[0], dtype=torch.int64, device=dev)
    per_ray = torch.zeros(e.shape[0], dtype=torch.int64, device=dev)
    step = max(1, pair_block // max(1, centre.shape[0]))
    for i in range(0, e.shape[0], step):
        eb, db = e[i:i + step], d[i:i + step]
        d_n = mm(db, normal)                       # d . n
        t = (c_n[None, :] - mm(eb, normal)) / torch.where(
            d_n == 0, torch.ones_like(d_n), d_n)   # plane crossing
        # |e + t d - c|^2 = |e - c|^2 + 2 t (e - c).d + t^2 |d|^2
        e_c2 = _dot(eb, eb)[:, None] - 2.0 * mm(eb, centre) + c_c[None, :]
        e_c_d = _dot(eb, db)[:, None] - mm(db, centre)
        r2 = e_c2 + t * (2.0 * e_c_d + t * _dot(db, db)[:, None])
        hit = (d_n.abs() >= PARALLEL_EPS) & (r2 <= half2)
        counts += hit.sum(0)
        per_ray[i:i + step] = hit.sum(1)
    return (counts.view(int(grid["n_theta"]), int(grid["n_phi"])), per_ray)
