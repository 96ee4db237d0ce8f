"""The comparisons that decide ``correct``.  Each function returns one
number; ``check`` turns numbers and the cell's limits into the lines the
run prints.  Every number is compared as ``value <= limit``.

- ``exit_z``: the program's port-exit fraction over all jobs of the window
  against the reference tracer's, as a two-sample z (binomial variance).
- ``exit_chi2_z``: the port exits of the sampled jobs against the
  reference's, binned by exit direction (polar cosine, azimuth) and by
  where the exit line crosses the port's cap plane (azimuth, radius): a
  two-sample chi-square, as a z.
- ``segment_err_cm``: the largest geometric fault of an exit segment of
  the sampled jobs: its last point off the world box, off the line from
  its start along its direction, its direction not unit, its start off
  every surface a ray can leave from, or its flight meeting the wall.
- ``map_cell_diff``: the largest difference, over the cells of the
  sampled maps, between the program's count and the reference scorer's
  count of the same exits.
- binomial maps: ``total_z`` (the map's total against the reference's
  expectation), ``cell_z2_dev`` (how far the cells' mean squared z lies
  from 1: too small is as wrong as too large, a draw left out reads
  near 0) and ``cell_max_surprise`` (how unlikely the largest cell z is
  among that many cells, in decades: one altered cell).
"""

from __future__ import annotations

import math

import torch

from . import reference


def exit_z(n_exit_p: int, n_p: int, n_exit_r: int, n_r: int) -> float:
    f_p, f_r = n_exit_p / n_p, n_exit_r / n_r
    f = (n_exit_p + n_exit_r) / (n_p + n_r)
    var = f * (1.0 - f) * (1.0 / n_p + 1.0 / n_r)
    return abs(f_p - f_r) / math.sqrt(var) if var > 0 else math.inf


def _features(seg, direction, cap_z: float):
    """Of each exit line: its direction's polar cosine about -z and its
    azimuth, and the azimuth and squared radius of the point where it
    crosses the port's cap plane ``z = cap_z``.  All four are the line's
    own, whichever point of it ``seg`` is: the refill kernel records the
    port crossing as an exit's segment start, the other engines the last
    wall point (``altair_tpu_torch/core/trace_cuda.py``, ``trace_rays_refill``)."""
    d = direction.to(torch.float64)
    s = seg.to(torch.float64)
    dz = torch.where(d[:, 2] == 0, torch.full_like(d[:, 2], -1e-30), d[:, 2])
    x = s + d * ((cap_z - s[:, 2]) / dz)[:, None]
    return torch.stack([-d[:, 2], torch.atan2(d[:, 1], d[:, 0]),
                        torch.atan2(x[:, 1], x[:, 0]),
                        x[:, 0] ** 2 + x[:, 1] ** 2], 1)


BINS = (8, 8, 4, 4)


def _bin_index(x, edges):
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for j, e in enumerate(edges):
        idx = idx * (e.numel() + 1) + torch.bucketize(x[:, j].contiguous(), e)
    return idx


def _inner_quantiles(x, k: int):
    """The ``k - 1`` values that cut ``x`` into ``k`` parts of equal count
    (``torch.quantile`` refuses more than 2^24 values)."""
    xs = x.sort().values
    idx = torch.arange(1, k, device=x.device) * x.shape[0] // k
    return xs[idx].contiguous()


def exit_chi2_z(seg_p, dir_p, seg_r, dir_r, cap_z: float) -> float:
    """Two-sample chi-square of the exit lines over bins of equal
    reference mass in each of ``_features``, as ``|chi2 - dof| /
    sqrt(2 dof)``."""
    xp = _features(seg_p, dir_p, cap_z)
    xr = _features(seg_r.to(xp.device), dir_r.to(xp.device), cap_z)
    if xp.shape[0] == 0:
        return math.inf
    edges = [_inner_quantiles(xr[:, j], k) for j, k in enumerate(BINS)]
    n_bins = math.prod(BINS)
    op = torch.bincount(_bin_index(xp, edges), minlength=n_bins).double()
    orr = torch.bincount(_bin_index(xr, edges), minlength=n_bins).double()
    use = (op + orr) > 0
    n1, n2 = op.sum(), orr.sum()
    k1, k2 = torch.sqrt(n2 / n1), torch.sqrt(n1 / n2)
    chi2 = float((((k1 * op - k2 * orr) ** 2)[use] / (op + orr)[use]).sum())
    dof = int(use.sum()) - 1
    return abs(chi2 - dof) / math.sqrt(2.0 * dof)


def segment_err_cm(seg, last, direction, n_bounces, scene: dict,
                   source: dict) -> float:
    """The largest geometric fault, in cm, over the exit segments."""
    if seg.shape[0] == 0:
        return 0.0
    s = seg.to(torch.float64)
    L = last.to(torch.float64)
    d = direction.to(torch.float64)
    r_in, r_out = float(scene["inner_radius"]), float(scene["outer_radius"])
    cos_tm = math.cos(math.radians(float(scene["theta_max_deg"])))
    half = float(scene["world_half"])
    norm = d.norm(dim=1)
    unit_err = (norm - 1.0).abs() * 2.0 * half
    u = d / norm[:, None]
    box_err = (L.abs().max(dim=1).values - half).abs()
    chord = L - s
    line_err = torch.linalg.cross(chord, u, dim=1).norm(dim=1)
    line_err = torch.where((chord * u).sum(1) >= 0, line_err,
                           chord.norm(dim=1))
    r = s.norm(dim=1)
    sphere_err = (r - r_in).abs()
    in_band = (r >= r_in - 1e-3) & (r <= r_out + 1e-3)
    rim_err = torch.where(in_band, (s[:, 2] - r * cos_tm).abs(),
                          torch.full_like(r, math.inf))
    src = torch.tensor([source["x"], source["y"], source["z"]],
                       dtype=torch.float64, device=s.device)
    src_err = torch.where(n_bounces.to(s.device) == 0,
                          (s - src).norm(dim=1), torch.full_like(r, math.inf))
    surf_err = torch.minimum(torch.minimum(sphere_err, rim_err), src_err)
    # the flight from a start on the inner sphere or at the source leaves
    # the sphere through the port: its exit point lies below the cap
    from_inside = (sphere_err <= rim_err) | (src_err <= rim_err)
    q = s + u * reference._leave_sphere(s, u, r_in)[:, None]
    wall_err = torch.where(from_inside,
                           torch.clamp(q[:, 2] - r_in * cos_tm, min=0.0),
                           torch.zeros_like(r))
    worst = torch.stack([unit_err, box_err, line_err, surf_err, wall_err], 1)
    return float(worst.max())


def map_cell_diff(counts_p, counts_r) -> float:
    return float((counts_p.to(torch.int64).cpu()
                  - counts_r.to(torch.int64).cpu()).abs().max())


def max_surprise(z_max: float, n_cells: int) -> float:
    """How surprising the largest of ``n_cells`` standard normal |z| is,
    in decades: -log10 P(max |z| >= z_max) = -log10(1 - (1 - p)^n),
    p = erfc(z_max / sqrt 2).  About 0-2 for sound maps whatever the
    number of cells; the max itself grows with it."""
    x = z_max / math.sqrt(2.0)
    p = math.erfc(x)
    if p > 0.0:
        tail = -math.expm1(n_cells * math.log1p(-p)) if p < 1.0 else 1.0
        if tail > 0.0:
            return -math.log10(tail)
    # erfc(x) ~ exp(-x^2) / (x sqrt(pi)) where it underflows
    return (x * x + math.log(x * math.sqrt(math.pi))) / math.log(10.0) \
        - math.log10(n_cells)


def binomial_numbers(maps, pi_ref, n_per_pos: int, m_shared: int,
                     n_ref: int, hits_var: float, min_expect: float = 20.0):
    """``(total_z, cell_z2_dev, cell_max_surprise)`` of the binomial maps
    ``maps`` (a list of ``[n_theta, n_phi]`` counts from independent jobs)
    against the reference's per-cell hit probability ``pi_ref`` from
    ``n_ref`` rays.  A cell is Binomial(n, pi_hat), pi_hat from the job's
    ``m_shared`` rays; ``hits_var`` is the variance of one reference ray's
    number of hits.  The reference's noise is common to every map, which
    the variances carry.  Cells expecting fewer than ``min_expect`` hits
    are left out of the cell numbers."""
    x = torch.stack([m.to(torch.float64).flatten().cpu() for m in maps])
    p = pi_ref.to(torch.float64).flatten().cpu()
    k = x.shape[0]
    n = float(n_per_pos)
    e = n * p
    var = n * p * (1.0 - p) + n * n * p * (1.0 - p) * (1.0 / m_shared
                                                      + 1.0 / n_ref)
    use = e >= min_expect
    z = (x - e)[:, use] / torch.sqrt(var[use])
    total_var = k * (float((n * p * (1.0 - p)).sum())
                     + n * n * hits_var / m_shared) + (k * n) ** 2 * (
        hits_var / n_ref)
    total_z = abs(float(x.sum() - k * e.sum())) / math.sqrt(total_var)
    return (total_z, abs(float((z * z).mean()) - 1.0),
            max_surprise(float(z.abs().max()), z.numel()))


def check(numbers: dict, limits: dict):
    """``(correct, lines)``: every number at or under its limit, and the
    ``{name: {"value", "limit"}}`` the run prints.  A number that could
    not be computed (None, NaN) fails."""
    lines, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        lines[name] = {"value": value, "limit": limit}
    return ok, lines


def exits_from_reference(ex: "reference.Exits", port_z: float):
    """The reference's port exits as ``(seg, last, dir, n_bounces)``."""
    keep = ex.last_point[:, 2] < port_z
    return (ex.seg_start[keep], ex.last_point[keep], ex.direction[keep],
            ex.n_bounces[keep])
