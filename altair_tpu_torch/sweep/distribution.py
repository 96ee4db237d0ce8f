"""Exit angular-distribution run — the counterpart of
``altair_tpu/sweep/distribution.py``: ``distributionSphereDetectorSweep.C``
and the ``makeIntegratingSphereNRays.C`` flux counter, plus the raw
direction log (``3dRayLog.txt``) and cos-z histogram (``angular_dist.txt``)
payloads.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import SphereScene, Source, TraceConfig
from ..core.score import exit_angle_histogram, exit_directions, z_angle_histogram
from ..core.route import trace_rays_auto
from ..io.profiling import host_int


@dataclasses.dataclass
class DistributionResult:
    n_rays: int
    n_exited: int                  # the "Flux of rays through the exit port"
    angle_hist: np.ndarray         # [180] signed port-axis angle counts
    dz_hist: np.ndarray            # [100] cos-z bin counts (angular_dist)
    directions: np.ndarray         # [n_exited, 3] exit dirs (3dRayLog)
    wall_time_s: float

    def direction_histograms_2d(self, bins: int = 100):
        """The debug 2D direction-component histograms of
        ``distributionSphereDetectorSweep.C:52-54`` (hDirectionsXZ,
        hDirectionsYZ, hDirectionZ): returns (xz, yz, z) count arrays over
        [-1, 1] ranges."""
        d = self.directions
        xz, _, _ = np.histogram2d(d[:, 0], d[:, 2], bins=bins,
                                  range=[[-1, 1], [-1, 1]])
        yz, _, _ = np.histogram2d(d[:, 1], d[:, 2], bins=bins,
                                  range=[[-1, 1], [-1, 1]])
        z, _ = np.histogram(d[:, 2], bins=bins, range=(-1, 1))
        return xz, yz, z


def run_distribution(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays: int = 10_000,
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    keep_directions: bool = True,
    mesh=None,
) -> DistributionResult:
    """Trace on ``device`` and histogram the exit angles (10k rays in the
    reference macro, ``distributionSphereDetectorSweep.C:57``).  The
    histograms are built on the device; one readback brings them and the
    direction payload to the host.  A nonzero trace overflow raises.

    The trace goes through ``trace_rays_auto`` (the direct sampler for a
    Lambertian wall), where the JAX function's single-device run uses the
    in-loop ``trace_rays`` and only its mesh run the dispatch: same
    distribution, other streams.

    ``mesh``: split the rays over the mesh's ranks
    (``parallel.sharded_distribution``: the histograms are summed, and the
    ranks' direction payloads are gathered in rank order, so every rank
    returns the whole result)."""
    t0 = time.perf_counter()
    key = torch.Generator().manual_seed(seed)
    if mesh is not None:
        from ..parallel import sharded_distribution

        mesh.check_device(device)
        ang, dzh, mask, dx, dy, dz = sharded_distribution(
            mesh, key, scene, source, n_rays, cfg)
        # one gather for the mask and the three components
        mask, dx, dy, dz = mesh.all_gather(torch.stack(
            [mask.to(dx.dtype), dx, dy, dz])).transpose(0, 1).reshape(4, -1)
        mask = mask > 0
    else:
        res, rim = trace_rays_auto(key, scene, source, n_rays, cfg,
                                   device=device)
        mask, dx, dy, dz = exit_directions(res, scene.exit_port_z)
        ang = exit_angle_histogram(res, exit_port_z=scene.exit_port_z)
        dzh = z_angle_histogram(dz, mask)
        rim_total = host_int(rim.total)
        if rim_total:
            raise RuntimeError(f"distribution: {rim_total} rim-clipped "
                               "rays unfinished; investigate")
    m = mask.cpu().numpy()
    dirs = (torch.stack([dx, dy, dz], 1).cpu().numpy()[m]
            if keep_directions else np.zeros((0, 3)))
    wall = time.perf_counter() - t0
    return DistributionResult(
        n_rays=n_rays,
        n_exited=int(m.sum()),
        angle_hist=ang.cpu().numpy(),
        dz_hist=dzh.cpu().numpy(),
        directions=dirs,
        wall_time_s=wall,
    )


def write_ray_log(path: str, directions: np.ndarray):
    """``3dRayLog.txt`` dialect: ``# dx dy dz`` header + one direction per
    line (``3drayanalysis.py:5`` loads it with plain np.loadtxt)."""
    with open(path, "w") as fh:
        fh.write("# dx dy dz\n")
        np.savetxt(fh, directions, fmt="%.6f")


def write_angular_dist(path: str, dz_hist: np.ndarray):
    """``angular_dist.txt`` dialect: ``# bin_center content`` over 100 cos-z
    bins on [-1, 1]."""
    centers = -1 + (np.arange(len(dz_hist)) + 0.5) * (2 / len(dz_hist))
    with open(path, "w") as fh:
        fh.write("# bin_center content\n")
        for c, v in zip(centers, dz_hist):
            fh.write(f"{c:.2f} {int(v)}\n")
