"""Two-stage scatter-retrace pipeline — the counterpart of
``altair_tpu/sweep/scatter_retrace.py``: the current ``nonLambertianFlux.C``
methodology (``:235-304``), distinct from putting the BRDF inside the bounce
loop (the archived macro / ``SurfaceModel`` wall models):

  1. trace each ray through the sphere to completion,
  2. take its END POINT, compute the sphere normal there as
     ``endpoint.Unit()`` (the macro's simplification: the OUTWARD normal,
     applied wherever the ray died, ``:254-259``),
  3. sample ONE custom-BRDF scatter of the original source direction about
     that normal (``gBRDF.SampleDirection(normal, incidentDir)`` uses the
     ray's INITIAL direction as incident, ``:244-247,262``),
  4. re-trace the scattered ray from the endpoint,
  5. score exit/detector on the SCATTERED ray (``:294-297``).

Faithful quirks preserved: the outward ``endpoint.Unit()`` normal, the
initial-direction incident vector, and re-tracing from endpoints that may
lie outside the sphere (exited rays' box endpoints); ``only_rescatter_
absorbed`` restricts stage 2 to endpoints on the shell (the physically
meaningful subset).

Stage 1 goes through ``trace_rays_auto``, so a scene with a non-Lambertian
wall runs the bounce kernel on the card.  Stage 2 is the eager bounce loop
at every size: the waves tracer would suspend the rays its compaction
cannot hold, which the reference's from-state loop never does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import DetectorGrid, SphereScene, Source, TraceConfig
from ..core.geometry import Vec3, ray_box_exit_t
from ..core.sampling import mixed_brdf
from ..core.score import fluxmap_trace_once
from ..core.route import trace_rays_auto
from ..core.trace import (EXITED, RUNNING, TraceResult, _i32, _source_rays,
                          device_generator, f32, split,
                          trace_eager_from_state)
from ..io.profiling import host_int


def _retrace_from(gen, scene, pos: Vec3, direction: Vec3, n_rays, cfg, *,
                  device):
    """Continue rays from arbitrary interior/on-shell points — the second
    ``TraceNonSequential`` call of the macro.  Runs the shared bounce step
    (exact-rim handling included) from a custom initial state, with the
    alive check once per block of 32 steps."""
    radius = f32(scene.inner_radius)
    world_half = f32(scene.world_half)

    # endpoints on/inside the shell re-trace; far-outside endpoints (the
    # world-box last points of already-exited rays) fly straight on.  The
    # 0.5 cm tolerance keeps on-sphere wall endpoints (|p| == r up to fp
    # error) on the traceable side.
    traceable = pos.norm2() < (radius + 0.5) * (radius + 0.5)
    status0 = _i32(torch.where(traceable, RUNNING, EXITED))

    # outside starts: propagate straight to the box
    t_box0 = ray_box_exit_t(pos, direction, world_half)
    box0 = pos + direction.scale(t_box0)
    prev0 = pos
    pos = Vec3.where(traceable, pos, box0)

    bounces0 = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    in_gap0 = torch.zeros((n_rays,), dtype=torch.bool, device=device)
    return trace_eager_from_state(
        gen, scene, (pos, direction, prev0, status0, bounces0, in_gap0), cfg,
        device, block=32)


def trace_scatter_retrace(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    only_rescatter_absorbed: bool = False,
    *,
    device,
) -> tuple[TraceResult, torch.Tensor]:
    """The full two-stage pipeline on ``device``.  Returns the SCATTERED
    rays' ``TraceResult`` (what the macro scores) and stage 1's overflow
    count (``RimOverflow.total``), which the JAX function drops."""
    k1, k2, k3 = split(gen, 3)
    first, rim = trace_rays_auto(k1, scene, source, n_rays, cfg,
                                 device=device)

    endpoint = first.last_point
    normal = endpoint.normalized()           # endpoint.Unit()  (:259)
    _, incident = _source_rays(source, n_rays, cfg.dtype, device)
    new_dir = mixed_brdf(device_generator(k2, device), incident, normal,
                         scene.specular_prob, scene.diffuse_prob,
                         scene.brdf_roughness)

    if only_rescatter_absorbed:
        on_shell = torch.abs(endpoint.norm() - scene.inner_radius) < 1.0
        new_dir = Vec3.where(on_shell, new_dir, first.direction)

    return (_retrace_from(k3, scene, endpoint, new_dir, n_rays, cfg,
                          device=device), rim.total)


@dataclasses.dataclass
class ScatterRetraceSweep:
    fluxmap: np.ndarray
    n_rays: int
    wall_time_s: float


def sweep_scatter_retrace(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(n_theta=45, n_phi=20, width=10.0,
                                      height=10.0),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    mesh=None,
) -> ScatterRetraceSweep:
    """``sweepDetector`` of nonLambertianFlux.C (``:307-387``): 45x20 grid,
    10x10 cm detector, 100k rays, scored on the scattered rays: one trace,
    rescatter and score on ``device`` instead of a re-trace per position.
    A nonzero overflow of stage 1 raises.  ``mesh``: split the ray axis
    over the mesh's ranks (``parallel.sharded_scatter_retrace``: both
    stages stay on the rank, one sum of the map)."""
    t0 = time.perf_counter()
    key = torch.Generator().manual_seed(seed)
    if mesh is not None:
        from ..parallel import sharded_scatter_retrace

        mesh.check_device(device)
        counts = sharded_scatter_retrace(mesh, key, scene, source, grid,
                                         n_rays, cfg)
    else:
        res, overflow = trace_scatter_retrace(key, scene, source, n_rays,
                                              cfg, device=device)
        counts = fluxmap_trace_once(res, grid, scene.exit_port_z)
        overflow = host_int(overflow)
        if overflow:
            raise RuntimeError(
                f"scatter-retrace: {overflow} rays unfinished in stage "
                "1 — statistically impossible at the planned capacities; "
                "investigate")
    return ScatterRetraceSweep(
        counts.cpu().numpy().astype(np.float64) / n_rays, n_rays,
        time.perf_counter() - t0)
