"""Direct-sampling trace engine — the PyTorch counterpart of
``altair_tpu/core/trace_direct.py``.

For a Lambertian sphere interior every wall hit after the first is uniform
on the sphere, independently of where the ray left from, so the bounce
chain has a closed-form law: a Geometric round count, an exit-versus-
absorption terminal event, and uniform band and cap points.  Seven uniforms
per ray replace the bounce loop.  See the JAX module's docstring for the
derivation and for the documented SUSPENDED-direction divergence from the
simulators.

The seven uniforms are an argument of ``trace_direct_from_uniforms``, so a
test can feed it exactly the draws the JAX engine used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SphereScene, Source, SurfaceModel, TraceConfig
from .geometry import Vec3, ray_box_exit_t, sphere_hit
from .trace import (ABSORBED, EXITED, SUSPENDED, TraceResult, _source_rays,
                    cos_theta_max, device_generator, f32)


def direct_applicable(scene: SphereScene, cfg: TraceConfig) -> bool:
    """True when the direct sampler computes the same distribution the
    simulation kernels would."""
    return (not callable(scene.surface_model)
            and SurfaceModel(scene.surface_model) == SurfaceModel.LAMBERTIAN
            and int(cfg.keep_history) == 0)


def _sphere_point(radius, z_frac, phi) -> Vec3:
    """Point on the sphere at height fraction z/r = z_frac and azimuth phi."""
    rho = torch.sqrt(torch.clamp(1.0 - z_frac * z_frac, min=0.0))
    return Vec3(radius * rho * torch.cos(phi),
                radius * rho * torch.sin(phi),
                radius * z_frac)


def trace_rays_direct(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> TraceResult:
    """Sample the trace outcome of ``n_rays`` from its closed-form law.
    Simple-mode Lambertian scenes only; ``trace_rays_auto`` composes the
    exact-rim post-pass around it."""
    if cfg.keep_history:
        raise ValueError("direct sampling has no path history")
    if not direct_applicable(scene, cfg):
        raise NotImplementedError(
            "direct sampling requires a (static) LAMBERTIAN surface model")
    if scene.exact_rim:
        raise NotImplementedError(
            "the direct sampler draws simple-mode physics; exact-rim scenes "
            "compose it via trace_rays_rim_deferred (see trace_rays_auto)")
    pos0, dir0 = _source_rays(source, n_rays, cfg.dtype, device)
    return trace_direct_from_state(
        gen, scene, pos0, dir0,
        torch.zeros((n_rays,), dtype=torch.int32, device=device), cfg)


def trace_direct_from_state(
    gen: torch.Generator,
    scene: SphereScene,
    pos0: Vec3,
    dir0: Vec3,
    bounces0: torch.Tensor,
    cfg: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Closed-form completion from an arbitrary per-lane mid-flight state;
    draws the ``[7, N]`` uniforms from ``gen`` on the state's device: a
    pseudorandom block, or with ``cfg.qmc`` a Sobol block randomised by
    words drawn from ``gen`` (``qmc=1`` digital shift, ``qmc>=2`` Owen
    scramble; ``core/qmc.py``)."""
    device = pos0.x.device
    n = pos0.x.shape[0]
    if cfg.qmc:
        from .qmc import sobol_uniforms

        u = sobol_uniforms(gen, n, 7, cfg.dtype,
                           mode="owen" if cfg.qmc >= 2 else "shift",
                           device=device)
    else:
        u = torch.rand((7, n), generator=device_generator(gen, device),
                       device=device, dtype=cfg.dtype)
    return trace_direct_from_uniforms(u, scene, pos0, dir0, bounces0)


def trace_direct_from_uniforms(
    u: torch.Tensor,
    scene: SphereScene,
    pos0: Vec3,
    dir0: Vec3,
    bounces0: torch.Tensor,
) -> TraceResult:
    """The sampler proper: ``u`` is the ``[7, N]`` block of uniforms
    (s1, g, term, pz, pphi, qz, qphi), in the order the JAX engine draws
    them.  Per-lane outcome classes:

    * first flight escapes -> EXITED, 0 bounces, segment = (source, box);
    * roulette kills at the first hit h1 -> ABSORBED, 1 bounce;
    * G full rounds then an escaping flight -> EXITED, 1+G bounces;
    * G full rounds then a killed wall hit -> ABSORBED, 2+G bounces;
    * chain still alive after the bounce cap -> SUSPENDED, cap bounces.
    """
    radius = f32(scene.inner_radius)
    ct = np.float32(cos_theta_max(scene))
    cos_tm = float(ct)
    cos_cap = float(np.float32(radius) * ct)
    rho32 = np.float32(scene.reflectance)
    world_half = f32(scene.world_half)
    max_iters = int(scene.max_bounces)

    # deterministic first flight (the only non-uniform step of the chain)
    q1 = sphere_hit(pos0, dir0, radius)
    esc1 = q1.z < cos_cap

    u_s1, u_g, u_term, u_pz, u_pphi, u_qz, u_qphi = u

    # chain constants in float32, as the JAX engine holds them
    one = np.float32(1.0)
    f = (one + ct) * np.float32(0.5)      # cap area fraction
    s = (one - f) * rho32                 # per-round continue probability
    surv1 = u_s1 < float(rho32)

    # completed rounds G ~ Geometric(1 - s): G = floor(log(1-u)/log(s))
    log_s = np.log(np.maximum(s, np.float32(1e-30)))
    ratio = torch.log1p(-u_g) / float(log_s if log_s != 0 else -1e-30)
    cap_f = float(np.float32(max_iters))
    G = torch.floor(torch.clamp(ratio, max=cap_f)).to(torch.int32)

    # terminal event (memoryless, independent of G): exit vs absorption
    pe_den = f + (one - f) * (one - rho32)
    p_exit = f / (pe_den if pe_den != 0 else one)
    term_exit = u_term < float(p_exit)

    # chain alive after the iteration cap
    susp = surv1 & ~esc1 & (ratio >= cap_f - 1.0)

    two_pi = 2.0 * math.pi
    b1 = _sphere_point(radius, cos_tm + u_pz * float(one - ct),
                       u_pphi * two_pi)
    b2 = _sphere_point(radius, cos_tm + u_qz * float(one - ct),
                       u_qphi * two_pi)
    qcap = _sphere_point(radius, -1.0 + u_qz * float(one + ct),
                         u_qphi * two_pi)

    # ---- assemble the five outcome classes ------------------------------
    exited = esc1 | (surv1 & ~esc1 & ~susp & term_exit)
    absorbed_h1 = ~esc1 & ~surv1
    absorbed_late = surv1 & ~esc1 & ~susp & ~term_exit

    p_late = Vec3.where(G == 0, q1, b1)
    seg_start = Vec3.where(esc1 | absorbed_h1, pos0,
                           Vec3.where(susp, b1, p_late))

    d_exit = (qcap - p_late).normalized(1e-20)
    d_exit = Vec3.where(esc1, dir0, d_exit)
    d_wall = (b2 - p_late).normalized(1e-20)
    d_wall = Vec3.where(susp, (b2 - b1).normalized(1e-20), d_wall)
    direction = Vec3.where(exited, d_exit,
                           Vec3.where(absorbed_h1, dir0, d_wall))

    # last point: exits fly on to the world box; wall deaths stop there
    t_box = ray_box_exit_t(seg_start, direction, world_half)
    box_pt = seg_start + direction.scale(t_box)
    last = Vec3.where(exited, box_pt, Vec3.where(absorbed_h1, q1, b2))

    status = torch.where(exited, EXITED,
                         torch.where(susp, SUSPENDED, ABSORBED))
    zero = torch.zeros_like(G)
    bounces = bounces0 + torch.where(
        esc1, zero,
        torch.where(absorbed_h1, zero + 1,
                    torch.where(susp, zero + max_iters,
                                torch.where(absorbed_late, 2 + G, 1 + G))))
    return TraceResult(
        status=status.to(torch.int32),
        last_point=last,
        seg_start=seg_start,
        direction=direction,
        n_bounces=bounces.to(torch.int32),
    )
