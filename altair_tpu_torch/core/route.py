"""The trace's route: which tracer runs a scene and how its deferred rim
finishes, decided once (``plan``) and carried out (``run``).  The
counterpart of the dispatch in ``altair_tpu/core/trace_waves.py``
(``trace_rays_auto``), ``trace_pallas.py`` (``trace_rays_fast``) and
``trace.py`` (``trace_rays_rim_deferred``).

The layers, from the bottom: ``trace.py`` (statuses, keys, the bounce
step, the eager loop); the engines (``trace_direct``, ``trace_cuda``,
``trace_waves``), which import only ``trace.py`` and the helpers below it;
this module; the sweeps, the scorer, the mesh and the CLI above it.

Routes (``Route.main``): ``direct`` (the closed-form sampler), ``bounce``
and ``refill`` (the kernels, by the batch size), ``finish`` (a thick rim
from the source in one finish launch), ``waves`` and ``eager`` (the
loops, for float64, a scatter callable or path history).  An exact rim
the post-pass admits is deferred: the main route traces simple-mode
physics and ``Route.cont`` finishes the clipped rays: ``hybrid`` (after
the direct sampler), ``kernel`` (one finish launch) or ``eager``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from ..config import SphereScene, Source, TraceConfig
from ..io.profiling import span
from . import trace_cuda
from .geometry import Vec3, cone_crossing_t, cone_face_normal, sphere_hit
from .sampling import scatter
from .trace import (ABSORBED, EXITED, RUNNING, SUSPENDED, RimOverflow,
                    TraceResult, _compact_gather, _i32, _put_result,
                    cos_theta_max, device_generator, f32, lossless,
                    make_bounce_step, rim_deferred_capacity_shift, split,
                    trace_eager_from_state, trace_rays)
from .trace_cuda import (finish_from_state, kernel_applicable,
                         trace_rays_bounce, trace_rays_finish,
                         trace_rays_refill_padded)
from .trace_direct import (direct_applicable, trace_direct_from_state,
                           trace_rays_direct)
from .trace_waves import trace_rays_waves, waves_safe

# batches at least this big run the waves tracer where the kernels do not
# take the scene and ``waves_safe`` holds (the JAX package's
# WAVES_THRESHOLD; a module constant so a test can lower it)
WAVES_MIN = 262_144
# the cone solve's "no crossing"
_INF = 1e30


class Route(NamedTuple):
    """``main``: the main trace's route; ``shift``: the deferred rim's
    capacity shift (buffer ``n >> shift``), or None; ``cont``: the rim
    continuation's kind, None without a deferred rim."""

    main: str
    shift: int | None
    cont: str | None


def _cont(scene: SphereScene, cfg: TraceConfig) -> str:
    """The rim continuation of ``scene``: the hybrid after the direct
    sampler, else one finish launch where the kernels take the scene, else
    the eager loop."""
    if cfg.engine != "simulate" and direct_applicable(scene, cfg):
        return "hybrid"
    return "kernel" if kernel_applicable(scene, cfg) else "eager"


def plan(scenes: Sequence[SphereScene], cfg: TraceConfig,
         n_rays: int) -> Route:
    """The route of ``n_rays``-ray traces of ``scenes`` (one scene, or the
    concrete members of a series, which share the surface model, the
    bounce cap and the rim mode).  A series' rim buffer is the largest any
    member plans (the smallest shift), and a member whose rim is too thick
    to defer sends every member to the in-loop rim.

    ``cfg.engine``: ``auto`` takes the direct sampler for a static
    Lambertian law, ``simulate`` opts out, ``direct`` refuses any scene
    the sampler cannot take."""
    if cfg.engine not in ("auto", "simulate", "direct"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    scene = scenes[0]
    if cfg.keep_history:
        # trace_rays has the only history buffer
        if cfg.engine == "direct":
            raise ValueError("direct sampling has no path history")
        return Route("eager", None, None)
    shifts = ([rim_deferred_capacity_shift(s) for s in scenes]
              if scene.exact_rim else [])
    shift = None if not shifts or None in shifts else min(shifts)
    in_loop_rim = bool(scene.exact_rim) and shift is None
    cont = None if shift is None else _cont(scene, cfg)
    if (cfg.engine != "simulate" and direct_applicable(scene, cfg)
            and not in_loop_rim):
        return Route("direct", shift, cont)
    if cfg.engine == "direct":
        raise NotImplementedError(
            "engine='direct' requires a statically-Lambertian scene whose "
            "rim (if exact_rim) admits the deferred post-pass")
    if kernel_applicable(scene, cfg):
        if in_loop_rim:
            return Route("finish", None, None)
        return Route("refill" if n_rays >= trace_cuda.REFILL_MIN
                     else "bounce", shift, cont)
    waves = n_rays >= WAVES_MIN and all(waves_safe(s) for s in scenes)
    return Route("waves" if waves else "eager", shift, cont)


# each main route's tracer: (TraceResult, n_overflow) of simple-mode
# physics where the rim is deferred
_MAIN = {
    "direct": lossless(trace_rays_direct),
    "bounce": lossless(trace_rays_bounce),
    "refill": trace_rays_refill_padded,
    "waves": trace_rays_waves,
    "eager": lossless(trace_rays),
}


def run(route: Route, gen: torch.Generator, scene: SphereScene,
        source: Source, n_rays: int, cfg: TraceConfig, *,
        device) -> tuple[TraceResult, RimOverflow]:
    """Trace ``n_rays`` from ``source`` through ``scene`` by ``route``."""
    if route.main == "finish":
        return trace_rays_finish(gen, scene, source, n_rays, cfg,
                                 device=device)
    main = _MAIN[route.main]
    if route.shift is not None:
        return _rim_deferred(gen, scene, source, n_rays, cfg, route.shift,
                             main, route.cont, device)
    res, ovf = main(gen, scene, source, n_rays, cfg, device=device)
    return res, RimOverflow(total=ovf, grouped_drops=torch.zeros_like(ovf))


def trace_rays_auto(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """Trace ``n_rays`` from ``source`` through ``scene`` by its ``plan``.

    ``gen`` is a CPU ``torch.Generator`` (the key); ``device`` says where
    the rays are traced.  Returns ``(TraceResult, RimOverflow)``: the JAX
    function drops the overflow counts, the port returns them (rim
    capacity, the waves tracer's and the refill handoff compaction's) so a
    caller can check them.

    The span ``trace``, with ``n_rays`` and the ``route`` taken
    (``Route.main``)."""
    with span("trace", n_rays=n_rays) as sp:
        route = plan([scene], cfg, n_rays)
        sp.set(route=route.main)
        return run(route, gen, scene, source, n_rays, cfg, device=device)


def trace_rays_fast(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """The simulate engine: the kernels' routes (``bounce``, ``refill``
    and ``finish``, with the deferred rim's ``kernel`` continuation) where
    they take the scene; else (float64, a scatter callable, path history)
    the eager ``trace_rays``, as the JAX function falls back to its XLA
    kernel.  Returns ``(TraceResult, RimOverflow)``."""
    route = plan([scene], dataclasses.replace(cfg, engine="simulate"),
                 n_rays)
    if route.main not in ("bounce", "refill", "finish"):
        route = Route("eager", None, None)
    return run(route, gen, scene, source, n_rays, cfg, device=device)


def trace_rays_rim_deferred(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    capacity_shift: int = 4,
    main_tracer=None,
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """Exact-rim physics as a post-pass over a simple-mode main trace:

    1. main trace with ``exact_rim=False`` (``main_tracer``, called as
       ``main_tracer(gen, scene, source, n, cfg, device=device)``; default
       ``lossless(trace_rays)``).  It returns ``(TraceResult,
       n_overflow)``; its count of rays lost goes into
       ``RimOverflow.total``;
    2. clip-test each exited lane's escape flight against the rim cone;
    3. compact the clipped lanes into an ``n_rays >> capacity_shift``
       buffer (at least 256 lanes), apply the first rim bounce, and finish
       them with the exact-rim step, by the continuation ``plan`` gives
       the scene: the hybrid for a Lambertian scene under the direct
       sampler, else one launch of the finish kernel where the kernels
       take the scene, else the eager loop;
    4. scatter the continuation back over the clipped lanes.

    Returns ``(TraceResult, RimOverflow)``; ``RimOverflow.total`` counts
    clipped rays beyond the buffer, left as optimistic EXITED, and the
    rays the main tracer lost.

    Spans: ``trace.main`` (step 1), ``trace.rim`` (steps 2-4, with the
    buffer's width ``m``) and inside it ``trace.rim.cont`` (the
    continuation, with its ``kind``: ``hybrid``, ``kernel`` or
    ``eager``)."""
    return _rim_deferred(gen, scene, source, n_rays, cfg, capacity_shift,
                         main_tracer if main_tracer is not None
                         else lossless(trace_rays),
                         _cont(scene, cfg), device)


def _rim_deferred(gen, scene, source, n_rays, cfg, capacity_shift, main,
                  cont, device):
    """``trace_rays_rim_deferred`` with the main tracer ``main`` and the
    continuation ``cont`` given."""
    if cfg.keep_history:
        raise ValueError("rim-deferred tracing has no history buffer")
    if int(scene.max_bounces) >= 1 << 24:
        # _compact_gather carries bounce counts through a float32 mantissa
        raise ValueError("max_bounces >= 2^24 would corrupt bounce counts "
                         "in the deferred-rim pack")
    k_main, k_first, k_cont = split(gen, 3)
    with span("trace.main"):
        res, main_overflow = main(k_main, scene.with_(exact_rim=False),
                                  source, n_rays, cfg, device=device)
    m = min(n_rays, max(256, n_rays >> capacity_shift))
    with span("trace.rim", m=m):
        radius = f32(scene.inner_radius)
        q = sphere_hit(res.seg_start, res.direction, radius)
        s_rim = cone_crossing_t(q, res.direction, cos_theta_max(scene),
                                radius, f32(scene.outer_radius), _INF)
        clipped = (res.status == EXITED) & (s_rim < _INF)
        rim_pt = q + res.direction.scale(s_rim)

        n_overflow = torch.clamp(clipped.sum(dtype=torch.int32) - m, min=0)
        idx, valid, (c_pt, c_dir, c_prev), (c_b,), dropped = _compact_gather(
            clipped, [rim_pt, res.direction, res.seg_start], [res.n_bounces],
            m, n_rays, group_capacity=max(256, m >> 1))
        n_overflow = n_overflow + dropped + main_overflow
        c_bounces = c_b + _i32(valid)

        # first rim bounce: roulette + the surface model about the rim
        # normal
        dgen = device_generator(k_first, device)
        survive = (torch.rand((m,), generator=dgen, device=device,
                              dtype=cfg.dtype) < f32(scene.reflectance))
        d_scat = scatter(dgen, scene.surface_model, c_dir,
                         cone_face_normal(c_pt), scene)
        status0 = _i32(torch.where(valid & survive, RUNNING, ABSORBED))
        c_dir = Vec3.where(survive, d_scat, c_dir)
        carry = (c_pt, c_dir, c_prev, status0, c_bounces, valid & survive)

        with span("trace.rim.cont", kind=cont):
            if cont == "hybrid":
                out, n_cont = _rim_continuation_hybrid(k_cont, scene, carry,
                                                       cfg, device)
                n_overflow = n_overflow + n_cont
            else:
                out = _finish_exact(cont == "kernel", k_cont, scene, carry,
                                    cfg, device)

        sidx = torch.where(valid, idx, n_rays)
        return (_put_result(res, sidx, out),
                RimOverflow(total=n_overflow, grouped_drops=dropped))


def _finish_exact(kernel: bool, gen, scene, carry, cfg, device):
    """Finish a buffer of mid-flight lanes with the exact-rim step: one
    finish launch, or the eager loop."""
    if kernel:
        return finish_from_state(gen, scene, carry, exact_rim=True)
    return trace_eager_from_state(gen, scene, carry, cfg, device)


def _rim_continuation_hybrid(gen, scene, carry, cfg, device):
    """Finish the deferred-rim continuation buffer: a 16-iteration exact-rim
    prefix, a closed-form finish of the interior survivors, a re-clip of
    their sampled escapes, and an 8x-smaller tail, which one finish launch
    runs where the kernels take the scene and the eager loop elsewhere.

    Returns ``(TraceResult, n_overflow)``: the tail's lanes beyond its
    buffer, left SUSPENDED."""
    dtype = cfg.dtype
    radius = f32(scene.inner_radius)
    r_out = f32(scene.outer_radius)
    cos_tm = cos_theta_max(scene)
    m = carry[0].x.shape[0]
    k_pre, k_fin, k_rim2, k_tail = split(gen, 4)

    step = make_bounce_step(k_pre, scene, m, cfg, device)
    for it in range(min(16, int(scene.max_bounces))):
        carry = step(it, carry)
    pos, direction, prev, status, bounces, in_gap = carry

    # ---- closed-form finish for interior survivors ----------------------
    run_int = (status == RUNNING) & ~in_gap
    fin = trace_direct_from_state(k_fin, scene, pos, direction, bounces, cfg)
    status_o = torch.where(run_int, fin.status, status)
    pos_o = Vec3.where(run_int, fin.last_point, pos)
    prev_o = Vec3.where(run_int, fin.seg_start, prev)
    dir_o = Vec3.where(run_int, fin.direction, direction)
    bounces_o = torch.where(run_int, fin.n_bounces, bounces)

    # ---- rim clips on the sampled escapes --------------------------------
    fin_exit = run_int & (fin.status == EXITED)
    q2 = sphere_hit(fin.seg_start, fin.direction, radius)
    s2 = cone_crossing_t(q2, fin.direction, cos_tm, radius, r_out, _INF)
    clip2 = fin_exit & (s2 < _INF)
    rim_pt2 = q2 + fin.direction.scale(s2)
    dgen = device_generator(k_rim2, device)
    survive2 = (torch.rand((m,), generator=dgen, device=device, dtype=dtype)
                < f32(scene.reflectance))
    d2 = scatter(dgen, scene.surface_model, fin.direction,
                 cone_face_normal(rim_pt2), scene)

    # clipped-and-killed lanes die at the rim face
    dead2 = clip2 & ~survive2
    status_o = torch.where(dead2, ABSORBED, status_o)
    pos_o = Vec3.where(dead2, rim_pt2, pos_o)
    bounces_o = torch.where(clip2, fin.n_bounces + 1, bounces_o)

    # ---- tail: clipped survivors + lanes still in the gap ---------------
    still_gap = (status == RUNNING) & in_gap
    cont = (clip2 & survive2) | still_gap
    t_pos = Vec3.where(clip2, rim_pt2, pos)
    t_dir = Vec3.where(clip2, d2, direction)
    t_prev = Vec3.where(clip2, fin.seg_start, prev)
    t_bounces = torch.where(clip2, fin.n_bounces + 1, bounces)

    m2 = min(m, max(256, m >> 3))
    n_overflow2 = torch.clamp(cont.sum(dtype=torch.int32) - m2, min=0)
    idx2, valid2, (g_pos, g_dir, g_prev), (g_bounces,), _ = _compact_gather(
        cont, [t_pos, t_dir, t_prev], [t_bounces], m2, m)
    carry2 = (g_pos, g_dir, g_prev,
              _i32(torch.where(valid2, RUNNING, ABSORBED)),
              g_bounces, valid2)
    tail = _finish_exact(kernel_applicable(scene, cfg), k_tail, scene,
                         carry2, cfg, device)

    sidx2 = torch.where(valid2, idx2, m)
    out = _put_result(TraceResult(status_o, pos_o, prev_o, dir_o, bounces_o),
                      sidx2, tail)
    # tail-overflow still-gap lanes (counted in n_overflow2) cannot finish
    return out._replace(status=torch.where(out.status == RUNNING, SUSPENDED,
                                           out.status)), n_overflow2
