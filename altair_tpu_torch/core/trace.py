"""The bounce step, the eager bounce loop and the deferred-rim post-pass —
the PyTorch counterpart of ``altair_tpu/core/trace.py``.

Random numbers: where the JAX package takes a key, the port takes a CPU
``torch.Generator``.  JAX's key splits become ``split``: sub-generators
seeded from draws of the parent; ``fold_in`` derives one from the key's
state and an integer without drawing from it.  Bulk draws on a device
come from ``device_generator``, a generator on that device seeded from one
draw of the key, so a CUDA run never copies a seed back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SphereScene, Source, TraceConfig
from ..io.profiling import count, host_bool, host_int, span
from .geometry import Vec3, ray_box_exit_t, sphere_hit
from .sampling import scatter

# Ray status codes (ARay state machine, fluxAtObserverOptimize.C:271-273).
RUNNING = 0     # still bouncing inside the sphere
EXITED = 1      # escaped through the port cap, flew to the world box
ABSORBED = 2    # killed by the reflectance roulette at a wall hit
SUSPENDED = 3   # hit the bounce limit (ray->Suspend() guard)

_SEED_HI = 1 << 62


class TraceResult(NamedTuple):
    """SoA trace output for a batch of N rays."""

    status: torch.Tensor     # [N] int32, one of the codes above
    last_point: Vec3         # ARay::GetLastPoint
    seg_start: Vec3          # second-to-last point (segment start)
    direction: Vec3          # final unit direction
    n_bounces: torch.Tensor  # [N] int32 — wall interactions before death
    history: torch.Tensor | None = None      # [K, N, 3] optional path points
    history_len: torch.Tensor | None = None  # [N] int32 number of valid points

    def exited_port_mask(self, exit_port_z=-100.0):
        """The reference's exit test: last point z < exitPortZ
        (``fluxAtObserver.C:162-166``) on geometric exits."""
        return (self.status == EXITED) & (self.last_point.z < exit_port_z)


class RimOverflow(NamedTuple):
    """Capacity diagnostics of ``trace_rays_rim_deferred``: ``total`` counts
    every lane the deferred-rim pass could not process; ``grouped_drops``
    the level-2 group-capacity drops among them."""

    total: torch.Tensor          # [] int32
    grouped_drops: torch.Tensor  # [] int32

    def __int__(self) -> int:
        return host_int(self.total)


def no_overflow(device) -> RimOverflow:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return RimOverflow(total=z, grouped_drops=z)


def lossless(tracer):
    """A tracer that loses no rays, as a ``main_tracer`` of
    ``trace_rays_rim_deferred``: its result and a zero overflow count."""
    def main(gen, scene, source, n_rays, cfg, *, device):
        return (tracer(gen, scene, source, n_rays, cfg, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    return main


def draw_seeds(gen: torch.Generator, k: int, hi: int = _SEED_HI) -> list[int]:
    """``k`` integers in [0, hi) drawn from the CPU key ``gen``."""
    if gen.device.type != "cpu":
        raise ValueError("the generator passed as a key must be a CPU "
                         "torch.Generator; device streams are derived from it")
    return torch.randint(0, hi, (k,), generator=gen).tolist()


def split(gen: torch.Generator, k: int) -> list[torch.Generator]:
    """``jax.random.split``: ``k`` CPU generators seeded from draws of the
    CPU generator ``gen``."""
    return [torch.Generator().manual_seed(s) for s in draw_seeds(gen, k)]


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """``jax.random.fold_in``: a CPU generator that depends only on the
    CPU key ``gen``'s current state and the integer ``data``; ``gen``
    itself is left as it is.  A chunked sweep keys chunk ``i`` by
    ``fold_in(key, i)``, so a resumed run redraws exactly the streams of
    the chunks it redoes."""
    probe = torch.Generator()
    probe.set_state(gen.get_state())
    (base,) = draw_seeds(probe, 1)
    (seed,) = np.random.SeedSequence([base, int(data)]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(seed) >> 2)


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of the CPU key
    ``gen``."""
    (seed,) = draw_seeds(gen, 1)
    return torch.Generator(device=device).manual_seed(seed)


def f32(x) -> float:
    """A scalar rounded to float32, as the JAX package holds it."""
    return float(np.float32(x))


def cos_theta_max(scene: SphereScene) -> float:
    """cos(theta_max) in float32 (f32 deg->rad, then f32 cos), as the JAX
    package computes it."""
    return float(np.cos(np.deg2rad(np.float32(scene.theta_max_deg))))


def _i32(t):
    return t.to(torch.int32)


def _source_rays(source: Source, n: int, dtype, device) -> tuple[Vec3, Vec3]:
    def full(v):
        return torch.full((n,), float(v), dtype=dtype, device=device)

    pos = Vec3(full(source.x), full(source.y), full(source.z))
    d = Vec3(full(source.dir_x), full(source.dir_y),
             full(source.dir_z)).normalized()
    return pos, d


def make_bounce_step(gen: torch.Generator, scene: SphereScene, n_rays: int,
                     cfg: TraceConfig, device):
    """Build the per-iteration bounce step.

    carry = (pos: Vec3, direction: Vec3, prev: Vec3, status: [N] i32,
    bounces: [N] i32, in_gap: [N] bool); ``step(it, carry) -> carry``.
    Same physics as the JAX step (simple branch, and the exact-rim branch
    with the conical rim face and the gap region between the shell radii).
    Each call draws the iteration's uniforms from one device stream.
    """
    from .geometry import cone_crossing_t, cone_face_normal, sphere_crossing_t

    dtype = cfg.dtype
    dgen = device_generator(gen, device)
    radius = f32(scene.inner_radius)
    r_out = f32(scene.outer_radius)
    cos_tm = cos_theta_max(scene)
    cos_cap = float(np.float32(radius) * np.float32(cos_tm))
    reflectance = f32(scene.reflectance)
    world_half = f32(scene.world_half)
    exact_rim = bool(scene.exact_rim)
    max_iters = int(scene.max_bounces)
    INF = 1e30

    def uniform():
        return torch.rand((n_rays,), generator=dgen, device=device,
                          dtype=dtype)

    def step(it, carry):
        if it >= max_iters:
            # a partial trailing block of iterations must not overshoot the
            # SetLimit bounce cap
            return carry
        pos, direction, prev, status, bounces, in_gap = carry
        active = status == RUNNING
        survive = uniform() < reflectance

        q = sphere_hit(pos, direction, radius)
        escaped = q.z < cos_cap
        normal = q.scale(-1.0 / radius)
        t_box = ray_box_exit_t(pos, direction, world_half)
        box_pt = pos + direction.scale(t_box)

        if not exact_rim:
            new_dir = scatter(dgen, scene.surface_model, direction, normal,
                              scene)
            new_status = _i32(torch.where(
                escaped, EXITED, torch.where(survive, RUNNING, ABSORBED)))
            status = torch.where(active, new_status, status)
            prev = Vec3.where(active, pos, prev)
            pos = Vec3.where(active, Vec3.where(escaped, box_pt, q), pos)
            direction = Vec3.where(active & ~escaped & survive, new_dir,
                                   direction)
            bounces = torch.where(active & ~escaped, bounces + 1, bounces)
            return pos, direction, prev, status, bounces, in_gap

        interior = active & ~in_gap
        gap = active & in_gap

        # one cone solve serves both rim interactions: escaping interior
        # flights clip-check from q, gap lanes propagate from pos
        o_cone = Vec3.where(in_gap, pos, q)
        s_rim = cone_crossing_t(o_cone, direction, cos_tm, radius, r_out, INF)
        rim_i = escaped & (s_rim < INF)
        rim_pt = o_cone + direction.scale(s_rim)

        # gap propagation: nearest of cone / inner sphere / outer sphere
        s_in = sphere_crossing_t(pos, direction, radius, INF)
        s_outs = sphere_crossing_t(pos, direction, r_out, INF)
        gap_cone = gap & (s_rim < s_in) & (s_rim < s_outs)
        gap_enter = gap & ~gap_cone & (s_in < s_outs)
        gap_exit = gap & ~gap_cone & ~gap_enter & (s_outs < INF)
        gap_stuck = gap & ~gap_cone & ~gap_enter & ~gap_exit
        enter_pt = pos + direction.scale(s_in)
        enter_pt = enter_pt.scale(radius * torch.rsqrt(enter_pt.norm2()))

        rim_bounce = (interior & rim_i) | gap_cone
        exits = (interior & escaped & ~rim_i) | gap_exit
        wall = interior & ~escaped
        absorbed = (rim_bounce | wall) & ~survive

        # one scatter draw serves whichever surface the lane hit
        scat_normal = Vec3.where(rim_bounce, cone_face_normal(rim_pt), normal)
        new_dir = scatter(dgen, scene.surface_model, direction, scat_normal,
                          scene)

        new_status = _i32(torch.where(
            exits, EXITED,
            torch.where(absorbed, ABSORBED,
                        torch.where(gap_stuck, SUSPENDED, RUNNING))))
        status = torch.where(active, new_status, status)

        upd = active & ~gap_stuck
        prev = Vec3.where(upd, pos, prev)
        new_pos = Vec3.where(
            exits, box_pt,
            Vec3.where(rim_bounce, rim_pt,
                       Vec3.where(gap_enter, enter_pt, q)))
        pos = Vec3.where(upd, new_pos, pos)
        direction = Vec3.where(upd & (rim_bounce | wall) & survive, new_dir,
                               direction)
        bounces = torch.where(upd & (rim_bounce | wall), bounces + 1, bounces)
        in_gap = torch.where(
            active, (rim_bounce & survive) | (gap & ~gap_enter & ~exits
                                              & ~absorbed & ~gap_stuck),
            in_gap)
        return pos, direction, prev, status, bounces, in_gap

    return step


def _while_trace(step_fn, carry, max_iters: int, block: int):
    """Run ``step_fn(it, carry)`` until ``max_iters`` or every lane is dead
    (``carry[3]`` is the status vector).  The alive check is a
    device-to-host sync, so it runs once per ``block`` iterations.

    The span ``loop.eager``; while tracing, each step also adds the lanes
    running at its start to a per-lane count (a compare and an add), and
    the loop sums that count once (``lane_steps_live``)."""
    n = carry[3].shape[0]
    with span("loop.eager", width=n, block=block) as sp:
        live = torch.zeros_like(carry[3]) if sp.on else None
        it = 0
        while it < max_iters and host_bool((carry[3] == RUNNING).any()):
            for j in range(block):
                if live is not None and it + j < max_iters:
                    live += carry[3] == RUNNING
                carry = step_fn(it + j, carry)
            it += block
        if live is not None:
            steps = min(it, max_iters)
            sp.set(iterations=steps)
            count("lane_steps_issued", n * steps)
            count("lane_steps_live", live.sum())
    return carry


def trace_rays(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> TraceResult:
    """Trace ``n_rays`` from ``source`` through ``scene`` to completion with
    the eager bounce loop (simple or exact-rim physics, by the scene).

    ``cfg.keep_history = K`` keeps each ray's first K path points in
    ``TraceResult.history`` (``[K, N, 3]``, N*K*12 bytes in float32: meant
    for the few hundred rays of a picture) and their number in
    ``history_len``: slot 0 is the source point, a point is recorded after
    each step in which the ray was running, the last slot is overwritten
    once the buffer is full, and ``history_len`` saturates at K."""
    dtype = cfg.dtype
    pos, direction = _source_rays(source, n_rays, dtype, device)
    zeros = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    max_iters = int(scene.max_bounces)
    step = make_bounce_step(gen, scene, n_rays, cfg, device)
    block = max(1, min(int(cfg.block_iters), max_iters))
    init = (pos, direction, pos, zeros, zeros,
            torch.zeros((n_rays,), dtype=torch.bool, device=device))

    keep_hist = int(cfg.keep_history)
    hist = hlen = None
    if keep_hist:
        hist = torch.zeros((keep_hist, n_rays, 3), dtype=dtype, device=device)
        hist[0] = pos.stack()
        hlen = torch.ones((n_rays,), dtype=torch.int64, device=device)
        lanes = torch.arange(n_rays, device=device)
        bare_step = step

        def step(it, carry):
            nonlocal hlen
            rec = carry[3] == RUNNING
            carry = bare_step(it, carry)
            if it < max_iters:
                # one masked write a step: running lanes record their new
                # point at their own slot, the others rewrite what is there
                slot = torch.clamp(hlen, max=keep_hist - 1)
                hist[slot, lanes] = torch.where(
                    rec[:, None], carry[0].stack(), hist[slot, lanes])
                hlen = torch.where(rec, torch.clamp(hlen + 1, max=keep_hist),
                                   hlen)
            return carry

    pos, direction, prev, status, bounces, _ = _while_trace(
        step, init, max_iters, block)
    # rays still running after the cap are suspended (ray->Suspend())
    status = torch.where(status == RUNNING, SUSPENDED, status)
    return TraceResult(status, pos, prev, direction, bounces, hist,
                       None if hlen is None else _i32(hlen))


# deferred-rim continuations at least this wide wave-compact their tail
# (``trace_waves_from_state``) when there is no closed-form finish and the
# kernels do not take the scene
_WAVES_CONTINUATION_MIN = 65536
# the wave schedule of that continuation, as in the JAX package
# (RIM_CONT_FIRST_WAVE = None: the first wave is RIM_CONT_WAVE_ITERS long)
RIM_CONT_WAVE_ITERS = 96
RIM_CONT_SHRINK = 4
RIM_CONT_FIRST_WAVE: int | None = None
# hybrid-continuation tails at least this wide recurse into the hybrid
# where the kernels do not take the scene (module constant so tests can
# lower it)
HYBRID_RECURSE_MIN = 32768


def rim_deferred_capacity_shift(scene: SphereScene) -> int | None:
    """Plan the deferred-rim continuation capacity ``n >> shift``, or
    ``None`` when deferral is unsafe (a thick rim, or non-scalar scene
    parameters).  Same rule as the JAX package: expected clipped fraction =
    expected exit fraction x rim-band width, times a 2.5x margin."""
    import math
    import numbers

    vals = (scene.theta_max_deg, scene.reflectance, scene.inner_radius,
            scene.outer_radius)
    if not all(isinstance(v, numbers.Number) for v in vals):
        return None
    from ..config import expected_exit_fraction

    alpha = math.radians(180.0 - float(scene.theta_max_deg))
    band = ((float(scene.outer_radius) - float(scene.inner_radius))
            / (float(scene.inner_radius) * math.sin(alpha)))
    clip = min(1.0, band)
    cap_frac = 2.5 * clip * expected_exit_fraction(scene.theta_max_deg,
                                                   scene.reflectance)
    if cap_frac > 0.25:
        return None
    shift = 2
    while shift < 6 and 1.0 / (1 << (shift + 1)) >= cap_frac:
        shift += 1
    return shift


def _put(dst: torch.Tensor, sidx: torch.Tensor, src: torch.Tensor):
    """``dst.at[sidx].set(src, mode="drop")`` where ``sidx == len(dst)``
    marks a lane to drop.  Torch raises on an out-of-range index, so the
    write goes to one extra sink row that is cut off afterwards."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf[sidx] = src.to(dst.dtype)
    return buf[:-1]


def _put_vec(dst: Vec3, sidx, src: Vec3) -> Vec3:
    return Vec3(_put(dst.x, sidx, src.x), _put(dst.y, sidx, src.y),
                _put(dst.z, sidx, src.z))


def _put_result(dst: TraceResult, sidx, src: TraceResult) -> TraceResult:
    """``_put`` of every field of ``src`` into ``dst``."""
    return TraceResult(_put(dst.status, sidx, src.status),
                       _put_vec(dst.last_point, sidx, src.last_point),
                       _put_vec(dst.seg_start, sidx, src.seg_start),
                       _put_vec(dst.direction, sidx, src.direction),
                       _put(dst.n_bounces, sidx, src.n_bounces))


def _compact_gather(mask, vecs, ints, capacity: int, n: int,
                    group_capacity: int | None = None):
    """Compact the lanes where ``mask`` holds into a ``capacity``-sized
    buffer with one packed row gather (int fields ride as float32: exact
    while they stay below 2^24).  With ``group_capacity`` (sparse masks)
    the index build runs the grouped compaction.

    Returns ``(idx, valid, vec_outs, int_outs, n_dropped)``."""
    from .compact import nonzero_indices, nonzero_indices_grouped

    if group_capacity is not None and n >= (1 << 16):
        idx, n_dropped = nonzero_indices_grouped(mask, capacity, n,
                                                 group_capacity)
    else:
        idx = nonzero_indices(mask, capacity, n)
        n_dropped = torch.zeros((), dtype=torch.int32, device=mask.device)
    valid = idx < n
    safe = torch.clamp(idx, max=n - 1)
    pdt = vecs[0].x.dtype
    pack_dt = pdt if pdt in (torch.float32, torch.float64) else torch.float32
    cols = []
    for v in vecs:
        cols += [v.x.to(pack_dt), v.y.to(pack_dt), v.z.to(pack_dt)]
    cols += [a.to(pack_dt) for a in ints]
    rows = torch.stack(cols, 1)[safe]
    out_vecs = [Vec3(rows[:, 3 * i].to(pdt), rows[:, 3 * i + 1].to(pdt),
                     rows[:, 3 * i + 2].to(pdt))
                for i in range(len(vecs))]
    base = 3 * len(vecs)
    out_ints = [_i32(rows[:, base + j]) for j in range(len(ints))]
    return idx, valid, out_vecs, out_ints, n_dropped


def _rim_continuation_hybrid(gen, scene, carry, cfg, radius, r_out, cos_tm,
                             INF, device, depth: int = 0):
    """Finish the deferred-rim continuation buffer: a 16-iteration exact-rim
    prefix, a closed-form finish of the interior survivors, a re-clip of
    their sampled escapes, and an 8x-smaller tail.  Where the kernels take
    the scene the tail is one launch of the finish kernel; elsewhere it is
    the in-loop trace, recursing into this hybrid while it is large (the
    JAX package's schedule).

    Returns ``(pos, dir, prev, status, bounces, n_overflow)``."""
    from .geometry import cone_crossing_t, cone_face_normal
    from .trace_cuda import finish_from_state, kernel_applicable
    from .trace_direct import trace_direct_from_state

    dtype = cfg.dtype
    m = carry[0].x.shape[0]
    max_iters = int(scene.max_bounces)
    k_pre, k_fin, k_rim2, k_tail = split(gen, 4)

    step = make_bounce_step(k_pre, scene, m, cfg, device)
    for it in range(min(16, max_iters)):
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

    # ---- recursive rim clips on the sampled escapes ---------------------
    fin_exit = run_int & (fin.status == EXITED)
    q2 = sphere_hit(fin.seg_start, fin.direction, radius)
    s2 = cone_crossing_t(q2, fin.direction, cos_tm, radius, r_out, INF)
    clip2 = fin_exit & (s2 < INF)
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

    # ---- in-loop tail: clipped survivors + lanes still in the gap -------
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
    if kernel_applicable(scene, cfg):
        fin2 = finish_from_state(k_tail, scene, carry2, exact_rim=True)
        pos2, dir2, prev2, status2, bounces2 = (
            fin2.last_point, fin2.direction, fin2.seg_start, fin2.status,
            fin2.n_bounces)
    elif depth < 2 and m2 >= HYBRID_RECURSE_MIN:
        (pos2, dir2, prev2, status2, bounces2,
         ovf3) = _rim_continuation_hybrid(k_tail, scene, carry2, cfg,
                                          radius, r_out, cos_tm, INF,
                                          device, depth + 1)
        n_overflow2 = n_overflow2 + ovf3
    else:
        step2 = make_bounce_step(k_tail, scene, m2, cfg, device)
        block = max(1, min(int(cfg.block_iters), max_iters))
        pos2, dir2, prev2, status2, bounces2, _ = _while_trace(
            step2, carry2, max_iters, block)
        status2 = torch.where(status2 == RUNNING, SUSPENDED, status2)

    sidx2 = torch.where(valid2, idx2, m)
    status_f = _put(status_o, sidx2, status2)
    # tail-overflow still-gap lanes (counted in n_overflow2) cannot finish
    status_f = torch.where(status_f == RUNNING, SUSPENDED, status_f)
    return (_put_vec(pos_o, sidx2, pos2), _put_vec(dir_o, sidx2, dir2),
            _put_vec(prev_o, sidx2, prev2), status_f,
            _put(bounces_o, sidx2, bounces2), n_overflow2)


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
       buffer, apply the first rim bounce, and finish them with the
       exact-rim step: the hybrid continuation for Lambertian scenes, else
       one launch of the finish kernel where the kernels take the scene
       (``trace_cuda.kernel_applicable``), else the waves tracer at
       ``m >= _WAVES_CONTINUATION_MIN`` lanes and the eager loop below
       that;
    4. scatter the continuation back over the clipped lanes.

    Returns ``(TraceResult, RimOverflow)``; ``RimOverflow.total`` counts
    clipped rays beyond the buffer, left as optimistic EXITED, and the
    rays the main tracer and the waves continuation lost.

    Spans: ``trace.main`` (step 1), ``trace.rim`` (steps 2-4, with the
    buffer's width ``m``) and inside it ``trace.rim.cont`` (the
    continuation, with its ``kind``: ``hybrid``, ``kernel``, ``waves`` or
    ``eager``).
    """
    from .trace_cuda import kernel_applicable
    from .trace_direct import direct_applicable

    if cfg.keep_history:
        raise ValueError("rim-deferred tracing has no history buffer")
    if int(scene.max_bounces) >= 1 << 24:
        # _compact_gather carries bounce counts through a float32 mantissa
        raise ValueError("max_bounces >= 2^24 would corrupt bounce counts "
                         "in the deferred-rim pack")
    k_main, k_first, k_cont = split(gen, 3)
    main = main_tracer if main_tracer is not None else lossless(trace_rays)
    with span("trace.main"):
        res, main_overflow = main(k_main, scene.with_(exact_rim=False),
                                  source, n_rays, cfg, device=device)
    m = min(n_rays, max(256, n_rays >> capacity_shift))
    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        kind = "hybrid"
    elif kernel_applicable(scene, cfg):
        kind = "kernel"
    elif m >= _WAVES_CONTINUATION_MIN:
        kind = "waves"
    else:
        kind = "eager"
    with span("trace.rim", m=m):
        return _rim_post_pass(res, main_overflow, scene, n_rays, m, kind,
                              cfg, k_first, k_cont, device)


def _rim_post_pass(res, main_overflow, scene, n_rays, m, kind, cfg, k_first,
                   k_cont, device):
    """Steps 2-4 of ``trace_rays_rim_deferred`` over the main trace
    ``res``, with an ``m``-lane buffer and the continuation ``kind``
    (``hybrid``, ``kernel``, ``waves`` or ``eager``)."""
    from .geometry import cone_crossing_t, cone_face_normal

    dtype = cfg.dtype
    radius = f32(scene.inner_radius)
    r_out = f32(scene.outer_radius)
    cos_tm = cos_theta_max(scene)
    INF = 1e30

    q = sphere_hit(res.seg_start, res.direction, radius)
    s_rim = cone_crossing_t(q, res.direction, cos_tm, radius, r_out, INF)
    clipped = (res.status == EXITED) & (s_rim < INF)
    rim_pt = q + res.direction.scale(s_rim)

    n_overflow = torch.clamp(clipped.sum(dtype=torch.int32) - m, min=0)
    idx, valid, (c_pt, c_dir, c_prev), (c_b,), dropped = _compact_gather(
        clipped, [rim_pt, res.direction, res.seg_start], [res.n_bounces],
        m, n_rays, group_capacity=max(256, m >> 1))
    n_overflow = n_overflow + dropped + main_overflow
    c_bounces = c_b + _i32(valid)

    # first rim bounce: roulette + the surface model about the rim normal
    dgen = device_generator(k_first, device)
    survive = (torch.rand((m,), generator=dgen, device=device, dtype=dtype)
               < f32(scene.reflectance))
    d_scat = scatter(dgen, scene.surface_model, c_dir,
                     cone_face_normal(c_pt), scene)
    status0 = _i32(torch.where(valid & survive, RUNNING, ABSORBED))
    c_dir = Vec3.where(survive, d_scat, c_dir)
    in_gap0 = valid & survive

    carry = (c_pt, c_dir, c_prev, status0, c_bounces, in_gap0)
    with span("trace.rim.cont", kind=kind):
        pos, direction, prev, status, bounces, n_cont = _rim_continuation(
            kind, k_cont, scene, carry, cfg, m, radius, r_out, cos_tm, INF,
            device)

    if n_cont is not None:
        n_overflow = n_overflow + n_cont
    sidx = torch.where(valid, idx, n_rays)
    return (_put_result(res, sidx, TraceResult(status, pos, prev, direction,
                                               bounces)),
            RimOverflow(total=n_overflow, grouped_drops=dropped))


def _rim_continuation(kind, k_cont, scene, carry, cfg, m, radius, r_out,
                      cos_tm, INF, device):
    """Finish the rim buffer's lanes from ``carry``: ``(pos, direction,
    prev, status, bounces, n_overflow)``, ``n_overflow`` None where the
    continuation loses no ray (the finish kernel, the eager loop)."""
    max_iters = int(scene.max_bounces)
    if kind == "hybrid":
        return _rim_continuation_hybrid(k_cont, scene, carry, cfg, radius,
                                        r_out, cos_tm, INF, device)
    if kind == "kernel":
        from .trace_cuda import finish_from_state

        fin = finish_from_state(k_cont, scene, carry, exact_rim=True)
        return (fin.last_point, fin.direction, fin.seg_start, fin.status,
                fin.n_bounces, None)
    if kind == "waves":
        # a wide continuation wave-compacts its tail: after the gap
        # resolves only re-entrant lanes survive, and the eager loop would
        # run the whole bounce tail at width m.  A schedule too tight for
        # the buffer suspends live clipped lanes at a compaction; that
        # count goes into RimOverflow.total.
        from .trace_waves import trace_waves_from_state

        res_c, cont_ovf = trace_waves_from_state(
            k_cont, scene, carry, cfg, wave_iters=RIM_CONT_WAVE_ITERS,
            shrink=RIM_CONT_SHRINK, min_wave=16384,
            first_wave_iters=RIM_CONT_FIRST_WAVE, device=device)
        return (res_c.last_point, res_c.direction, res_c.seg_start,
                res_c.status, res_c.n_bounces, cont_ovf)
    step = make_bounce_step(k_cont, scene, m, cfg, device)
    block = max(1, min(int(cfg.block_iters), max_iters))
    pos, direction, prev, status, bounces, _ = _while_trace(
        step, carry, max_iters, block)
    return (pos, direction, prev,
            torch.where(status == RUNNING, SUSPENDED, status), bounces, None)


def exit_count(result: TraceResult, exit_port_z=-100.0) -> torch.Tensor:
    """Number of rays whose last point passed the port-z test."""
    return result.exited_port_mask(exit_port_z).sum()
