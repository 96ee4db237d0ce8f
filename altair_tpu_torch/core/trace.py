"""The ray statuses, the keys, the bounce step and the eager bounce loop —
the PyTorch counterpart of ``altair_tpu/core/trace.py`` (whose deferred-rim
post-pass is the port's ``core/route.py``).

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
    # start of the last segment: an exit starts at the port-cap crossing on
    # the refill path and at the last wall point (or the source) elsewhere,
    # both on the exit line; any other ray at its second-to-last point
    seg_start: Vec3
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


def trace_eager_from_state(gen: torch.Generator, scene: SphereScene, state,
                           cfg: TraceConfig, device, block: int | None = None,
                           wrap_step=None) -> TraceResult:
    """Run the eager bounce loop from the bounce-step carry ``state`` of
    mid-flight lanes until every lane is dead or ``scene.max_bounces``
    steps, with the step's draws keyed by ``gen`` and the alive check once
    per ``block`` steps (default ``cfg.block_iters``); lanes still running
    at the cap are suspended (``ray->Suspend()``).  ``wrap_step(step)``,
    when given, returns the step the loop runs in place of ``step``."""
    max_iters = int(scene.max_bounces)
    step = make_bounce_step(gen, scene, state[3].shape[0], cfg, device)
    if wrap_step is not None:
        step = wrap_step(step)
    block = max(1, min(int(cfg.block_iters if block is None else block),
                       max_iters))
    pos, direction, prev, status, bounces, _ = _while_trace(
        step, state, max_iters, block)
    return TraceResult(torch.where(status == RUNNING, SUSPENDED, status), pos,
                       prev, direction, bounces)


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
    init = (pos, direction, pos, zeros, zeros,
            torch.zeros((n_rays,), dtype=torch.bool, device=device))

    keep_hist = int(cfg.keep_history)
    hist = hlen = wrap = None
    if keep_hist:
        hist = torch.zeros((keep_hist, n_rays, 3), dtype=dtype, device=device)
        hist[0] = pos.stack()
        hlen = torch.ones((n_rays,), dtype=torch.int64, device=device)
        lanes = torch.arange(n_rays, device=device)

        def wrap(bare_step):
            def step(it, carry):
                nonlocal hlen
                rec = carry[3] == RUNNING
                carry = bare_step(it, carry)
                if it < max_iters:
                    # one masked write a step: running lanes record their
                    # new point at their own slot, the others rewrite what
                    # is there
                    slot = torch.clamp(hlen, max=keep_hist - 1)
                    hist[slot, lanes] = torch.where(
                        rec[:, None], carry[0].stack(), hist[slot, lanes])
                    hlen = torch.where(
                        rec, torch.clamp(hlen + 1, max=keep_hist), hlen)
                return carry
            return step

    res = trace_eager_from_state(gen, scene, init, cfg, device,
                                 wrap_step=wrap)
    return res._replace(history=hist,
                        history_len=None if hlen is None else _i32(hlen))


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


def exit_count(result: TraceResult, exit_port_z=-100.0) -> torch.Tensor:
    """Number of rays whose last point passed the port-z test."""
    return result.exited_port_mask(exit_port_z).sum()
