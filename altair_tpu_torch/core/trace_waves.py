"""The wave-compaction tracer and the engine dispatch — the PyTorch
counterpart of ``altair_tpu/core/trace_waves.py``.

The eager bounce loop keeps every lane of its batch until the last ray
dies.  The waves tracer runs a fixed block of iterations over the batch,
compacts the survivors into a ``shrink``-times smaller buffer (a static
capacity; rays that do not fit are counted in ``n_overflow`` and
suspended), and recurses down to ``min_wave`` lanes, where a tail runs the
eager loop to extinction.  The schedule of widths and iterations depends
only on the batch size and the arguments (``wave_schedule``).

Keys: JAX's ``fold_in(key, wave)`` is a sub-generator per wave drawn from
the key (``trace.split``), so the port's streams differ from JAX's and
parity is statistical.
"""

from __future__ import annotations

import collections
import numbers

import torch

from ..config import SphereScene, Source, TraceConfig
from .compact import nonzero_indices
from .geometry import Vec3
from .trace import (ABSORBED, RUNNING, SUSPENDED, RimOverflow, TraceResult,
                    _i32, _put_result, _source_rays, _while_trace,
                    lossless, make_bounce_step, no_overflow,
                    rim_deferred_capacity_shift, split, trace_rays,
                    trace_rays_rim_deferred)
from .trace_cuda import kernel_applicable, trace_rays_fast
from .trace_direct import direct_applicable, trace_rays_direct

# the plans that trace_waves_from_state ran, newest last (the last 16
# calls): {"width", "waves", "tail"} as wave_schedule gives them.  A
# caller clears it before a run and reads it after, as it does
# trace_cuda.launch_counts.
wave_plans: collections.deque = collections.deque(maxlen=16)


def wave_schedule(n_rays: int, max_iters: int, wave_iters: int = 256,
                  shrink: int = 16, min_wave: int = 65536,
                  first_wave_iters: int | None = None):
    """The static plan of ``trace_waves_from_state``: ``(waves, tail)``,
    where ``waves`` lists ``(width, iterations)`` of wave 0 (the full
    batch) and of each compacted wave, and ``tail`` is ``(width, at most
    this many iterations)`` of the eager tail, or None when the waves used
    up ``max_iters``."""
    iters = min(wave_iters if first_wave_iters is None else first_wave_iters,
                max_iters)
    waves = [(n_rays, iters)]
    it0, m = iters, n_rays
    while m > min_wave and it0 < max_iters:
        m = max(min_wave, m // shrink)
        iters = min(wave_iters, max_iters - it0)
        waves.append((m, iters))
        it0 += iters
    tail = (m, max_iters - it0) if it0 < max_iters else None
    return waves, tail


def trace_rays_waves(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    wave_iters: int = 256,
    shrink: int = 16,
    min_wave: int = 65536,
    first_wave_iters: int | None = None,
    *,
    device,
) -> tuple[TraceResult, torch.Tensor]:
    """Trace ``n_rays`` from the source with the waves tracer.  Returns
    ``(TraceResult, n_overflow)``: ``n_overflow`` counts rays that did not
    fit a compacted wave and were suspended early (zero with the default
    shrink except for reflectance ~1 scenes; see ``waves_safe``)."""
    pos, direction = _source_rays(source, n_rays, cfg.dtype, device)
    zeros = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    state = (pos, direction, pos, zeros, zeros,
             torch.zeros((n_rays,), dtype=torch.bool, device=device))
    return trace_waves_from_state(gen, scene, state, cfg, wave_iters, shrink,
                                  min_wave, first_wave_iters, device=device)


def trace_waves_from_state(
    gen: torch.Generator,
    scene: SphereScene,
    state,
    cfg: TraceConfig = TraceConfig(),
    wave_iters: int = 256,
    shrink: int = 16,
    min_wave: int = 65536,
    first_wave_iters: int | None = None,
    *,
    device,
) -> tuple[TraceResult, torch.Tensor]:
    """The waves tracer from a mid-flight ray state ``(pos, direction,
    prev, status, bounces, in_gap)`` (the bounce-step carry).  Used by
    ``trace_rays_waves``, by the deferred-rim continuation and by the
    refill kernel's straggler finish.

    ``first_wave_iters`` (None = ``wave_iters``) shortens wave 0 only, for
    an entry state that is mostly dead lanes.  The tail caps its bounce
    budget at the iterations that remain.  Returns ``(TraceResult,
    n_overflow)``."""
    n_rays = state[0].x.shape[0]
    waves, tail = wave_schedule(n_rays, int(scene.max_bounces), wave_iters,
                                shrink, min_wave, first_wave_iters)
    wave_plans.append({"width": n_rays, "waves": waves, "tail": tail})
    n_overflow = torch.zeros((), dtype=torch.int32, device=device)

    def run_wave(m, iters, carry):
        (wkey,) = split(gen, 1)
        step = make_bounce_step(wkey, scene, m, cfg, device)
        for it in range(iters):
            carry = step(it, carry)
        return carry

    # wave 0 over the full batch, in the batch's own order
    m, iters = waves[0]
    pos, direction, prev, status, bounces, in_gap = run_wave(m, iters, state)
    out = TraceResult(status, pos, prev, direction, bounces)
    # perm[i]: the batch index of lane i; n_rays marks a padding lane, whose
    # writes go to the sink row of _put
    perm = torch.arange(n_rays, device=device)

    for m_next, iters in waves[1:]:
        alive = status == RUNNING
        n_overflow = n_overflow + torch.clamp(
            alive.sum(dtype=torch.int32) - m_next, min=0)
        idx = nonzero_indices(alive, m_next, m)
        valid = idx < m
        safe = torch.clamp(idx, max=m - 1)

        def g(a):
            return torch.where(valid, a[safe], torch.zeros_like(a[safe]))

        def gv(v: Vec3) -> Vec3:
            return Vec3(g(v.x), g(v.y), g(v.z))

        pos, direction, prev = gv(pos), gv(direction), gv(prev)
        bounces = g(bounces)
        in_gap = g(in_gap)
        status = _i32(torch.where(valid, RUNNING, ABSORBED))
        perm = torch.where(valid, perm[safe], n_rays)

        pos, direction, prev, status, bounces, in_gap = run_wave(
            m_next, iters, (pos, direction, prev, status, bounces, in_gap))
        m = m_next
        out = _put_result(out, perm,
                          TraceResult(status, pos, prev, direction, bounces))

    if tail is not None:
        # finish the stragglers with the eager loop at width m; the step's
        # guard compares its own index with the scene cap, so the cap is
        # the iterations that remain
        (wkey,) = split(gen, 1)
        step = make_bounce_step(wkey, scene.with_(max_bounces=tail[1]), m,
                                cfg, device)
        pos, direction, prev, status, bounces, _ = _while_trace(
            step, (pos, direction, prev, status, bounces, in_gap), tail[1],
            max(1, min(int(cfg.block_iters), tail[1])))
        out = _put_result(out, perm,
                          TraceResult(status, pos, prev, direction, bounces))

    return out._replace(status=torch.where(out.status == RUNNING, SUSPENDED,
                                           out.status)), n_overflow


def waves_safe(scene: SphereScene, wave_iters: int = 256,
               shrink: int = 16) -> bool:
    """True when the expected wave-survival fraction fits the compaction
    capacity with a 2x margin (needs scalar scene parameters).  Survival
    per bounce = reflectance * (1 - p_port)."""
    if not all(isinstance(v, numbers.Number)
               for v in (scene.theta_max_deg, scene.reflectance)):
        return False
    from ..config import port_escape_probability

    s = float(scene.reflectance) * (1 - port_escape_probability(
        scene.theta_max_deg))
    return s ** wave_iters < 1 / (2 * shrink)


def trace_rays_auto(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    waves_threshold: int = 262_144,
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """Engine dispatch:

    * statically-Lambertian scenes sample the trace outcome from its
      closed-form law (``trace_rays_direct``), wrapped in the deferred rim
      post-pass for exact-rim scenes; ``cfg.engine="simulate"`` opts out;
    * scenes the kernels take run the simulate engine ``trace_rays_fast``
      (the bounce kernel, or the refill kernel and its straggler finish at
      n >= ``trace_cuda.REFILL_MIN``, plus the deferred rim post-pass);
    * the rest (float64, or a thick rim) run ``trace_rays_waves`` at
      ``n_rays >= waves_threshold`` when ``waves_safe``, else the eager
      ``trace_rays``: under the deferred rim post-pass when the rim admits
      it, with the in-loop exact rim otherwise.

    ``gen`` is a CPU ``torch.Generator`` (the key); ``device`` says where
    the rays are traced.  Returns ``(TraceResult, RimOverflow)``: the JAX
    function drops the overflow counts, the port returns them (rim
    capacity, the waves tracer's and the refill handoff's) so a caller can
    check them.  Path history (``cfg.keep_history``) runs the eager
    ``trace_rays``, the only tracer with a history buffer; a custom scatter
    callable is no static law, so it runs the waves or eager tracers.
    """
    if cfg.engine not in ("auto", "simulate", "direct"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.keep_history:
        if cfg.engine == "direct":
            raise ValueError("direct sampling has no path history")
        return (trace_rays(gen, scene, source, n_rays, cfg, device=device),
                no_overflow(device))
    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        if not scene.exact_rim:
            return (trace_rays_direct(gen, scene, source, n_rays, cfg,
                                      device=device), no_overflow(device))
        shift = rim_deferred_capacity_shift(scene)
        if shift is not None:
            return trace_rays_rim_deferred(
                gen, scene, source, n_rays, cfg, capacity_shift=shift,
                main_tracer=lossless(trace_rays_direct), device=device)
        # a thick rim needs the in-loop exact-rim trace: on to the
        # simulation engines
    if cfg.engine == "direct":
        raise NotImplementedError(
            "engine='direct' requires a statically-Lambertian scene whose "
            "rim (if exact_rim) admits the deferred post-pass")
    if kernel_applicable(scene, cfg):
        return trace_rays_fast(gen, scene, source, n_rays, cfg, device=device)
    use_waves = n_rays >= waves_threshold and waves_safe(scene)
    shift = rim_deferred_capacity_shift(scene) if scene.exact_rim else None
    if shift is not None:
        return trace_rays_rim_deferred(
            gen, scene, source, n_rays, cfg, capacity_shift=shift,
            main_tracer=trace_rays_waves if use_waves else None, device=device)
    if use_waves:
        res, ovf = trace_rays_waves(gen, scene, source, n_rays, cfg,
                                    device=device)
        return res, RimOverflow(total=ovf, grouped_drops=torch.zeros_like(ovf))
    return (trace_rays(gen, scene, source, n_rays, cfg, device=device),
            no_overflow(device))
