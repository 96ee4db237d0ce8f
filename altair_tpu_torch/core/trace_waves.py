"""The wave-compaction tracer — the PyTorch counterpart of
``altair_tpu/core/trace_waves.py`` (whose engine dispatch is the port's
``core/route.py``).

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

import numbers

import torch

from ..config import SphereScene, Source, TraceConfig
from ..io.profiling import count, span
from .compact import nonzero_indices
from .geometry import Vec3
from .trace import (ABSORBED, RUNNING, SUSPENDED, TraceResult, _i32,
                    _put_result, _source_rays, make_bounce_step, split,
                    trace_eager_from_state)


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
    ``trace_rays_waves``.

    ``first_wave_iters`` (None = ``wave_iters``) shortens wave 0 only, for
    an entry state that is mostly dead lanes.  The tail caps its bounce
    budget at the iterations that remain.  Returns ``(TraceResult,
    n_overflow)``.

    The span ``loop.waves``, with the batch's ``width`` and the plan
    (``waves``, ``tail``) of ``wave_schedule``; the eager tail is its own
    ``loop.eager``.  While tracing, the waves count their lane-steps as
    ``_while_trace`` does: a compare and an add a step, one sum a call."""
    n_rays = state[0].x.shape[0]
    waves, tail = wave_schedule(n_rays, int(scene.max_bounces), wave_iters,
                                shrink, min_wave, first_wave_iters)
    with span("loop.waves", width=n_rays, waves=waves, tail=tail) as sp:
        live = [] if sp.on else None
        out = _waves(gen, scene, state, cfg, waves, tail, live, device)
        if live is not None:
            count("lane_steps_issued", sum(m * it for m, it in waves))
            count("lane_steps_live", torch.cat(live).sum())
    return out


def _waves(gen, scene, state, cfg, waves, tail, live, device):
    """``trace_waves_from_state``'s body; ``live``, when a list, receives
    each wave's per-lane count of running steps."""
    n_rays = state[0].x.shape[0]
    n_overflow = torch.zeros((), dtype=torch.int32, device=device)

    def run_wave(m, iters, carry):
        (wkey,) = split(gen, 1)
        step = make_bounce_step(wkey, scene, m, cfg, device)
        acc = torch.zeros_like(carry[3]) if live is not None else None
        for it in range(iters):
            if acc is not None:
                acc += carry[3] == RUNNING
            carry = step(it, carry)
        if acc is not None:
            live.append(acc)
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
        out = _put_result(out, perm, trace_eager_from_state(
            wkey, scene.with_(max_bounces=tail[1]),
            (pos, direction, prev, status, bounces, in_gap), cfg, device))

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
