"""Engine dispatch — the counterpart of ``trace_rays_auto`` in
``altair_tpu/core/trace_waves.py``.  The wave-compaction tracer itself is
not ported yet (ROADMAP.md, queue 1: "Waves")."""

from __future__ import annotations

import torch

from ..config import SphereScene, Source, TraceConfig
from .trace import (RimOverflow, TraceResult, no_overflow,
                    rim_deferred_capacity_shift, trace_rays_rim_deferred)
from .trace_cuda import trace_rays_fast
from .trace_direct import direct_applicable, trace_rays_direct


def trace_rays_auto(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """Engine dispatch:

    * statically-Lambertian scenes sample the trace outcome from its
      closed-form law (``trace_rays_direct``), wrapped in the deferred rim
      post-pass for exact-rim scenes; ``cfg.engine="simulate"`` opts out;
    * otherwise the simulate engine ``trace_rays_fast`` (the bounce kernel,
      plus the deferred rim post-pass).

    ``gen`` is a CPU ``torch.Generator`` (the key); ``device`` says where
    the rays are traced.  Returns ``(TraceResult, RimOverflow)``: the JAX
    function drops the rim overflow count, the port returns it so a caller
    can check it.  Branches that need code not yet ported raise
    ``NotImplementedError`` naming it: path history, a thick rim or
    non-scalar scene parameters (where ``rim_deferred_capacity_shift``
    returns None), custom scatter callables and QMC draws.
    """
    if cfg.engine not in ("auto", "simulate", "direct"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.keep_history:
        raise NotImplementedError(
            "path history (keep_history) is not ported to altair_tpu_torch")
    if cfg.engine in ("auto", "direct") and direct_applicable(scene, cfg):
        if not scene.exact_rim:
            return (trace_rays_direct(gen, scene, source, n_rays, cfg,
                                      device=device), no_overflow(device))
        shift = rim_deferred_capacity_shift(scene)
        if shift is not None:
            return trace_rays_rim_deferred(
                gen, scene, source, n_rays, cfg, capacity_shift=shift,
                main_tracer=trace_rays_direct, device=device)
    if cfg.engine == "direct":
        raise NotImplementedError(
            "engine='direct' requires a statically-Lambertian scene whose "
            "rim (if exact_rim) admits the deferred post-pass")
    return trace_rays_fast(gen, scene, source, n_rays, cfg, device=device)
