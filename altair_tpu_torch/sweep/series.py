"""Sweep series — the counterpart of ``altair_tpu/sweep/series.py``: the
reference's overnight for-loops as batched runs.

``sweepSeries`` (``fluxAtObserverOptimize.C:892-921``: port angles 163-178;
``fluxAtObserverFast.C:1641-1673``: 5 repeats at port 164; commented source-
direction series) are sequential overnight loops.  Here a series is either

* ``run_series`` — the faithful sequential loop (one CSV per member, same
  folder naming), or
* ``run_series_vmapped`` — all members in one call with one readback.  The
  JAX function maps one compiled program over a batched scene pytree;
  eager torch has no such transform, so the members run one after another
  on the device, planned together (one engine, one rim capacity, one exit
  capacity) and read back once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..config import (DetectorGrid, SphereScene, Source, TraceConfig,
                      validate)
from ..core.score import exit_capacity, fluxmap_trace_once_compact
from ..core.trace import (RimOverflow, fold_in, lossless,
                          rim_deferred_capacity_shift, trace_rays,
                          trace_rays_rim_deferred)
from .observer import SweepResult, sweep_detector_trace_once


def series_folder(prefix: str, source: Source, tag) -> str:
    """Folder naming of sweepSeries (``fluxAtObserverFast.C:1648-1653``):
    ``{prefix}_{srcX}_{srcY}_{srcZ}_{tag}`` with int-truncated cm."""
    return (f"{prefix}_{int(float(source.x))}_{int(float(source.y))}_"
            f"{int(float(source.z))}_{int(tag)}")


def run_series(
    base_scene: SphereScene,
    source: Source,
    *,
    device,
    port_angles: Sequence[float] = (164.0,),
    sources: Sequence[Source] | None = None,
    repeats: int = 5,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    save_root: str | None = ".",
    prefix: str = "portAngleSweep",
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
    verbose: bool = True,
) -> list[SweepResult]:
    """Sequential series of trace-once sweeps on ``device`` — one CSV per
    run, repeats accumulate with ``_1``, ``_2``, ... suffixes in the same
    folder exactly like the reference's repeat runs; the seed goes up by
    one per run.  ``sources`` adds the source axis of ``sweepSeries``
    (``fluxAtObserverOptimize.C:892-921``: the srcX loop): each member runs
    every ``port_angles`` x ``repeats`` combination, and the folder name
    carries its coordinates (``series_folder``) like the reference's
    per-position directories."""
    out = []
    s = seed
    for src in (sources if sources is not None else [source]):
        for port in port_angles:
            scene = base_scene.with_(theta_max_deg=float(port))
            folder = (os.path.join(save_root,
                                   series_folder(prefix, src, port))
                      if save_root is not None else None)
            for r in range(repeats):
                res = sweep_detector_trace_once(
                    scene, src, device=device, n_rays=n_rays, grid=grid,
                    seed=s, cfg=cfg, save_folder=folder, verbose=verbose)
                out.append(res)
                s += 1
    if verbose:
        print("\n***** ALL SWEEP SERIES COMPLETE *****\n")
    return out


def _stack(base, param_arrays: dict, skip=()):
    """``base`` with every field outside ``skip`` a float32 ``[n]`` CPU
    tensor: the given arrays, and the other fields broadcast."""
    n = len(next(iter(param_arrays.values())))
    fields = {}
    for f in dataclasses.fields(base):
        if f.name in skip:
            continue
        v = param_arrays.get(f.name)
        if v is None:
            v = torch.full((n,), float(getattr(base, f.name)),
                           dtype=torch.float32)
        else:
            v = torch.as_tensor(np.asarray(v, np.float32))
            if v.shape != (n,):
                raise ValueError(f"field {f.name}: expected shape "
                                 f"({n},), got {tuple(v.shape)}")
        fields[f.name] = v
    return dataclasses.replace(base, **fields)


def stack_sources(base: Source, **param_arrays) -> Source:
    """Build a batched source: each kwarg is an array over the series axis;
    the remaining fields broadcast (float32 CPU tensors).  The batched
    counterpart of ``sweepSeries``'s source parameterisation
    (``fluxAtObserverOptimize.C:892-921`` srcX/srcY/srcZ/dirXBase loops and
    the commented source-direction series).  E.g.
    ``stack_sources(SOURCE_OVERNIGHT, x=np.arange(-80., -39., 10.))``."""
    if not param_arrays:
        raise ValueError("stack_sources needs at least one field array "
                         "(e.g. x=np.array([...])) to set the series "
                         "length")
    return _stack(base, param_arrays)


def source_members(sources: Source):
    """Iterate the concrete ``Source`` members of a batched source."""
    if getattr(sources.x, "ndim", 0) != 1:
        raise TypeError(
            "sources must be a BATCHED Source (leading series axis on every "
            "field — build one with stack_sources); got a plain Source / "
            "scalar fields")
    for i in range(len(sources.x)):
        yield Source(*(float(getattr(sources, f.name)[i])
                       for f in dataclasses.fields(sources)))


# fields of a scene that a batched scene keeps scalar
_SCENE_META = ("surface_model", "max_bounces", "exact_rim")


def stack_scenes(base: SphereScene, **param_arrays) -> SphereScene:
    """Build a batched scene: each kwarg is an array over the series axis;
    the remaining numeric fields broadcast (float32 CPU tensors), the
    static fields (surface model, bounce cap, rim mode) stay scalar.  E.g.
    ``stack_scenes(SCENE_OPTIMIZE, theta_max_deg=np.arange(163, 179))``.
    The tracers take concrete scenes: ``scene_members`` iterates them."""
    return _stack(base, param_arrays, skip=_SCENE_META)


def scene_members(scenes: SphereScene):
    """Iterate the concrete ``SphereScene`` members of a batched scene."""
    n = len(scenes.theta_max_deg)
    for i in range(n):
        yield dataclasses.replace(scenes, **{
            f.name: float(getattr(scenes, f.name)[i])
            for f in dataclasses.fields(scenes) if f.name not in _SCENE_META})


def _series_tracer(base_scene: SphereScene, port_angles, cfg: TraceConfig):
    """``members_tracer`` for the port-angle members of ``base_scene``."""
    return members_tracer(
        [base_scene.with_(theta_max_deg=float(p)) for p in port_angles], cfg)


def members_tracer(members: Sequence[SphereScene], cfg: TraceConfig):
    """Pick the one tracer every member of a series runs, from the
    concrete member scenes (which share the static fields: surface model,
    bounce cap, rim mode), as the JAX functions do before they batch:

    * the direct sampler for a statically-Lambertian scene (unless
      ``cfg.engine == "simulate"``), under the deferred rim post-pass for
      an exact-rim scene;
    * otherwise the simulate engine's kernels (bounce or refill by the
      batch size) where every member admits them, under the same post-pass;
    * the eager ``trace_rays`` with the in-loop rim when any member's rim
      is too thick to defer, or the kernels cannot take the scene.

    The deferred post-pass runs at ONE capacity for all members: the
    smallest shift (largest buffer) any member plans, so no member's plan
    changes which rays overflow.  Returns ``tracer(gen, scene, source, n,
    cfg, device=...) -> (TraceResult, RimOverflow)``."""
    from ..core.trace_cuda import _kernel_padded, kernel_applicable
    from ..core.trace_direct import direct_applicable, trace_rays_direct

    def eager(gen, scene, source, n, cfg, *, device):
        res, ovf = lossless(trace_rays)(gen, scene, source, n, cfg,
                                        device=device)
        return res, RimOverflow(total=ovf, grouped_drops=ovf)

    base_scene = members[0]
    if direct_applicable(base_scene, cfg) and cfg.engine != "simulate":
        main = lossless(trace_rays_direct)
    else:
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct' requires a statically-Lambertian scene")
        if not all(kernel_applicable(m, cfg) for m in members):
            return eager
        main = _kernel_padded
    if not base_scene.exact_rim:
        def simple(gen, scene, source, n, cfg, *, device):
            res, ovf = main(gen, scene, source, n, cfg, device=device)
            return res, RimOverflow(total=ovf,
                                    grouped_drops=torch.zeros_like(ovf))
        return simple
    shifts = [rim_deferred_capacity_shift(m) for m in members]
    if any(s is None for s in shifts):
        if cfg.engine == "direct":
            raise NotImplementedError(
                "engine='direct': a member's rim does not admit the "
                "deferred post-pass (thick rim band)")
        return eager   # a member needs the in-loop rim
    shift = min(shifts)

    def tracer(gen, scene, source, n, cfg, *, device):
        return trace_rays_rim_deferred(gen, scene, source, n, cfg,
                                       capacity_shift=shift,
                                       main_tracer=main, device=device)

    return tracer


def run_series_vmapped(
    base_scene: SphereScene,
    source: Source = None,
    *,
    device,
    port_angles: Sequence[float] | None = None,
    sources: Source | None = None,
    n_rays: int = 100_000,
    grid: DetectorGrid = DetectorGrid(),
    seed: int = 0,
    cfg: TraceConfig = TraceConfig(),
):
    """All series members in one call.  Returns ``(fluxmaps [S, n_theta,
    n_phi] counts, exits [S])`` as numpy arrays.

    The name is the JAX function's, which maps one compiled program over a
    batched scene.  Here the members run as a loop on ``device``: member
    ``i`` traces from ``fold_in(key, i)``, all members share the tracer,
    the rim capacity (``_series_tracer``) and the exit capacity (the
    largest any member needs), no member's result is read back before the
    last one is scored, and one readback brings the counts, the exits and
    the overflow.  A nonzero overflow raises.

    The batch axis is EITHER ``port_angles`` (scene-parameter series,
    ``source`` fixed) OR ``sources`` (a batched ``Source`` from
    ``stack_sources`` — the srcX/Y/Z/dirXBase axis of ``sweepSeries``,
    ``fluxAtObserverOptimize.C:892-921``, scene fixed)."""
    if (port_angles is None) == (sources is None):
        raise ValueError("pass exactly one of port_angles= (scene series) "
                         "or sources= (source series)")
    if sources is not None:
        srcs = list(source_members(sources))
        for s in srcs:
            validate(base_scene, s)  # same fail-fast as the sequential path
        scenes = [base_scene] * len(srcs)
        ports = [float(base_scene.theta_max_deg)]
    else:
        ports = [float(p) for p in port_angles]
        scenes = [base_scene.with_(theta_max_deg=p) for p in ports]
        srcs = [source] * len(scenes)
    tracer = _series_tracer(base_scene, ports, cfg)
    cap = max(exit_capacity(base_scene.with_(theta_max_deg=p), n_rays)
              for p in ports)
    key = torch.Generator().manual_seed(seed)
    rows = []
    for i, (scene, src) in enumerate(zip(scenes, srcs)):
        res, rim = tracer(fold_in(key, i), scene, src, n_rays, cfg,
                          device=device)
        counts, overflow = fluxmap_trace_once_compact(
            res, grid, cap, scene.exit_port_z)
        exits = res.exited_port_mask(scene.exit_port_z).sum(dtype=torch.int32)
        rows.append(torch.cat([counts.reshape(-1), exits.reshape(1),
                               (overflow + rim.total).reshape(1)]))
    out = torch.stack(rows).cpu().numpy()
    if int(out[:, -1].sum()):
        raise RuntimeError(
            f"series: {int(out[:, -1].sum())} rays unscored or unfinished — "
            "statistically impossible at the planned capacities; investigate")
    return (out[:, :-2].reshape(len(rows), grid.n_theta, grid.n_phi),
            out[:, -2])
