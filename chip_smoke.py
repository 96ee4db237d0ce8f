#!/usr/bin/env python
"""Smoke run of altair_tpu_torch on one NVIDIA GPU (the Hopper port of the
trace-once flux-map path, the simulate engine's large-batch path, the
retrace flux-map path, the single-card studies: series, in-sphere disk
sweep, scatter-retrace, path history and the other CLI subcommands, and
the multi-device layer).

    python3 chip_smoke.py

Builds the CUDA bounce and refill kernels from altair_tpu_torch/csrc (one
nvcc each, in parallel), holds each against its plain PyTorch version,
drives the headline job (production scene, SOURCE_OVERNIGHT, 100,000 rays,
the full 180x90 detector grid) through ``trace_rays_auto`` +
``fluxmap_trace_once_compact`` with both engines and through
``sweep_detector_trace_once``, traces 4,194,304 rays through both engines
(the simulate engine through the refill kernel, its tail handoff and the
waves tracer), and times the refill kernel, its straggler finish and the
simulate engine at 4M rays with and without the handoff.  The refill
kernel (warp-owned lane pools) is held against its plain version at every
size the main paths launch it with (2^20, 4,194,304 and the retrace
chunk's), for the four laws with and without the handoff, and at 65,536
rays against the lane-static schedule without it.  Each kernel's bound is
the larger of its bytes over the memory rate, the arithmetic of its
per-step SASS instruction mix (cuobjdump) times the steps this run traced
on its slowest pipe, and for the bounce kernel its longest ray's serial
chain.  Then the
retrace path: the Sobol generator against the CPU bit for bit, the
binomial retrace map at bench size (50,000 rays per position, oversample
128, the full grid) against a 4M-ray trace-once map, 16 replicate maps,
``sweep_detector_retrace`` on 2 theta rows with both engines (the simulate
one through the refill kernel) and a resume.  Then the studies: the
port-angle series 163-178 in one call (and 4 members through the bounce
kernel, and 2 sequential members with their folders), the in-sphere disk
sweep of the corpus scene over 362 positions (plus a cut retrace, and a
thin-shell simulate retrace chunk through the refill kernel), the
scatter-retrace sweep (and once with a MIXED_BRDF wall through the bounce
kernel), 100 ray paths with history and their HTML view, and the
``fluxmap``, ``series``, ``insphere``, ``scatter-retrace`` and
``visualize`` CLI subcommands in their own processes.  The refill kernel is
held against its plain version at every size a main path launches it with
(4,194,304 and 1,600,000 rays, the dispatched setting); the other laws and
the kernel without the handoff at 2^20 and 65,536 rays.  Then the
multi-device layer (``altair_tpu_torch.parallel``): at world size 1 over
NCCL in this process, ``sharded_fluxmap`` on the headline job with both
engines (the map equal, cell for cell, to the single-device run from
``fold_in(key, 0)``), ``sharded_trace`` at 4,194,304 rays through the
refill kernel, and every other route at 20,000 rays held exactly against
the single-device functions; then two ranks over gloo on this one card,
started by ``python -m altair_tpu_torch.parallel.demo --launch 2``, whose
reduced outputs must equal the sum of the two single-process calls.  Each
phase prints one JSON line, with the seconds since the start at which it ended; any
failed check raises, so the exit code is not 0.
The last three lines are the card's name and power limit from nvidia-smi,
the kernel table as JSON, and the ok line.  Exits non-zero without a CUDA
device.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

N_HEADLINE = 100_000
N_SCALE = 4_194_304
MAX_BOUNCES = 4096            # as bench.py: P(alive > 2000 bounces) < 1e-15
# exit fraction of the production scene: 0.4257 +- 4 sigma at 100k rays
EXIT_WINDOW = (0.4194, 0.4320)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also says when it ended, in
    seconds since the script began."""
    if "phase" in obj:
        obj = {**obj, "ended_at_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(a, b):
    """Lanes where status and bounce count agree, and the largest position
    or direction difference on those lanes."""
    agree = (a.status == b.status) & (a.n_bounces == b.n_bounces)
    err = 0.0
    for f in ("last_point", "seg_start", "direction"):
        for c in "xyz":
            d = (getattr(getattr(a, f), c) - getattr(getattr(b, f), c)).abs()
            if bool(agree.any()):
                err = max(err, float(d[agree].max()))
    return float(agree.float().mean()), err


def live_equal(a, b) -> bool:
    """Two refill ``LiveState``s (or two Nones) hold the same values."""
    if a is None or b is None:
        return a is None and b is None
    return (all(torch.equal(x, y) for x, y in zip(a.pos, b.pos))
            and all(torch.equal(x, y) for x, y in zip(a.direction,
                                                      b.direction))
            and torch.equal(a.ray_idx, b.ray_idx)
            and torch.equal(a.bounces, b.bounces))


def cuda_ms(fn, reps=5) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after a warm one
    (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel_vs_plain(device, n=65_536, max_bounces=256):
    """Kernel against plain, hash mode, simple mode, all four laws."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from altair_tpu_torch.core import trace_cuda

    rows = {}
    for model in SurfaceModel:
        scene = SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False,
                                     surface_model=model)
        sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
        k = trace_cuda.bounce((0, 2024), sv, srcv, n, int(model),
                              max_bounces, rng="hash")
        sync(device)
        p = trace_cuda.bounce_plain((0, 2024), sv, srcv, n, int(model),
                                    max_bounces, rng="hash")
        agree, err = compare(k, p)
        rows[model.name] = {"agree": agree, "max_abs_err_cm": err,
                            "exit_fraction": float(
                                (k.status == 1).float().mean())}
        check(agree >= 0.999, f"{model.name}: {agree} of lanes agree")
        check(err <= 1e-3, f"{model.name}: positions differ by {err} cm")
    return {"phase": "kernel_vs_plain_hash", "n": n,
            "max_bounces": max_bounces, "laws": rows,
            "tolerance": "agree>=0.999, |dx|<=1e-3 cm"}


def _hits_per_ray(res, grid, exit_port_z):
    """Per-ray count of grid positions hit, by the direct plane/disk test
    (``line_hits_disk``) in position chunks: the summands of the map
    total, for its standard error."""
    from altair_tpu_torch.core.geometry import Vec3, line_hits_disk
    from altair_tpu_torch.core.score import grid_centers_normals

    mask = res.exited_port_mask(exit_port_z)
    idx = torch.nonzero(mask)[:, 0]
    e = Vec3(*(v[idx][:, None] for v in res.last_point))
    d = Vec3(*(v[idx][:, None] for v in res.direction))
    C, Nrm = grid_centers_normals(grid, exit_port_z, idx.device)
    h = torch.zeros(idx.shape[0], dtype=torch.float64, device=idx.device)
    for i in range(0, C.shape[0], 1080):
        c = Vec3(*(C[i:i + 1080, j][None, :] for j in range(3)))
        n = Vec3(*(Nrm[i:i + 1080, j][None, :] for j in range(3)))
        h += line_hits_disk(e, d, c, n, grid.width / 2.0).sum(1)
    n_rays = mask.shape[0]
    return float(h.sum()), math.sqrt(n_rays * float(
        torch.cat([h, h.new_zeros(n_rays - h.shape[0])]).var()))


def phase_headline(device, engine, n=N_HEADLINE, grid=None, repeats=3,
                   window=EXIT_WINDOW, seed=0):
    """The headline job through trace_rays_auto + the compacting scorer:
    one warm run, then the best of ``repeats`` timed runs, each ending in
    a device sync and the exit-count readback."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  DetectorGrid, TraceConfig, trace_rays_auto)
    from altair_tpu_torch.core.score import (exit_capacity,
                                             fluxmap_trace_once_compact)

    grid = grid or DetectorGrid()
    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    cfg = TraceConfig(engine=engine)
    cap = exit_capacity(scene, n)

    def run(i):
        res, rim = trace_rays_auto(torch.Generator().manual_seed(seed + i),
                                   scene, SOURCE_OVERNIGHT, n, cfg,
                                   device=device)
        counts, ovf = fluxmap_trace_once_compact(res, grid, cap,
                                                 scene.exit_port_z)
        n_exit = int(res.exited_port_mask(scene.exit_port_z).sum())
        return res, counts, int(ovf), int(rim), n_exit

    run(0)
    times = []
    for i in range(1, repeats + 1):
        sync(device)
        t0 = time.perf_counter()
        res, counts, ovf, rim, n_exit = run(i)
        sync(device)
        times.append(time.perf_counter() - t0)
        check(ovf == 0 and rim == 0,
              f"{engine}: compaction overflow {ovf}, rim overflow {rim}")
    frac = n_exit / n
    check(window[0] <= frac <= window[1],
          f"{engine}: exit fraction {frac} outside {window}")
    total = int(counts.sum())
    h_total, sigma = _hits_per_ray(res, grid, scene.exit_port_z)
    check(counts.shape == (grid.n_theta, grid.n_phi), "map shape")
    # the Plucker scorer and the direct disk test differ only on pairs at
    # the disk edge (float32 rounding): a few per million hits
    check(abs(h_total - total) <= 1e-4 * total + 10,
          f"{engine}: scorer total {total} vs direct test {h_total}")
    return {"phase": f"headline_{engine}", "n_rays": n,
            "grid": [grid.n_theta, grid.n_phi], "exit_fraction": frac,
            "map_total": total, "map_total_sigma": sigma,
            "best_s": min(times), "times_s": times,
            "compaction_overflow": ovf, "rim_overflow": rim}


def phase_sweep(device, save_folder, n=N_HEADLINE):
    """The library entry point: sweep_detector_trace_once writes the
    reference CSV."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu_torch.io import read_fluxmap
    from altair_tpu_torch.sweep import sweep_detector_trace_once

    r = sweep_detector_trace_once(
        SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES), SOURCE_OVERNIGHT,
        device=device, n_rays=n, save_folder=save_folder, verbose=False)
    th, ph, frac, meta = read_fluxmap(r.path)
    check(len(frac) == r.fluxmap.size, "CSV rows")
    check(meta.get("Total rays exiting port") == f"{r.n_exited} out of {n}",
          "CSV footer")
    return {"phase": "sweep_detector_trace_once", "csv": r.path,
            "rows": len(frac), "exit_fraction": r.n_exited / n,
            "trace_s": r.trace_time_s, "score_s": r.score_time_s}


def phase_scale(device, n=N_SCALE, seed=100, window=EXIT_WINDOW):
    """Trace-only throughput of both engines at n rays (one warm run, one
    timed run each).  The simulate engine's run is this slice's main path:
    the kernel counts are set to 0 just before it and read just after.
    ``waves`` lists the wave tracer's plans that the timed run ran, in
    call order: the refill handoff's straggler finish, then the rim
    continuation."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  TraceConfig, trace_rays_auto)
    from altair_tpu_torch.core import trace_cuda, trace_waves

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    out = {"phase": "scale", "n_rays": n}
    for engine in ("auto", "simulate"):
        cfg = TraceConfig(engine=engine)
        trace_cuda.reset_launch_counts()
        for i in range(2):
            trace_waves.wave_plans.clear()
            sync(device)
            t0 = time.perf_counter()
            res, rim = trace_rays_auto(
                torch.Generator().manual_seed(seed + i), scene,
                SOURCE_OVERNIGHT, n, cfg, device=device)
            n_exit = int(res.exited_port_mask().sum())
            sync(device)
            dt = time.perf_counter() - t0
        frac = n_exit / n
        check(int(rim) == 0, f"scale {engine}: rim overflow {int(rim)}")
        check(window[0] <= frac <= window[1],
              f"scale {engine}: exit fraction {frac} outside {window}")
        out[engine] = {"s": dt, "rays_per_s": n / dt, "exit_fraction": frac,
                       "rim_overflow": int(rim),
                       "launches": dict(trace_cuda.launch_counts),
                       "waves": list(trace_waves.wave_plans)}
    check(out["simulate"]["launches"]["refill"] > 0,
          "scale: the simulate engine never launched the refill kernel")
    check(len(out["simulate"]["waves"]) == 2,
          "scale: the simulate engine did not finish both the handoff and "
          f"the rim continuation in the waves tracer: "
          f"{out['simulate']['waves']}")
    fa, fs = out["auto"]["exit_fraction"], out["simulate"]["exit_fraction"]
    check(abs(fa - fs) < 4 * math.sqrt(2 * fa * (1 - fa) / n),
          f"scale: engines disagree, {fa} vs {fs}")
    return out


def phase_refill_vs_plain(device, n=65_536, max_bounces=256, budget=4):
    """The refill kernel against refill_plain at the same unit, hash
    stream, all four laws, without and with the handoff (fraction 0.4):
    the 11 slot fields, and the 8 live planes when there are any.  Without
    the handoff the kernel is also held against the lane-static schedule
    (``threads_per_unit`` = the unit's lanes: a thread per lane, all from
    step 0, the schedule before the warp pools), which runs other steps
    in another order: a lane's slots do not depend on its thread."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from altair_tpu_torch.core import trace_cuda

    rows = {}
    err_max = 0.0
    for model in SurfaceModel:
        scene = SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False,
                                     surface_model=model)
        sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
        for frac in (0.0, 0.4):
            thresh = int(frac * trace_cuda.REFILL_LANES * budget)
            args = ((0, 2025), sv, srcv, n, int(model), max_bounces, budget,
                    thresh)
            k, k_live = trace_cuda.refill(*args, rng="hash")
            sync(device)
            p, p_live = trace_cuda.refill_plain(*args, rng="hash")
            agree, err = compare(k, p)
            same_live = live_equal(k_live, p_live)
            name = f"{model.name}/thresh={thresh}"
            rows[name] = {"agree": agree, "max_abs_err_cm": err,
                          "live_equal": same_live,
                          "pending": int((k.status == 0).sum()),
                          "exit_fraction": float(
                              (k.status == 1).float().mean())}
            check(agree >= 0.999, f"refill {name}: {agree} of slots agree")
            check(err <= 1e-3, f"refill {name}: positions differ by {err}")
            check(same_live, f"refill {name}: live planes differ")
            check(thresh == 0 or rows[name]["pending"] > 0,
                  f"refill {name}: the handoff left no stragglers")
            if thresh == 0:
                b = trace_cuda.refill_plain(
                    *args, rng="hash",
                    threads_per_unit=trace_cuda.REFILL_LANES)[0]
                agree_b, err_b = compare(k, b)
                rows[name]["lane_static"] = {"agree": agree_b,
                                             "max_abs_err_cm": err_b}
                check(agree_b >= 0.999 and err_b <= 1e-3,
                      f"refill {name}: the kernel differs from the "
                      f"lane-static schedule ({agree_b}, {err_b} cm)")
                err = max(err, err_b)
            err_max = max(err_max, err)
    return {"phase": "refill_vs_plain_hash", "n": n, "budget": budget,
            "max_bounces": max_bounces, "laws": rows,
            "max_abs_err_cm": err_max,
            "tolerance": "agree>=0.999, |dx|<=1e-3 cm, live planes equal"}


def _refill_main_shape(device):
    """The simulate engine's main-trace shape for the refill kernel:
    production scene without the rim, 4096 cap, the engine's budget and
    handoff threshold.  Returns ``(scene, scene_vec, src_vec, budget,
    thresh)``."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu_torch.core import trace_cuda

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
    budget = trace_cuda._REFILL_BUDGET
    thresh = int(trace_cuda._REFILL_HANDOFF * trace_cuda.REFILL_LANES
                 * budget)
    return scene, sv, srcv, budget, thresh


def _refill_against_plain(device, n, model=None, rng="philox",
                          handoff=True):
    """The refill kernel at n rays in the main-trace shape (by default
    philox, Lambertian, the handoff at ``_REFILL_HANDOFF``) against
    ``refill_plain`` on the same inputs: kernel ms (CUDA events), plain
    ms (host clock, one call), per-slot agreement and the live planes.
    Fails unless >= 99.9% of slots agree within 1e-3 cm and the live
    planes are equal.  Returns ``(row, result, live)`` of the kernel."""
    from altair_tpu_torch import SOURCE_OVERNIGHT, SurfaceModel
    from altair_tpu_torch.core import trace_cuda

    scene, _, _, budget, thresh = _refill_main_shape(device)
    model = SurfaceModel.LAMBERTIAN if model is None else model
    sv, srcv = trace_cuda.kernel_operands(
        scene.with_(surface_model=model), SOURCE_OVERNIGHT, device)
    thresh = thresh if handoff else 0
    args = ((7, 8), sv, srcv, n, int(model), MAX_BOUNCES, budget, thresh)
    row = {"refill_ms": cuda_ms(lambda: trace_cuda.refill(*args, rng=rng))}
    res, live = trace_cuda.refill(*args, rng=rng)
    sync(device)
    t0 = time.perf_counter()
    p, p_live = trace_cuda.refill_plain(*args, rng=rng)
    sync(device)
    row["plain_ms"] = (time.perf_counter() - t0) * 1e3
    agree, err = compare(res, p)
    row.update(agree=agree, max_abs_err_cm=err,
               live_equal=live_equal(live, p_live))
    name = f"refill n={n} {model.name}/{rng}/thresh={thresh}"
    check(agree >= 0.999, f"{name}: {agree} of slots agree")
    check(err <= 1e-3, f"{name}: positions differ by {err}")
    check(row["live_equal"], f"{name}: live planes differ")
    return row, res, live


def _refill_laws_against_plain(device, n):
    """The refill kernel at n rays against ``refill_plain`` beyond the
    main shape: Lambertian without the handoff on the production stream
    (philox), and the other three laws with the handoff at
    ``_REFILL_HANDOFF`` on the hash stream (their plain versions' Philox
    rounds take longest at this size).  A plain version costs 1 to 25 s
    at any size (its cost is warp steps, not width), so the other laws
    without the handoff are held at 65,536 rays only
    (``phase_refill_vs_plain``).  Returns one row per law and setting."""
    from altair_tpu_torch import SurfaceModel

    rows = {}
    for model in SurfaceModel:
        lambertian = model == SurfaceModel.LAMBERTIAN
        rng, handoff = ("philox", False) if lambertian else ("hash", True)
        rows[f"{model.name}/{rng}/{'handoff' if handoff else 'none'}"] = (
            _refill_against_plain(device, n, model, rng, handoff)[0])
    return rows


def phase_refill_timing(device, sizes=(1 << 20, N_SCALE)):
    """The refill kernel at the simulate engine's main-trace shape
    (production scene without the rim, philox, 4096 cap, budget 4,
    handoff 0.01; n = N_SCALE is the main path's own launch) against its
    plain version once at each n (per-slot agreement, live planes and
    time), at the first size also without the handoff and the other three
    laws against theirs, the kernel without the handoff, the bounce kernel
    at the same n, and the stragglers' finish in the waves tracer.  Each row records the
    bounce steps the kernel ran and the bytes it wrote, for its bound.
    The lane-static kernel this one replaced is not timed here; its times
    are those of the earlier calls recorded in PERF.md."""
    from altair_tpu_torch import SurfaceModel, TraceConfig
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.profile_refill import traced_steps

    scene, sv, srcv, budget, thresh = _refill_main_shape(device)
    law = int(SurfaceModel.LAMBERTIAN)
    out = {"phase": "refill_timing", "budget": budget, "thresh": thresh,
           "max_bounces": MAX_BOUNCES, "rng": "philox"}
    for n in sizes:
        args = ((7, 8), sv, srcv, n, law, MAX_BOUNCES)
        row, res, live = _refill_against_plain(device, n)
        row["traced_steps"] = traced_steps(res, live)
        row["bytes"] = refill_bytes(n, budget, thresh)
        pending = (res.status == 0).view(-1, trace_cuda.REFILL_LANES
                                         * budget).sum(1)
        row["units_with_stragglers"] = float((pending > 0).float().mean())
        check(int(pending.max()) <= thresh,
              f"refill n={n}: a unit left {int(pending.max())} rays > "
              f"{thresh}")
        if n == sizes[0]:
            row["laws"] = _refill_laws_against_plain(device, n)
        row["refill_no_handoff_ms"] = cuda_ms(lambda: trace_cuda.refill(
            *args, budget, 0, rng="philox"))
        row["bounce_ms"] = cuda_ms(lambda: trace_cuda.bounce(
            *args, rng="philox"))
        row["stragglers"] = int((res.status == 0).sum())
        row["continuation_width"] = (n // (trace_cuda.REFILL_LANES * budget)
                                     * thresh)
        cont_s = []
        for i in range(2):          # the first call warms the eager ops
            sync(device)
            t0 = time.perf_counter()
            fin, ovf = trace_cuda._refill_handoff_continue(
                torch.Generator().manual_seed(i), scene, TraceConfig(), res,
                live, srcv, budget, thresh, device)
            int(ovf)
            sync(device)
            cont_s.append(time.perf_counter() - t0)
        row["continuation_s"] = cont_s
        row["continuation_overflow"] = int(ovf)
        check(int(ovf) == 0, f"refill n={n}: continuation overflow {int(ovf)}")
        check(not bool((fin.status == 0).any()),
              f"refill n={n}: slots left RUNNING after the continuation")
        row["mean_bounces"] = float(fin.n_bounces.float().mean())
        out[str(n)] = row
    return out


def _errors(obj):
    """Every ``max_abs_err_cm`` in a phase's nested rows."""
    if isinstance(obj, dict):
        return [v for k, v in obj.items() if k == "max_abs_err_cm"] + [
            e for v in obj.values() for e in _errors(v)]
    return []


def refill_bytes(n, budget, thresh):
    """The bytes the refill kernel must move for n rays: the 11 slot
    planes written (44 bytes a ray), the 8 live planes with the handoff
    (32 bytes a lane), the two 8-float operands read."""
    return 44 * n + (32 * (n // budget) if thresh > 0 else 0) + 64


def kernel_bound(mix, crd, steps, n_bytes, chain_ms=0.0):
    """The least time the card could take for a kernel's work, the
    largest of: its bytes over the memory rate; the arithmetic of its
    ``steps`` bounce steps of the SASS instruction mix ``mix`` on the
    slowest pipe (``profile_refill.ops_bound_ms``: control, moves, uniform
    and warp-vote code left out); and ``chain_ms``, the serial chain of
    its longest ray (dependent operations: bound by operations too).
    ``binds`` names which; ``issue_ms``, every instruction of the step on
    the issue slots, is the kernel's own overhead-inclusive floor, beside
    the bound and not in it."""
    from altair_tpu_torch.profile_refill import (bytes_bound_ms,
                                                 ops_bound_ms, pipe_ms)

    ops_ms, pipe = ops_bound_ms(mix, steps, crd)
    cands = {"bytes": bytes_bound_ms(n_bytes), f"{pipe} pipe": ops_ms,
             "serial chain": chain_ms}
    binds = max(cands, key=cands.get)
    return {"bound_ms": cands[binds],
            "bound_by": "bytes" if binds == "bytes" else "operations",
            "binds": binds, "ops_ms": ops_ms, "bytes_ms": cands["bytes"],
            "chain_ms": chain_ms,
            "issue_ms": pipe_ms(mix, steps, crd)["issue"]}


def phase_simulate_e2e(device, n=N_SCALE, seed=300):
    """The simulate engine end to end at n rays (production scene with
    the exact rim) through the refill kernel with the handoff at
    _REFILL_HANDOFF and at 0, and through the bounce kernel alone
    (REFILL_MIN raised), in turns A B C C B A; host clock to a device
    sync and the exit-count readback, after one warm run each."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  TraceConfig, trace_rays_auto)
    from altair_tpu_torch.core import trace_cuda

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    cfg = TraceConfig(engine="simulate")
    variants = {
        "refill_handoff": (trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF),
        "refill_no_handoff": (trace_cuda.REFILL_MIN, 0.0),
        "bounce": (1 << 62, trace_cuda._REFILL_HANDOFF),
    }
    saved = (trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF)
    times = {k: [] for k in variants}
    fracs = {}
    try:
        order = list(variants) + list(reversed(variants))
        for i, name in enumerate(list(variants) + order):
            trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF = variants[name]
            sync(device)
            t0 = time.perf_counter()
            res, rim = trace_rays_auto(torch.Generator().manual_seed(seed + i),
                                       scene, SOURCE_OVERNIGHT, n, cfg,
                                       device=device)
            n_exit = int(res.exited_port_mask().sum())
            sync(device)
            dt = time.perf_counter() - t0
            check(int(rim) == 0, f"simulate {name}: overflow {int(rim)}")
            if i >= len(variants):      # the first pass warms each variant
                times[name].append(dt)
                fracs[name] = n_exit / n
    finally:
        trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF = saved
    for name, f in fracs.items():
        check(EXIT_WINDOW[0] <= f <= EXIT_WINDOW[1],
              f"simulate {name}: exit fraction {f} outside {EXIT_WINDOW}")
    return {"phase": "simulate_e2e", "n_rays": n, "order": "ABCCBA",
            "times_s": times, "best_s": {k: min(v) for k, v in times.items()},
            "exit_fraction": fracs}


def phase_kernel_timing(device, n=N_HEADLINE, kernel_reps=5, plain_reps=2):
    """The bounce kernel and its plain version at the headline's shape (the
    simulate engine's main trace: production scene without the rim,
    philox, 4096-bounce cap): per-lane agreement and times, the bounce
    steps it ran and the bytes it wrote (for its bound), and its longest
    ray's serial chain: that ray's steps times the per-bounce latency of
    a one-thread launch, which no one-ray-per-thread design can beat."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.profile_refill import (bounce_step_latency_ms,
                                                 traced_steps)

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
    args = ((7, 8), sv, srcv, n, int(SurfaceModel.LAMBERTIAN), MAX_BOUNCES)
    kernel_ms = cuda_ms(lambda: trace_cuda.bounce(*args, rng="philox"),
                        kernel_reps)
    k = trace_cuda.bounce(*args, rng="philox")
    plain_times = []
    for _ in range(plain_reps):
        sync(device)
        t0 = time.perf_counter()
        p = trace_cuda.bounce_plain(*args, rng="philox")
        sync(device)
        plain_times.append((time.perf_counter() - t0) * 1e3)
    agree, err = compare(k, p)
    check(agree >= 0.999, f"philox kernel vs plain: {agree} of lanes agree")
    check(err <= 1e-3, f"philox kernel vs plain: positions differ by {err}")
    latency = bounce_step_latency_ms(device)
    longest = int((k.n_bounces + (k.status == 1).int()).max())
    return {"phase": "kernel_timing", "n": n, "max_bounces": MAX_BOUNCES,
            "rng": "philox", "kernel_ms": kernel_ms,
            "plain_ms": min(plain_times), "agree": agree,
            "max_abs_err_cm": err,
            "mean_bounces": float(k.n_bounces.float().mean()),
            "max_bounces_seen": int(k.n_bounces.max()),
            "traced_steps": traced_steps(k), "bytes": 44 * n + 64,
            "bounce_step_latency_ms": latency,
            "longest_ray_steps": longest, "chain_ms": longest * latency}


def phase_qmc_bits(device, n=1 << 22, dim=7, seed=0):
    """The Sobol generator on the card against the same call on the CPU,
    bit for bit, and both randomisations from the same words; device
    times (CUDA events, mean of 5 after a warm call)."""
    from altair_tpu_torch.core import qmc

    bits = qmc.sobol_bits(n, dim, device)
    check(torch.equal(bits.cpu(), qmc.sobol_bits(n, dim)),
          "qmc: sobol_bits on the card differs from the CPU")
    words = torch.randint(0, 1 << 32, (dim, 1), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(seed))
    out = {"phase": "qmc_bits", "n": n, "dim": dim, "sobol_bits_ms":
           cuda_ms(lambda: qmc.sobol_bits(n, dim, device))}
    for mode in ("shift", "owen"):
        w = words.to(device)
        u = qmc.sobol_uniforms_from_words(w, n, dim, mode=mode)
        same = torch.equal(u.cpu(), qmc.sobol_uniforms_from_words(
            words, n, dim, mode=mode))
        check(same, f"qmc: {mode} uniforms on the card differ from the CPU")
        out[mode] = {"equal": same, "min": float(u.min()),
                     "max": float(u.max()),
                     "ms": cuda_ms(lambda: qmc.sobol_uniforms_from_words(
                         w, n, dim, mode=mode))}
    return out


def phase_retrace_binomial(device, n_per_pos=50_000, oversample=128,
                           repeats=3, seed=500, n_ref=N_SCALE):
    """The bench workload ``retrace_binomial_value`` (``bench.py:211-224``)
    through ``fluxmap_retrace_binomial``: one warm run, then the best of
    ``repeats``, host clock to the map's readback, each timed run
    splitting itself into its stages (``timings``: the shared trace with
    its rim post-pass, the scoring chunks, the draw; a device sync after
    each); the main direct trace (Sobol block, no rim) once on its own,
    so the rim post-pass's share is a difference of two runs; and the
    map's total fraction against a 4M-ray trace-once map's within 4
    sigma.  The call raises on a rim overflow; its compaction overflow
    (``stats``) must be 0."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  DetectorGrid, TraceConfig, trace_rays_auto)
    from altair_tpu_torch.core import score
    from altair_tpu_torch.core.trace_cuda import _slice
    from altair_tpu_torch.core.trace_direct import trace_rays_direct

    grid = DetectorGrid()
    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    M = oversample * n_per_pos
    cap = score.exit_capacity(scene, M)

    def run(i, stats=None):
        return score.fluxmap_retrace_binomial(
            torch.Generator().manual_seed(seed + i), scene, SOURCE_OVERNIGHT,
            grid, n_per_pos, oversample=oversample, device=device,
            stats=stats).cpu()

    run(0)
    times, stages = [], []
    for i in range(1, repeats + 1):
        stages.append({})
        sync(device)
        t0 = time.perf_counter()
        cells = run(i, stages[-1])
        times.append(time.perf_counter() - t0)
    best = min(range(repeats), key=times.__getitem__)
    ovf = [st.pop("compaction_overflow") for st in stages]
    check(not any(ovf), f"binomial: compaction overflow {ovf}")
    check(cells.dtype == torch.int32 and cells.shape == (180, 90),
          f"binomial: map {cells.dtype} {tuple(cells.shape)}")
    check(int(cells.min()) >= 0 and int(cells.max()) <= n_per_pos,
          "binomial: a cell outside [0, n_per_pos]")

    sync(device)
    t0 = time.perf_counter()
    trace_rays_direct(torch.Generator().manual_seed(seed), scene.with_(
        exact_rim=False), SOURCE_OVERNIGHT, M, TraceConfig(qmc=1),
        device=device)
    sync(device)
    main_alone = time.perf_counter() - t0
    split_s = dict(stages[best], main_trace_alone_s=main_alone,
                   rim_post_pass_by_difference_s=(stages[best]["trace_s"]
                                                  - main_alone))

    # the reference: a trace-once map of n_ref rays; per-ray hit variance
    # from its first 200k rays
    ref, rim_ref = trace_rays_auto(torch.Generator().manual_seed(seed + 99),
                                   scene, SOURCE_OVERNIGHT, n_ref,
                                   TraceConfig(), device=device)
    ref_counts, ref_ovf = score.fluxmap_trace_once_compact(
        ref, grid, score.exit_capacity(scene, n_ref), scene.exit_port_z)
    check(int(ref_ovf) == 0 and int(rim_ref) == 0, "reference overflow")
    _, sig200k = _hits_per_ray(_slice(ref, 200_000), grid, scene.exit_port_z)
    var_h = sig200k ** 2 / 200_000
    frac_ref = float(ref_counts.double().sum()) / n_ref
    frac = float(cells.double().sum()) / n_per_pos
    pi = cells.double() / n_per_pos
    sigma = math.sqrt(float((pi * (1 - pi)).sum()) / n_per_pos
                      + var_h / M + var_h / n_ref)
    check(abs(frac - frac_ref) < 4 * sigma,
          f"binomial: total fraction {frac} vs trace-once {frac_ref} "
          f"(sigma {sigma})")
    return {"phase": "retrace_binomial", "n_per_pos": n_per_pos,
            "oversample": oversample, "shared_rays": M, "capacity": cap,
            "pos_chunk": score.binomial_pos_chunk(cap),
            "score_chunks": -(-grid.n_positions
                              // score.binomial_pos_chunk(cap)),
            "grid": [180, 90], "best_s": min(times), "times_s": times,
            "best_run_stages_s": split_s, "stages_s": stages,
            "total_fraction": frac,
            "trace_once_fraction": frac_ref, "sigma": sigma,
            "max_cell": int(cells.max()), "compaction_overflow": ovf}, cells


def phase_replicates(device, K=16, n=N_HEADLINE, seed=700):
    """``fluxmap_replicates``: K trace-once maps of n rays (after a warm
    call of 2), the time per map (the port's ``amortized_per_map_value``)
    and the pooled bright-cell standard error, held to within a factor 2
    of the binomial one."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from altair_tpu_torch.sweep import fluxmap_replicates

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    fluxmap_replicates(scene, SOURCE_OVERNIGHT, device=device, n_rays=n,
                       replicates=2, seed=seed)
    sync(device)
    t0 = time.perf_counter()
    mean, sem = fluxmap_replicates(scene, SOURCE_OVERNIGHT, device=device,
                                   n_rays=n, replicates=K, seed=seed + 1)
    wall = time.perf_counter() - t0
    bright = mean > mean.max() * 0.1
    pooled = float(sem[bright].mean())
    binom = float((mean[bright] * (1 - mean[bright]) / (n * K)).mean() ** 0.5)
    check(mean.shape == (180, 90) and bool((sem >= 0).all()),
          "replicates: map shape or sem")
    check(0.5 * binom < pooled < 2.0 * binom,
          f"replicates: pooled bright-cell sem {pooled} vs binomial {binom}")
    return {"phase": "replicates", "K": K, "n_rays": n, "wall_s": wall,
            "amortized_per_map_value": wall / K,
            "pooled_bright_sem": pooled, "binomial_sem": binom,
            "bright_cells": int(bright.sum()),
            "map_total_fraction": float(mean.sum())}


def phase_retrace_rows(device, binom_cells, save_folder, n_per_pos=50_000,
                       seed=900):
    """``sweep_detector_retrace`` on the first 2 theta rows of the full
    180x90 grid (depth cut from 180 rows), 50,000 rays per position, with
    the direct engine and with ``engine="simulate"`` (1.6M-ray chunks: the
    refill kernel; its launches and their sizes counted from 0 over that
    run, then the kernel held against its plain version at each size),
    both writing the CSV; the simulate sweep then resumes from a one-row
    partial CSV and must redo the second row exactly.  Rows against each other and
    against the binomial map within 5 sigma per cell.  Then one chunk's
    trace (32 positions x 50,000 rays) per engine, split into the main
    trace and the rim post-pass, each stage ended by a device sync."""
    import numpy as np

    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  DetectorGrid, TraceConfig)
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.io import read_fluxmap
    from altair_tpu_torch.sweep import sweep_detector_retrace

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    grid = DetectorGrid(n_theta=2, theta_hi=1.0)     # rows 0-1 of 180x90
    kw = dict(device=device, n_rays_per_pos=n_per_pos, grid=grid,
              verbose=False)
    out = {"phase": "retrace_rows", "rows": 2, "n_per_pos": n_per_pos}
    maps = {}
    for engine in ("auto", "simulate"):
        folder = os.path.join(save_folder, engine)
        trace_cuda.reset_launch_counts()
        r = sweep_detector_retrace(scene, SOURCE_OVERNIGHT, seed=seed,
                                   cfg=TraceConfig(engine=engine),
                                   save_folder=folder, **kw)
        launches = dict(trace_cuda.launch_counts)
        sizes = sorted(trace_cuda.launch_sizes["refill"])
        _, _, frac, _ = read_fluxmap(r.path)
        check(len(frac) == 180, f"retrace {engine}: {len(frac)} CSV rows")
        maps[engine] = r.fluxmap
        out[engine] = {"csv": r.path, "trace_s": r.trace_time_s,
                       "per_row_s": r.trace_time_s / 2,
                       "total_s": r.total_time_s, "launches": launches,
                       "refill_sizes": sizes}
    check(out["simulate"]["launches"]["refill"] > 0,
          "retrace_rows: the simulate engine never launched the refill "
          "kernel")
    # the refill kernel against its plain version at each size this sweep
    # launched it with (after the counts were read)
    vs_plain = out["simulate"]["refill_vs_plain"] = {}
    for n in out["simulate"]["refill_sizes"]:
        vs_plain[str(n)] = _refill_against_plain(device, n)[0]

    # resume the simulate sweep from its own first row
    with open(out["simulate"]["csv"]) as fh:
        lines = fh.read().splitlines()
    head = lines.index("theta,phi,fraction") + 1
    partial = os.path.join(save_folder, "partial.csv")
    with open(partial, "w") as fh:
        fh.write("\n".join(lines[:head + 90]) + "\n")
    t0 = time.perf_counter()
    rr = sweep_detector_retrace(scene, SOURCE_OVERNIGHT, seed=seed,
                                cfg=TraceConfig(engine="simulate"),
                                save_folder=None, resume_path=partial, **kw)
    resume_s = time.perf_counter() - t0
    _, _, frac_r, _ = read_fluxmap(rr.path)
    check(len(frac_r) == 180, f"resumed CSV: {len(frac_r)} rows")
    out["resume"] = {"csv": rr.path, "rows": len(frac_r), "wall_s": resume_s,
                     "redone_row_equals_full_run": bool(
                         np.array_equal(rr.fluxmap[1], maps["simulate"][1]))}
    check(out["resume"]["redone_row_equals_full_run"],
          "resume: the redone row differs from the full run's")

    # per cell: the difference of two independent draws of mean pi, pi
    # pooled from the pair (floored at one hit); the binomial cell's
    # variance is 1 + 1/oversample times the retrace cell's
    binom = binom_cells[:2].double().numpy() / n_per_pos
    worst = {}
    for name, a, b, excess in (
            ("direct_vs_simulate", maps["auto"], maps["simulate"], 0.0),
            ("direct_vs_binomial", maps["auto"], binom, 1 / 128),
            ("simulate_vs_binomial", maps["simulate"], binom, 1 / 128)):
        pi = np.maximum((a + b) / 2, 1.0 / n_per_pos)
        z = np.abs(a - b) / np.sqrt((2 + excess) * pi * (1 - pi) / n_per_pos)
        worst[name] = float(z.max())
        check(z.max() < 5, f"retrace_rows {name}: {z.max()} sigma")
    out["max_sigma"] = worst

    from altair_tpu_torch import trace_rays_auto
    from altair_tpu_torch.core.trace_direct import trace_rays_direct

    n_chunk = 32 * n_per_pos
    simple = scene.with_(exact_rim=False)
    mains = {"auto": trace_rays_direct,
             "simulate": lambda *a, **k: trace_cuda._kernel_padded(*a, **k)[0]}
    for engine, main in mains.items():
        cfg = TraceConfig(engine=engine)
        stages = {}
        for name, fn in (
                ("chunk_trace_s", lambda: trace_rays_auto(
                    torch.Generator().manual_seed(seed + 7), scene,
                    SOURCE_OVERNIGHT, n_chunk, cfg, device=device)),
                ("main_trace_s", lambda: main(
                    torch.Generator().manual_seed(seed + 8), simple,
                    SOURCE_OVERNIGHT, n_chunk, cfg, device=device))):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            stages[name] = time.perf_counter() - t0
        stages["rim_post_pass_s"] = (stages["chunk_trace_s"]
                                     - stages["main_trace_s"])
        out[engine]["one_chunk"] = stages
    return out


def phase_series(device, save_folder, n=N_HEADLINE, seed=1100):
    """``run_series_vmapped`` over the port angles 163-178 of
    ``sweepSeries`` (16 members, n rays each, the full grid, the direct
    engine): on the simple-rim scene each member's exit fraction within 4
    sigma of the closed-form law of its port; on the production scene
    (exact rim) below the law by at most the rim band's share of the
    escapes, and falling with the port angle.  Then 4 members through the simulate engine (the
    bounce kernel's launches counted from 0), and 2 sequential members
    that write their CSVs under the reference's folder names."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  TraceConfig)
    from altair_tpu_torch.config import expected_exit_fraction
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.sweep import (run_series, run_series_vmapped,
                                        series_folder)

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    ports = [float(p) for p in range(163, 179)]
    law = [expected_exit_fraction(p, scene.reflectance) for p in ports]
    out = {"phase": "series", "n_rays": n, "ports": ports, "law": law}
    for name, sc in (("simple_rim", scene.with_(exact_rim=False)),
                     ("exact_rim", scene)):
        sync(device)
        t0 = time.perf_counter()
        counts, exits = run_series_vmapped(sc, SOURCE_OVERNIGHT,
                                           device=device, port_angles=ports,
                                           n_rays=n, seed=seed)
        wall = time.perf_counter() - t0
        frac = (exits / n).tolist()
        check(counts.shape == (16, 180, 90), f"series {name}: map shape")
        for p, f, l in zip(ports, frac, law):
            sigma = math.sqrt(l * (1 - l) / n)
            # the rim clips at most its band's share of the escapes (the
            # rule rim_deferred_capacity_shift plans by)
            band = ((sc.outer_radius - sc.inner_radius) / (
                sc.inner_radius * math.sin(math.radians(180.0 - p)))
                if sc.exact_rim else 0.0)
            lo = l * (1 - min(1.0, band)) - 4 * sigma
            check(lo < f < l + 4 * sigma,
                  f"series {name} port {p}: exit fraction {f} vs law {l}")
        check(all(a > b for a, b in zip(frac, frac[1:])),
              f"series {name}: exit fractions do not fall with the port")
        out[name] = {"wall_s": wall, "per_member_s": wall / 16,
                     "exit_fraction": frac,
                     "map_totals": counts.sum(axis=(1, 2)).tolist()}

    sim_ports = [164.0, 168.0, 172.0, 176.0]
    trace_cuda.reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    counts, exits = run_series_vmapped(scene, SOURCE_OVERNIGHT, device=device,
                                       port_angles=sim_ports, n_rays=n,
                                       seed=seed + 1,
                                       cfg=TraceConfig(engine="simulate"))
    wall = time.perf_counter() - t0
    launches = dict(trace_cuda.launch_counts)
    check(launches["bounce"] >= len(sim_ports),
          f"series simulate: bounce launches {launches}")
    for p, e in zip(sim_ports, exits):
        f_direct = out["exact_rim"]["exit_fraction"][ports.index(p)]
        check(abs(e / n - f_direct)
              < 4 * math.sqrt(2 * f_direct * (1 - f_direct) / n),
              f"series simulate port {p}: {e / n} vs direct {f_direct}")
    out["simulate"] = {"ports": sim_ports, "wall_s": wall,
                       "exit_fraction": (exits / n).tolist(),
                       "launches": launches,
                       "bounce_sizes": sorted(
                           trace_cuda.launch_sizes["bounce"])}

    root = os.path.join(save_folder, "series")
    res = run_series(scene, SOURCE_OVERNIGHT, device=device,
                     port_angles=[164.0, 170.0], repeats=1, n_rays=n,
                     save_root=root, seed=seed + 2, verbose=False)
    want = [os.path.join(root, series_folder("portAngleSweep",
                                             SOURCE_OVERNIGHT, p))
            for p in (164, 170)]
    check([os.path.dirname(r.path) for r in res] == want,
          f"series: folders {[r.path for r in res]}")
    check(all(os.path.getsize(r.path) > 100_000 for r in res),
          "series: a CSV is short")
    out["sequential"] = {"csv": [r.path for r in res],
                         "total_s": [r.total_time_s for r in res]}
    return out


def _sigma_apart(a, b, n_a, n_b):
    """Per position, the distance of two hit fractions in standard
    deviations of their difference (pooled, floored at one hit)."""
    import numpy as np

    pi = np.maximum((a * n_a + b * n_b) / (n_a + n_b), 1.0 / max(n_a, n_b))
    return np.abs(a - b) / np.sqrt(pi * (1 - pi) * (1 / n_a + 1 / n_b))


def phase_insphere(device, n=N_HEADLINE, seed=1200):
    """``sweep_insphere_detector`` as the macro runs it: the corpus scene
    (outer radius 105 cm, a thick rim: the in-loop exact-rim tracers), the
    macro's source, n rays, dtheta 0.5 over +-45 degrees x phi {0, 180} =
    362 positions, traced once; the phi-averaged profile peaks within 6
    degrees of the axis, as the corpus does.  Then the reference's
    methodology at a cut depth: fresh rays for 16 positions, within 5
    sigma per position of the trace-once fractions.  Then a thin-shell
    scene through the simulate engine, 16 positions in one chunk of 16 x n
    rays: at n = 100,000 that is the refill kernel's size, its launches
    counted from 0."""
    import numpy as np

    from altair_tpu_torch import (SCENE_INSPHERE, SCENE_OPTIMIZE, SOURCE_DEMO,
                                  TraceConfig)
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.sweep import (read_detector_sweep,
                                        sweep_insphere_detector)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "detector_sweep3.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    once = sweep_insphere_detector(SCENE_INSPHERE, SOURCE_DEMO, device=device,
                                   n_rays=n, seed=seed, save_path=path)
    th, ph, fr = read_detector_sweep(path)
    check(len(fr) == 362 and set(ph) == {0.0, 180.0},
          f"insphere: {len(fr)} rows")
    check(np.allclose(fr, once.fractions, rtol=1e-5, atol=1e-9),
          "insphere: the file's fractions differ from the result's")
    thetas = np.unique(once.thetas)
    prof = np.array([once.fractions[once.thetas == t].mean() for t in thetas])
    smooth = np.convolve(prof, np.ones(9) / 9, mode="same")
    peak = float(thetas[smooth.argmax()])
    check(abs(peak) <= 6.0, f"insphere: profile peaks at theta {peak}")
    check(prof.max() > 4 * max(prof[0], prof[-1], 1.0 / n),
          "insphere: the profile does not fall off towards +-45 degrees")
    out = {"phase": "insphere", "n_rays": n, "positions": len(fr),
           "trace_once_s": once.wall_time_s, "peak_theta": peak,
           "peak_fraction": float(prof.max()),
           "total_fraction": float(once.fractions.sum()), "file": path}

    re = sweep_insphere_detector(SCENE_INSPHERE, SOURCE_DEMO, device=device,
                                 n_rays=n, dtheta=1.0, theta_max=3.5,
                                 seed=seed + 1, retrace=True, save_path=None)
    check(len(re.fractions) == 16, f"insphere retrace: {len(re.fractions)}")
    ref = np.array([once.fractions[(once.thetas == t) & (once.phis == p)][0]
                    for t, p in zip(re.thetas, re.phis)])
    z = _sigma_apart(re.fractions, ref, n, n)
    check(z.max() < 5, f"insphere retrace: {z.max()} sigma from trace-once")
    out["retrace"] = {"positions": 16, "wall_s": re.wall_time_s,
                      "per_position_s": re.wall_time_s / 16,
                      "max_sigma": float(z.max()),
                      "fractions": re.fractions.tolist()}

    thin = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    kw = dict(device=device, n_rays=n, dtheta=1.0, theta_max=3.5,
              save_path=None)
    direct = sweep_insphere_detector(thin, SOURCE_DEMO, seed=seed + 2, **kw)
    trace_cuda.reset_launch_counts()
    sim = sweep_insphere_detector(thin, SOURCE_DEMO, seed=seed + 3,
                                  retrace=True, pos_chunk=16,
                                  cfg=TraceConfig(engine="simulate"), **kw)
    launches = dict(trace_cuda.launch_counts)
    sizes = sorted(trace_cuda.launch_sizes["refill"])
    if 16 * n >= trace_cuda.REFILL_MIN:
        check(launches["refill"] > 0,
              f"insphere simulate chunk: launches {launches}")
    z = _sigma_apart(sim.fractions, direct.fractions, n, n)
    check(z.max() < 5, f"insphere simulate chunk: {z.max()} sigma")
    out["simulate_chunk"] = {"rays": 16 * n, "wall_s": sim.wall_time_s,
                             "launches": launches, "refill_sizes": sizes,
                             "max_sigma": float(z.max()),
                             "direct_trace_once_s": direct.wall_time_s}
    return out


def phase_scatter_retrace(device, n=N_HEADLINE, seed=1300):
    """``sweep_scatter_retrace`` as the CLI runs it: the production scene
    with the BRDF 0.4 / 0.6 / 0.3, n rays, the 45x20 grid with the 10 cm
    detector.  Every scattered ray ends EXITED, ABSORBED or SUSPENDED; the
    map total of two seeds within 4 sigma.  Then a MIXED_BRDF wall, so
    that stage 1 is the simulate engine: the bounce kernel's launches are
    counted from 0, and the kernel is held against its plain version on
    that law at that size."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  DetectorGrid, SurfaceModel)
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.core.score import fluxmap_trace_once
    from altair_tpu_torch.sweep import (sweep_scatter_retrace,
                                        trace_scatter_retrace)

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, specular_prob=0.4,
                                 diffuse_prob=0.6, brdf_roughness=0.3)
    grid = DetectorGrid(n_theta=45, n_phi=20, width=10.0, height=10.0)
    out = {"phase": "scatter_retrace", "n_rays": n, "grid": [45, 20]}
    totals, walls = [], []
    for i in range(2):
        sw = sweep_scatter_retrace(scene, SOURCE_OVERNIGHT, device=device,
                                   n_rays=n, seed=seed + i)
        check(sw.fluxmap.shape == (45, 20), "scatter_retrace: map shape")
        totals.append(float(sw.fluxmap.sum()) * n)
        walls.append(sw.wall_time_s)
    sync(device)
    t0 = time.perf_counter()
    res, ovf = trace_scatter_retrace(torch.Generator().manual_seed(seed),
                                     scene, SOURCE_OVERNIGHT, n, device=device)
    status = torch.bincount(res.status, minlength=4).tolist()
    trace_s = time.perf_counter() - t0
    check(int(ovf) == 0, f"scatter_retrace: overflow {int(ovf)}")
    check(status[0] == 0 and sum(status[1:4]) == n,
          f"scatter_retrace: statuses {status}")
    counts = fluxmap_trace_once(res, grid, scene.exit_port_z)
    h_total, sigma = _hits_per_ray(res, grid, scene.exit_port_z)
    check(abs(int(counts.sum()) - totals[0]) < 0.5,
          "scatter_retrace: the sweep's map is not its trace's map")
    check(abs(h_total - totals[0]) <= 1e-4 * totals[0] + 10,
          f"scatter_retrace: scorer total {totals[0]} vs direct {h_total}")
    check(abs(totals[0] - totals[1]) < 4 * math.sqrt(2) * sigma,
          f"scatter_retrace: map totals {totals} (sigma {sigma})")
    out.update(wall_s=walls, trace_s=trace_s, map_totals=totals,
               map_total_sigma=sigma,
               status_counts={"exited": status[1], "absorbed": status[2],
                              "suspended": status[3]})

    mixed = scene.with_(surface_model=SurfaceModel.MIXED_BRDF)
    trace_cuda.reset_launch_counts()
    sw = sweep_scatter_retrace(mixed, SOURCE_OVERNIGHT, device=device,
                               n_rays=n, seed=seed + 2)
    launches = dict(trace_cuda.launch_counts)
    check(launches["bounce"] > 0,
          f"scatter_retrace mixed: stage 1 launched {launches}")
    check(n in trace_cuda.launch_sizes["bounce"],
          "scatter_retrace mixed: the bounce kernel's size")
    sv, srcv = trace_cuda.kernel_operands(mixed.with_(exact_rim=False),
                                          SOURCE_OVERNIGHT, device)
    args = ((9, 10), sv, srcv, n, int(SurfaceModel.MIXED_BRDF), MAX_BOUNCES)
    k = trace_cuda.bounce(*args, rng="philox")
    sync(device)
    agree, err = compare(k, trace_cuda.bounce_plain(*args, rng="philox"))
    check(agree >= 0.999 and err <= 1e-3,
          f"bounce kernel vs plain, MIXED_BRDF at {n}: {agree}, {err} cm")
    out["mixed_wall"] = {"wall_s": sw.wall_time_s, "launches": launches,
                         "map_total": float(sw.fluxmap.sum()) * n,
                         "kernel_vs_plain": {"agree": agree,
                                             "max_abs_err_cm": err}}
    return out


def phase_history(device, out_dir, n=100, K=256, seed=1400):
    """``viz.trace_paths``: n rays with ``keep_history = K`` on the card.
    Slot 0 is the source; a ray with room left in its buffer ends on its
    last point (held against the same trace's ``last_point``: an exit's
    on the world box, any other within the shell); every point between
    lies on the inner sphere within 1e-3 cm or on the rim band; the census
    sums to n; ``export_html`` writes the viewer; ``io.device_trace``
    writes the chrome trace of the loop's first 64 steps and gives their
    device busy share."""
    import numpy as np

    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  TraceConfig, trace_rays)
    from altair_tpu_torch.viz import export_html, trace_paths

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    sync(device)
    t0 = time.perf_counter()
    paths = trace_paths(scene, SOURCE_OVERNIGHT, device=device, n_rays=n,
                        seed=seed, keep_history=K)
    wall = time.perf_counter() - t0
    pts, lens = paths.points, paths.lengths
    check(pts.shape == (K, n, 3) and lens.shape == (n,), "history: shapes")
    src = np.float32([SOURCE_OVERNIGHT.x, SOURCE_OVERNIGHT.y,
                      SOURCE_OVERNIGHT.z])
    check(bool((pts[0] == src).all()), "history: slot 0 is not the source")
    check(int(lens.min()) >= 2 and int(lens.max()) <= K, "history: lengths")
    room = lens < K
    last = pts[lens - 1, np.arange(n)]
    exits = np.isin(paths.classes, ("hit", "exit"))
    check(bool(room.any()), "history: every buffer is full")
    # the same key gives the same trace: its last points and its buffer
    res = trace_rays(torch.Generator().manual_seed(seed), scene,
                     SOURCE_OVERNIGHT, n, TraceConfig(keep_history=K),
                     device=device)
    check(np.array_equal(res.history.cpu().numpy(), pts)
          and np.array_equal(res.history_len.cpu().numpy(), lens),
          "history: trace_paths does not carry trace_rays' buffer")
    check(np.array_equal(last[room],
                         res.last_point.stack().cpu().numpy()[room]),
          "history: a ray's last recorded point is not its last point")
    # an exit's last point is on the world box, anything else ends on the
    # wall or the rim
    r_last = np.linalg.norm(last, axis=1)
    box = np.abs(last).max(axis=1)
    check(bool(np.all(np.abs(box[room & exits] - scene.world_half) < 1e-2)),
          "history: an exit's last point is not on the world box")
    check(bool(np.all(r_last[room & ~exits] < scene.outer_radius + 1e-3)),
          "history: a stopped ray's last point is outside the shell")
    slot = np.arange(K)[:, None]
    interior = (slot >= 1) & (slot < (lens - 1)[None, :])
    r = np.linalg.norm(pts, axis=2)[interior]
    on_wall = np.abs(r - scene.inner_radius) < 1e-3
    on_rim = (r > scene.inner_radius - 1e-3) & (r < scene.outer_radius + 1e-3)
    check(bool((on_wall | on_rim).all()),
          "history: a path point off the wall and the rim")
    check(sum(paths.census.values()) == n, f"history: census {paths.census}")
    os.makedirs(out_dir, exist_ok=True)
    html = export_html(paths, scene, os.path.join(out_dir, "rays.html"))
    check(os.path.getsize(html) > 10_000, "history: the HTML view is short")

    # the first 64 steps of the same trace once more (warm) under
    # io.profiling's device trace: the chrome trace is written and the
    # card's busy share of this eager loop read from it (the profiler's
    # own time to write and parse its events grows with the steps traced)
    from altair_tpu_torch.io import annotate, device_busy_s, device_trace

    with device_trace(os.path.join(out_dir, "trace")) as log_dir:
        sync(device)
        t0 = time.perf_counter()
        with annotate("history_trace"):
            trace_paths(scene.with_(max_bounces=64), SOURCE_OVERNIGHT,
                        device=device, n_rays=n, seed=seed, keep_history=K)
            sync(device)
        warm_wall = time.perf_counter() - t0
    busy = device_busy_s(device_trace.last)
    check(os.path.getsize(os.path.join(log_dir, "trace.json")) > 10_000,
          "history: the device trace is short")
    check(busy is not None and 0 < busy < warm_wall,
          f"history: the profiler saw {busy} s of device activity")
    return {"phase": "history", "n_rays": n, "keep_history": K,
            "history_bytes": int(pts.nbytes), "wall_s": wall,
            "profiled_steps": 64, "warm_wall_s": warm_wall,
            "device_busy_s": busy,
            "device_busy_share": busy / warm_wall,
            "census": paths.census, "full_buffers": int((~room).sum()),
            "mean_length": float(lens.mean()),
            "points_on_wall": float(on_wall.mean()), "html": html,
            "html_bytes": os.path.getsize(html)}


def phase_cli(device, out_dir):
    """The CLI as a user runs it: ``python -m altair_tpu_torch.cli fluxmap
    --method retrace --retrace-engine binomial --rays 5000 --oversample
    16`` on the card, in its own process; it must exit 0 and write the
    full map's CSV.  Then ``series --vmapped``, ``insphere``,
    ``scatter-retrace`` and ``visualize`` (HTML) at small sizes, one
    process each, started together; each must exit 0 and write its
    file."""
    import shutil

    from altair_tpu_torch.io import read_fluxmap

    shutil.rmtree(out_dir, ignore_errors=True)
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "altair_tpu_torch.cli", "fluxmap",
           "--method", "retrace", "--retrace-engine", "binomial",
           "--rays", "5000", "--oversample", "16",
           "--device", str(device), "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0,
          f"cli exited {p.returncode}: {p.stderr[-2000:]}")
    csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    check(len(csvs) == 1, f"cli wrote {csvs}")
    _, _, frac, meta = read_fluxmap(os.path.join(out_dir, csvs[0]))
    check(len(frac) == 16_200, f"cli CSV rows {len(frac)}")
    out = {"phase": "cli", "cmd": " ".join(cmd[1:]), "wall_s": wall,
           "csv": csvs[0], "rows": len(frac),
           "total_hits": meta.get("Total ray hits"),
           "stdout_tail": p.stdout.strip().splitlines()[-1:]}

    others = {
        "series": (["series", "--vmapped", "--rays", "20000",
                    "--port-angles", "164", "170", "--out", out_dir],
                   "series_fluxmaps.npy"),
        "insphere": (["insphere", "--rays", "20000", "--dtheta", "5",
                      "--out-file", os.path.join(out_dir, "sweep.txt")],
                     "sweep.txt"),
        "scatter-retrace": (["scatter-retrace", "--rays", "20000",
                             "--out-file",
                             os.path.join(out_dir, "fluxmap_data.csv")],
                            "fluxmap_data.csv"),
        "visualize": (["visualize", "--rays", "50", "--out-file",
                       os.path.join(out_dir, "rays.html")], "rays.html"),
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "altair_tpu_torch.cli"] + args
        + ["--device", str(device), "--max-bounces", str(MAX_BOUNCES)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (args, _) in others.items()}
    done = {}
    try:
        for name, proc in procs.items():
            done[name] = proc.communicate(timeout=300) + (proc.returncode,)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["others_wall_s"] = time.perf_counter() - t0
    for name, (stdout, stderr, rc) in done.items():
        check(rc == 0, f"cli {name} exited {rc}: {stderr[-2000:]}")
        path = os.path.join(out_dir, others[name][1])
        check(os.path.exists(path) and os.path.getsize(path) > 0,
              f"cli {name} wrote no {path}")
        out[name] = {"file": others[name][1],
                     "bytes": os.path.getsize(path),
                     "stdout_tail": stdout.strip().splitlines()[-1:]}
    return out


def phase_mesh(device, n=N_HEADLINE, n_scale=N_SCALE, n_routes=20_000,
               seed=1500, backend="nccl"):
    """The multi-device layer at world size 1 on NCCL, in this process.

    ``sharded_fluxmap`` on the headline job (production scene, n rays, the
    full grid), direct and simulate: the exit fraction inside the window
    and the map equal, cell for cell, to the single-device
    ``trace_rays_auto`` + ``fluxmap_trace_once_compact`` run from
    ``fold_in(key, 0)`` (a route that raised would have found an
    overflow).  Each side runs warm, then timed, in turns.  Then
    ``sharded_trace`` at ``n_scale`` rays through the simulate engine (the
    refill kernel), its exit count equal to the single-device run's.  Then
    every route of ``parallel.demo`` at ``n_routes`` rays, each held
    exactly against ``demo.reference`` (the single-device functions) and
    the flux map within 5 sigma per cell of a run from another seed.  The
    kernel counts are set to 0 before each mesh run and read after it."""
    import torch.distributed as dist

    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  DetectorGrid, TraceConfig, trace_rays_auto)
    from altair_tpu_torch.core import trace_cuda
    from altair_tpu_torch.core.score import (exit_capacity,
                                             fluxmap_trace_once_compact)
    from altair_tpu_torch.core.trace import fold_in
    from altair_tpu_torch.parallel import (demo, init_distributed, make_mesh,
                                           sharded_fluxmap, sharded_trace)

    init_distributed(backend=backend, rank=0, world_size=1,
                     store=dist.HashStore())
    try:
        mesh = make_mesh(device)
        check(mesh.backend == backend and mesh.world_size == 1
              and mesh.device == device, f"mesh {mesh}")
        scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
        grid = DetectorGrid()
        out = {"phase": "mesh", "backend": mesh.backend,
               "world_size": mesh.world_size, "n_rays": n}

        def key():
            return torch.Generator().manual_seed(seed)

        def timed(fn):
            sync(device)
            t0 = time.perf_counter()
            got = fn()
            sync(device)
            return got, time.perf_counter() - t0

        for engine in ("auto", "simulate"):
            cfg = TraceConfig(engine=engine)

            def sharded():
                return sharded_fluxmap(mesh, key(), scene, SOURCE_OVERNIGHT,
                                       grid, n, cfg)

            def single():
                res, rim = trace_rays_auto(fold_in(key(), 0), scene,
                                           SOURCE_OVERNIGHT, n, cfg,
                                           device=device)
                counts, ovf = fluxmap_trace_once_compact(
                    res, grid, exit_capacity(scene, n), scene.exit_port_z)
                return (counts, res.exited_port_mask(scene.exit_port_z).sum(),
                        ovf + rim.total)

            trace_cuda.reset_launch_counts()
            sharded()
            (counts, n_exit), mesh_s = timed(sharded)
            launches = dict(trace_cuda.launch_counts)
            sizes = sorted(trace_cuda.launch_sizes["bounce"])
            single()
            (ref, ref_exit, ref_ovf), single_s = timed(single)
            frac = int(n_exit) / n
            check(int(ref_ovf) == 0, f"mesh {engine}: single-device overflow")
            check(EXIT_WINDOW[0] <= frac <= EXIT_WINDOW[1],
                  f"mesh {engine}: exit fraction {frac}")
            check(counts.dtype == torch.int32
                  and counts.shape == (grid.n_theta, grid.n_phi),
                  f"mesh {engine}: map {counts.dtype} {counts.shape}")
            check(torch.equal(counts, ref) and int(n_exit) == int(ref_exit),
                  f"mesh {engine}: the sharded map differs from the "
                  f"single-device run in {int((counts != ref).sum())} cells")
            out[f"fluxmap_{engine}"] = {
                "exit_fraction": frac, "map_total": int(counts.sum()),
                "cells_equal": True, "mesh_s": mesh_s, "single_s": single_s,
                "launches": launches, "bounce_sizes": sizes}
        check(out["fluxmap_simulate"]["launches"]["bounce"] >= 2
              and n in out["fluxmap_simulate"]["bounce_sizes"],
              "mesh: sharded_fluxmap never launched the bounce kernel")

        cfg = TraceConfig(engine="simulate")
        trace_cuda.reset_launch_counts()
        res, mesh_s = timed(lambda: sharded_trace(
            mesh, key(), scene, SOURCE_OVERNIGHT, n_scale, cfg))
        launches = dict(trace_cuda.launch_counts)
        sizes = sorted(trace_cuda.launch_sizes["refill"])
        exits = int(res.exited_port_mask(scene.exit_port_z).sum())
        del res
        (ref, rim), single_s = timed(lambda: trace_rays_auto(
            fold_in(key(), 0), scene, SOURCE_OVERNIGHT, n_scale, cfg,
            device=device))
        ref_exits = int(ref.exited_port_mask(scene.exit_port_z).sum())
        del ref
        check(int(rim) == 0, f"mesh trace: single-device overflow {int(rim)}")
        check(launches["refill"] >= 1 and n_scale in sizes,
              f"mesh: sharded_trace never launched the refill kernel: "
              f"{launches} {sizes}")
        check(exits == ref_exits,
              f"mesh trace: {exits} exits vs single-device {ref_exits}")
        check(EXIT_WINDOW[0] <= exits / n_scale <= EXIT_WINDOW[1],
              f"mesh trace: exit fraction {exits / n_scale}")
        out["trace_simulate"] = {
            "n_rays": n_scale, "exits": exits, "exits_equal": True,
            "mesh_s": mesh_s, "single_s": single_s, "launches": launches,
            "refill_sizes": sizes}

        walls = {}
        trace_cuda.reset_launch_counts()
        got = demo.run_routes(
            mesh, n_routes,
            lambda route, s, _: walls.__setitem__(route, round(s, 4)))
        launches = dict(trace_cuda.launch_counts)
        ref, ref_s = timed(lambda: demo.reference(1, n_routes, device))
        for name, want in ref.items():
            if name.endswith("_local_exits"):
                want = want[0]
            check(got[name].shape == want.shape
                  and got[name].dtype == want.dtype
                  and (got[name] == want).all(),
                  f"mesh route output {name} differs from the single-device "
                  "functions")
        other, _ = sharded_fluxmap(
            mesh, torch.Generator().manual_seed(seed + 1), demo.SCENE,
            demo.SOURCE, demo.GRID, n_routes, demo.CFG)
        a, b = got["fluxmap_counts"], other.cpu().numpy()
        check((abs(a - b) <= 5 * (a.clip(1) ** 0.5) * 2 ** 0.5 + 10).all(),
              "mesh: two seeds' flux maps differ by more than 5 sigma")
        out["routes"] = {"n_rays": n_routes, "wall_s": walls,
                         "all_s": sum(walls.values()),
                         "reference_all_s": ref_s, "outputs": len(ref),
                         "all_equal": True, "launches": launches}
        return out, walls
    finally:
        dist.destroy_process_group()


def phase_mesh_two_ranks(device, out_dir, one_rank_walls, n_routes=20_000):
    """``python -m altair_tpu_torch.parallel.demo --launch 2 --device cuda``
    in its own processes: two ranks over gloo, both tracing on this card
    (NCCL refuses two ranks on one card).  Every route's reduced output,
    as rank 0 holds it, equals ``demo.reference(2, ...)`` computed here
    from the single-device functions (``fold_in(key, 0)`` and ``fold_in(
    key, 1)`` at half the rays, summed); rank 1 holds the same, the
    binomial cells and every sweep's numbers included; the ranks' own exit
    counts differ.  A nonzero return code or a timeout fails the run."""
    import shutil

    import numpy as np

    from altair_tpu_torch.parallel import demo

    shutil.rmtree(out_dir, ignore_errors=True)
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "altair_tpu_torch.parallel.demo",
           "--launch", "2", "--device", "cuda", "--rays", str(n_routes),
           "--out", out_dir, "--timeout", "120"]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=420)
    wall = time.perf_counter() - t0
    check(p.returncode == 0,
          f"two ranks exited {p.returncode}: {p.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in p.stdout.splitlines()
             if ln.startswith('{"route"')]
    check(len(lines) == len(demo.SEEDS)
          and all(ln["world_size"] == 2 and ln["backend"] == "gloo"
                  and ln["device"] == "cuda:0" for ln in lines),
          f"two ranks: route lines {[ln['route'] for ln in lines]}")
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz"),
                     allow_pickle=True) for r in (0, 1)]
    ref = demo.reference(2, n_routes, device)
    for name, want in ref.items():
        if name.endswith("_local_exits"):
            got = np.stack([r[name] for r in ranks])
            check((got == want).all() and got[0] != got[1],
                  f"two ranks: {name} {got.tolist()} vs {want.tolist()}")
            continue
        check(ranks[0][name].shape == want.shape
              and (ranks[0][name] == want).all(),
              f"two ranks: {name} differs from the sum of the two "
              "single-process calls")
    for name in ranks[0].files:
        a, b = ranks[0][name], ranks[1][name]
        same = (a == b).all() if a.dtype != object else a.item() == b.item()
        check(name.endswith("_local_exits") or (a.shape == b.shape and same),
              f"two ranks: the ranks disagree on {name}")
    csvs = [str(ranks[0][k]) for k in ranks[0].files if k.endswith("_path")]
    check(len(csvs) == 5 and all(os.path.getsize(c) > 0 for c in csvs),
          f"two ranks: sweep files {csvs}")
    walls = {ln["route"]: ln["wall_s"] for ln in lines}
    return {"phase": "mesh_two_ranks", "cmd": " ".join(cmd[1:]),
            "wall_s": wall, "n_rays": n_routes, "outputs": len(ref),
            "sweep_outputs": sum(k.startswith("sweep_")
                                 for k in ranks[0].files),
            "all_equal": True,
            "local_exits": {k: v.tolist() for k, v in ref.items()
                            if k.endswith("_local_exits")},
            "route_wall_s": walls, "routes_all_s": sum(walls.values()),
            "one_rank_nccl_wall_s": one_rank_walls,
            "one_rank_all_s": sum(one_rank_walls.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # the scorer needs full float32 matmuls; state both switches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from altair_tpu_torch import profile_refill
    from altair_tpu_torch.core import _build, trace_cuda

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build(*trace_cuda.KERNELS)       # one nvcc per kernel, at once
    build_s = time.perf_counter() - t0
    ptxas, mix = {}, {}
    for name in trace_cuda.KERNELS:
        _build.load(name)
        with open(_build.library_path(name).with_suffix(".log")) as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln]
        # the Lambertian, philox instantiation: the main path's
        mix[name] = profile_refill.sass_step_mix(
            _build.library_path(name), f"{name}_kernelILi0ELb0E")
    crd = profile_refill.card()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "card": crd, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas,
          "refill_lanes": _build.load("refill").altair_refill_lanes(),
          "sass_step_mix": mix})

    emit(phase_kernel_vs_plain(device))
    refill_hash = phase_refill_vs_plain(device)
    emit(refill_hash)

    direct = phase_headline(device, "auto", seed=args.seed)
    emit(direct)
    save = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    emit(phase_sweep(device, save))

    # the main path through the kernel: counts from this run only
    trace_cuda.reset_launch_counts()
    sim = phase_headline(device, "simulate", seed=args.seed + 1000)
    launches = trace_cuda.launch_counts["bounce"]
    sim["bounce_launches"] = launches
    sim["bounce_sizes"] = sorted(trace_cuda.launch_sizes["bounce"])
    emit(sim)
    check(launches > 0, "the simulate engine never launched the kernel")
    check(N_HEADLINE in sim["bounce_sizes"],
          "the bounce kernel's timed size is not one the main path launched")
    sigma = math.hypot(direct["map_total_sigma"], sim["map_total_sigma"])
    check(abs(direct["map_total"] - sim["map_total"]) < 4 * sigma,
          f"map totals {direct['map_total']} vs {sim['map_total']} "
          f"(sigma {sigma})")

    # this slice's main path (the refill kernel at 4M rays): the counts
    # are set to 0 and read inside the phase
    scale = phase_scale(device)
    emit(scale)
    timing = phase_kernel_timing(device)
    emit(timing)
    refill_timing = phase_refill_timing(device)
    emit(refill_timing)
    emit(phase_simulate_e2e(device))

    # the retrace flux-map path: Sobol draws, the binomial map at bench
    # size, replicates, retrace rows (the simulate engine's run counts its
    # refill launches from 0 inside the phase) and the CLI
    emit(phase_qmc_bits(device, seed=args.seed))
    binom, binom_cells = phase_retrace_binomial(device)
    emit(binom)
    emit(phase_replicates(device))
    rows_out = phase_retrace_rows(device, binom_cells,
                                  os.path.join(save, "retrace_rows"))
    emit(rows_out)

    # the single-card studies; each phase that runs a kernel path sets the
    # counts to 0 just before it and reads them just after
    series = phase_series(device, save)
    emit(series)
    insphere = phase_insphere(device)
    emit(insphere)
    scatter = phase_scatter_retrace(device)
    emit(scatter)
    emit(phase_history(device, os.path.join(save, "history")))
    emit(phase_cli(device, os.path.join(save, "cli")))

    # the multi-device layer: world size 1 on NCCL in this process (the
    # counts set to 0 before each of its runs), then two ranks on this card
    mesh_out, mesh_walls = phase_mesh(device)
    emit(mesh_out)
    emit(phase_mesh_two_ranks(device, os.path.join(save, "mesh_two_ranks"),
                              mesh_walls))
    path_launches = {
        "bounce": {"headline_simulate": launches,
                   "mesh_fluxmap_simulate":
                       mesh_out["fluxmap_simulate"]["launches"]["bounce"],
                   "series_simulate": series["simulate"]["launches"]["bounce"],
                   "scatter_retrace_mixed":
                       scatter["mixed_wall"]["launches"]["bounce"]},
        "refill": {"scale_simulate": scale["simulate"]["launches"]["refill"],
                   "retrace_rows_simulate":
                       rows_out["simulate"]["launches"]["refill"],
                   "insphere_simulate_chunk":
                       insphere["simulate_chunk"]["launches"]["refill"],
                   "mesh_trace_simulate":
                       mesh_out["trace_simulate"]["launches"]["refill"]},
    }
    for name, by_path in path_launches.items():
        for path, count in by_path.items():
            check(count > 0, f"{path} never launched the {name} kernel")

    # the refill row's times are at the main path's shape (N_SCALE rays);
    # each bound from this run's steps and bytes at that shape
    r_main = refill_timing[str(N_SCALE)]
    refill_err = max(_errors(refill_hash) + _errors(refill_timing)
                     + _errors(rows_out["simulate"]["refill_vs_plain"]))
    bounce_err = max([timing["max_abs_err_cm"]] + _errors(scatter))
    bounds = {
        "bounce": kernel_bound(mix["bounce"], crd, timing["traced_steps"],
                               timing["bytes"], timing["chain_ms"]),
        "refill": kernel_bound(mix["refill"], crd, r_main["traced_steps"],
                               r_main["bytes"]),
    }
    emit({"phase": "bounds", "card": crd, **bounds,
          "share": {"bounce": bounds["bounce"]["bound_ms"]
                    / timing["kernel_ms"],
                    "refill": bounds["refill"]["bound_ms"]
                    / r_main["refill_ms"]}})
    rows = {
        "bounce": (sum(path_launches["bounce"].values()), bounce_err,
                   timing["kernel_ms"], timing["plain_ms"]),
        "refill": (sum(path_launches["refill"].values()), refill_err,
                   r_main["refill_ms"], r_main["plain_ms"]),
    }
    emit({"phase": "launches_by_path", **path_launches})
    print(smi)
    # launches: the sum over the main paths' runs, each counted from 0;
    # no single PyTorch call computes either kernel's function, so
    # library_ms is null
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": trace_cuda.KERNELS[name][0],
         "replaces": trace_cuda.KERNELS[name][1], "launches": n_launch,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"], "library_ms": None}
        for name, (n_launch, err, ms, plain_ms) in rows.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
