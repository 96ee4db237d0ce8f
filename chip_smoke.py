#!/usr/bin/env python
"""Smoke run of altair_tpu_torch on one NVIDIA GPU (the Hopper port of the
trace-once flux-map path).

    python3 chip_smoke.py

Builds the CUDA bounce kernel from altair_tpu_torch/csrc, holds it against
its plain PyTorch version, drives the headline job (production scene,
SOURCE_OVERNIGHT, 100,000 rays, the full 180x90 detector grid) through
``trace_rays_auto`` + ``fluxmap_trace_once_compact`` with both engines and
through ``sweep_detector_trace_once``, and traces 4,194,304 rays through
both engines.  Each phase prints one JSON line; any failed check raises,
so the exit code is not 0.  The last three lines are the card's name and
power limit from nvidia-smi, the kernel table as JSON, and the ok line.
Exits non-zero without a CUDA device.  Imports no JAX.
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


def emit(obj) -> None:
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
    timed run each)."""
    from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                  TraceConfig, trace_rays_auto)

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    out = {"phase": "scale", "n_rays": n}
    for engine in ("auto", "simulate"):
        cfg = TraceConfig(engine=engine)
        for i in range(2):
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
        out[engine] = {"s": dt, "rays_per_s": n / dt, "exit_fraction": frac}
    fa, fs = out["auto"]["exit_fraction"], out["simulate"]["exit_fraction"]
    check(abs(fa - fs) < 4 * math.sqrt(2 * fa * (1 - fa) / n),
          f"scale: engines disagree, {fa} vs {fs}")
    return out


def phase_kernel_timing(device, n=N_HEADLINE, kernel_reps=5, plain_reps=2):
    """The kernel and its plain version at the main path's shape (the
    simulate engine's main trace: production scene without the rim,
    philox, 4096-bounce cap): per-lane agreement and times."""
    from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from altair_tpu_torch.core import trace_cuda

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
    args = ((7, 8), sv, srcv, n, int(SurfaceModel.LAMBERTIAN), MAX_BOUNCES)
    k = trace_cuda.bounce(*args, rng="philox")          # warm
    sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(kernel_reps):
            k = trace_cuda.bounce(*args, rng="philox")
        stop.record()
        torch.cuda.synchronize(device)
        kernel_ms = start.elapsed_time(stop) / kernel_reps
    else:
        kernel_ms = None
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
    return {"phase": "kernel_timing", "n": n, "max_bounces": MAX_BOUNCES,
            "rng": "philox", "kernel_ms": kernel_ms,
            "plain_ms": min(plain_times), "agree": agree,
            "max_abs_err_cm": err,
            "mean_bounces": float(k.n_bounces.float().mean()),
            "max_bounces_seen": int(k.n_bounces.max())}


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

    from altair_tpu_torch.core import _build, trace_cuda

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.load("bounce")
    build_s = time.perf_counter() - t0
    with open(_build.library_path("bounce").with_suffix(".log")) as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    emit(phase_kernel_vs_plain(device))

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
    emit(sim)
    check(launches > 0, "the simulate engine never launched the kernel")
    sigma = math.hypot(direct["map_total_sigma"], sim["map_total_sigma"])
    check(abs(direct["map_total"] - sim["map_total"]) < 4 * sigma,
          f"map totals {direct['map_total']} vs {sim['map_total']} "
          f"(sigma {sigma})")

    emit(phase_scale(device))
    timing = phase_kernel_timing(device)
    emit(timing)

    print(smi)
    emit({"kernels": [{
        "name": "bounce", "route": "cuda",
        "source": trace_cuda.KERNEL_SOURCE, "replaces": trace_cuda.REPLACES,
        "launches": launches, "max_abs_err": timing["max_abs_err_cm"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
