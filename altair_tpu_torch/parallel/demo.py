"""Every sharded route and every ``mesh=`` sweep over several processes of
one machine — the counterpart of ``tools/multihost_demo.py``.

    python -m altair_tpu_torch.parallel.demo --launch 2 --device cpu --out DIR

starts 2 ranks as subprocesses that meet over a ``FileStore`` in ``DIR``.
Over gloo (the default) with ``--device cuda`` every rank traces on
``cuda:0``, because NCCL refuses two ranks on one card; ``--backend nccl``
gives rank ``r`` the card ``cuda:r`` of a machine that has one a rank.
Each rank runs every ``sharded_*`` route (``--what routes``), every sweep
with ``mesh=`` (``--what sweeps``) or both (``all``, the default) at a
small size and writes what it holds to ``DIR/rank<r>.npz``; rank 0 prints
one JSON line per route, and with ``--check`` holds the routes' outputs
against ``reference`` itself once everything has run (a mismatch is exit
code 1).  On a cluster, start the ranks with ``torchrun`` and call
``init_distributed()`` with no arguments instead (see
``altair_tpu_torch.cli --mesh``).

``reference(world_size, n_rays, device)`` computes what the routes must
return from the single-device functions alone: rank ``r``'s share traced
from ``fold_in(key, r)`` and summed over ``r``, no process group.  The
tests and the smoke run hold the launched ranks' results against it,
exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import (SCENE_INSPHERE, SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                DetectorGrid, SurfaceModel, TraceConfig)
from ..core.geometry import detector_position
from ..core.score import (binomial_cells_from_counts, binomial_pos_chunk,
                          exit_angle_histogram, exit_capacity,
                          exit_directions, fluxmap_retrace,
                          fluxmap_trace_once, fluxmap_trace_once_compact,
                          hits_insphere_disks, hits_single_detector,
                          insphere_disk_position, z_angle_histogram)
from ..core.trace import fold_in, split
from ..core.trace_waves import trace_rays_auto

MAX_BOUNCES = 64
SCENE = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
# a wall the bounce kernel takes, for the simulate engine's route
SCENE_KERNEL = SCENE.with_(exact_rim=False,
                           surface_model=SurfaceModel.MIXED_BRDF)
SCENE_BRDF = SCENE.with_(specular_prob=0.3, diffuse_prob=0.4,
                         brdf_roughness=0.6)
SCENE_DISK = SCENE_INSPHERE.with_(max_bounces=MAX_BOUNCES)
SOURCE = SOURCE_OVERNIGHT
CFG = TraceConfig(block_iters=16)
CFG_SIM = TraceConfig(block_iters=16, engine="simulate")
GRID = DetectorGrid(n_theta=18, n_phi=9)
GRID_SMALL = DetectorGrid(n_theta=6, n_phi=3)
GRID_BRDF = DetectorGrid(n_theta=9, n_phi=4, width=10.0, height=10.0)
PORTS = (164.0, 170.0)
SOURCE_XS = (-60.0, -40.0)
OVERSAMPLE = 4
PAIR = (45.0, 0.0)
# route name -> seed of its key; every rank builds the same key from it
SEEDS = {name: i for i, name in enumerate((
    "fluxmap", "fluxmap_simulate", "exit_histogram", "trace_score",
    "param_sweep", "param_sweep_grid", "param_sweep_sources", "retrace",
    "retrace_binomial", "insphere", "insphere_retrace", "scatter_retrace",
    "distribution", "twofold_pair"))}


def key(route: str) -> torch.Generator:
    return torch.Generator().manual_seed(SEEDS[route])


def per_pos(n_rays: int) -> int:
    """Rays per position of the retrace routes: an eighth of the batch."""
    return max(n_rays // 8, 2)


def disks(device):
    """Two focal-disk placements, ``([2, 3], [2, 3])`` on ``device``."""
    C, Nrm = insphere_disk_position(
        torch.tensor([0.0, 15.0], device=device),
        torch.tensor([0.0, 0.0], device=device),
        exit_port_z=SCENE_DISK.exit_port_z)
    return C.stack(), Nrm.stack()


def _members():
    from ..sweep.series import scene_members, stack_scenes, stack_sources

    scenes = stack_scenes(SCENE, theta_max_deg=np.asarray(PORTS))
    sources = stack_sources(SOURCE, x=np.asarray(SOURCE_XS))
    return scenes, sources, list(scene_members(scenes))


def _zero(overflow, what: str) -> None:
    if int(overflow):
        raise RuntimeError(f"reference: {what} overflow {int(overflow)}")


def _np(d: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in d.items()}


def run_routes(mesh, n_rays: int, emit=None) -> dict:
    """Every sharded route on this rank; ``{name: array}`` of what the
    rank holds afterwards.  ``emit(route, seconds, outputs)`` is called
    after each route."""
    from . import (sharded_distribution, sharded_exit_histogram,
                   sharded_fluxmap, sharded_insphere, sharded_param_sweep,
                   sharded_retrace, sharded_retrace_binomial,
                   sharded_scatter_retrace, sharded_score_traced,
                   sharded_trace, sharded_twofold_pair)

    scenes, sources, _ = _members()
    C, Nrm = disks(mesh.device)
    npp = per_pos(n_rays)
    out = {}

    def fluxmap(scene, cfg, route):
        counts, n_exit = sharded_fluxmap(mesh, key(route), scene, SOURCE,
                                         GRID, n_rays, cfg)
        return {f"{route}_counts": counts, f"{route}_n_exit": n_exit}

    def exit_histogram():
        hist, n_exit = sharded_exit_histogram(
            mesh, key("exit_histogram"), SCENE, SOURCE, n_rays, CFG)
        return {"exit_histogram_hist": hist, "exit_histogram_n_exit": n_exit}

    def trace_score():
        res = sharded_trace(mesh, key("trace_score"), SCENE, SOURCE, n_rays,
                            CFG)
        counts, n_exit = sharded_score_traced(mesh, res, SCENE, GRID)
        return {"trace_score_counts": counts, "trace_score_n_exit": n_exit,
                "trace_score_local_exits":
                    res.exited_port_mask(SCENE.exit_port_z).sum(
                        dtype=torch.int32)}

    def param_sweep():
        return {"param_sweep_exits": sharded_param_sweep(
            mesh, key("param_sweep"), scenes, SOURCE, n_rays, CFG)}

    def param_sweep_grid():
        maps, exits = sharded_param_sweep(
            mesh, key("param_sweep_grid"), scenes, SOURCE, n_rays, CFG,
            grid=GRID_SMALL)
        return {"param_sweep_grid_maps": maps,
                "param_sweep_grid_exits": exits}

    def param_sweep_sources():
        return {"param_sweep_sources_exits": sharded_param_sweep(
            mesh, key("param_sweep_sources"), SCENE, SOURCE, n_rays, CFG,
            sources=sources)}

    def retrace():
        return {"retrace_counts": sharded_retrace(
            mesh, key("retrace"), SCENE, SOURCE, GRID_SMALL, npp, CFG)}

    def retrace_binomial():
        stats = {}
        cells = sharded_retrace_binomial(
            mesh, key("retrace_binomial"), SCENE, SOURCE, GRID_SMALL, npp,
            CFG, oversample=OVERSAMPLE, stats=stats)
        return {"retrace_binomial_cells": cells,
                "retrace_binomial_counts_M": stats["counts_M"]}

    def insphere(retrace, route):
        return {f"{route}_counts": sharded_insphere(
            mesh, key(route), SCENE_DISK, SOURCE, C, Nrm, 5.0,
            npp if retrace else n_rays, CFG, retrace=retrace)}

    def scatter_retrace():
        return {"scatter_retrace_counts": sharded_scatter_retrace(
            mesh, key("scatter_retrace"), SCENE_BRDF, SOURCE, GRID_BRDF,
            n_rays, CFG)}

    def distribution():
        ang, dzh, mask, dx, dy, dz = sharded_distribution(
            mesh, key("distribution"), SCENE, SOURCE, n_rays, CFG)
        return {"distribution_ang": ang, "distribution_dzh": dzh,
                "distribution_local_exits": mask.sum()}

    def twofold_pair():
        return {"twofold_pair_counts": sharded_twofold_pair(
            mesh, key("twofold_pair"), SCENE, SOURCE, GRID, n_rays, CFG,
            *PAIR)}

    routes = {
        "fluxmap": lambda: fluxmap(SCENE, CFG, "fluxmap"),
        "fluxmap_simulate": lambda: fluxmap(SCENE_KERNEL, CFG_SIM,
                                            "fluxmap_simulate"),
        "exit_histogram": exit_histogram, "trace_score": trace_score,
        "param_sweep": param_sweep, "param_sweep_grid": param_sweep_grid,
        "param_sweep_sources": param_sweep_sources, "retrace": retrace,
        "retrace_binomial": retrace_binomial,
        "insphere": lambda: insphere(False, "insphere"),
        "insphere_retrace": lambda: insphere(True, "insphere_retrace"),
        "scatter_retrace": scatter_retrace, "distribution": distribution,
        "twofold_pair": twofold_pair,
    }
    for name, run in routes.items():
        t0 = time.perf_counter()
        got = _np(run())
        if emit is not None:
            emit(name, time.perf_counter() - t0, got)
        out.update(got)
    return out


def reference(world_size: int, n_rays: int, device) -> dict:
    """What ``run_routes`` must hold on every rank of a ``world_size``
    mesh, from the single-device functions: rank ``r``'s share from
    ``fold_in(key, r)``, summed over ``r``.  ``*_local_exits`` lists the
    ranks' own exit counts, ``[world_size]``."""
    from ..sweep.insphere import _retrace_counts
    from ..sweep.scatter_retrace import trace_scatter_retrace
    from ..sweep.series import members_tracer, source_members

    n = n_rays // world_size
    npp = per_pos(n_rays) // world_size
    _, sources, members = _members()
    C, Nrm = disks(device)
    M = OVERSAMPLE * per_pos(n_rays)
    k_trace, k_draw = split(fold_in(key("retrace_binomial"), 0x51), 2)
    ranks = []

    def trace(k, scene, n_local, cfg=CFG):
        res, rim = trace_rays_auto(k, scene, SOURCE, n_local, cfg,
                                   device=device)
        _zero(rim.total, "trace")
        return res

    def exits(res, scene=SCENE):
        return res.exited_port_mask(scene.exit_port_z).sum(dtype=torch.int32)

    def scored(res, scene, grid, cap):
        counts, overflow = fluxmap_trace_once_compact(
            res, grid, cap, scene.exit_port_z)
        _zero(overflow, "compaction")
        return counts

    def series(k, scenes_, srcs, grid=None):
        tracer = members_tracer(scenes_, CFG)
        cap = max(exit_capacity(m, n) for m in scenes_)
        rows = []
        for i, (scene, src) in enumerate(zip(scenes_, srcs)):
            res, rim = tracer(fold_in(k, i), scene, src, n, CFG,
                              device=device)
            _zero(rim.total, "series")
            rows.append((exits(res, scene),) if grid is None else
                        (exits(res, scene), scored(res, scene, grid, cap)))
        return [torch.stack(col) for col in zip(*rows)]

    for r in range(world_size):
        def k(route):
            return fold_in(key(route), r)

        o = {}
        for route, scene, cfg in (("fluxmap", SCENE, CFG),
                                  ("fluxmap_simulate", SCENE_KERNEL, CFG_SIM),
                                  ("trace_score", SCENE, CFG)):
            res = trace(k(route), scene, n, cfg)
            o[f"{route}_counts"] = scored(res, scene, GRID,
                                          exit_capacity(scene, n))
            o[f"{route}_n_exit"] = exits(res, scene)
        o["trace_score_local_exits"] = o["trace_score_n_exit"]
        res = trace(k("exit_histogram"), SCENE, n)
        o["exit_histogram_hist"] = exit_angle_histogram(
            res, exit_port_z=SCENE.exit_port_z)
        o["exit_histogram_n_exit"] = exits(res)
        (o["param_sweep_exits"],) = series(k("param_sweep"), members,
                                           [SOURCE] * len(members))
        o["param_sweep_grid_exits"], o["param_sweep_grid_maps"] = series(
            k("param_sweep_grid"), members, [SOURCE] * len(members),
            GRID_SMALL)
        srcs = list(source_members(sources))
        (o["param_sweep_sources_exits"],) = series(
            k("param_sweep_sources"), [SCENE] * len(srcs), srcs)
        o["retrace_counts"] = fluxmap_retrace(
            k("retrace"), SCENE, SOURCE, GRID_SMALL, npp, CFG, device=device)
        m_local = M // world_size
        cap = exit_capacity(SCENE, m_local)
        res = trace(fold_in(k_trace, r), SCENE, m_local,
                    dataclasses.replace(CFG, qmc=1))
        o["retrace_binomial_counts_M"], ovf = fluxmap_trace_once_compact(
            res, GRID_SMALL, cap, SCENE.exit_port_z, binomial_pos_chunk(cap))
        _zero(ovf, "binomial compaction")
        o["insphere_counts"] = hits_insphere_disks(
            trace(k("insphere"), SCENE_DISK, n), C, Nrm, 5.0)
        o["insphere_retrace_counts"], ovf = _retrace_counts(
            k("insphere_retrace"), SCENE_DISK, SOURCE, C, Nrm, 5.0, npp, CFG,
            min(max(1, min(32, (1 << 22) // npp)), C.shape[0]), device)
        _zero(ovf, "insphere retrace")
        res, ovf = trace_scatter_retrace(k("scatter_retrace"), SCENE_BRDF,
                                         SOURCE, n, CFG, device=device)
        _zero(ovf, "scatter-retrace")
        o["scatter_retrace_counts"] = fluxmap_trace_once(
            res, GRID_BRDF, SCENE_BRDF.exit_port_z)
        res = trace(k("distribution"), SCENE, n)
        mask, _, _, dz = exit_directions(res, SCENE.exit_port_z)
        o["distribution_ang"] = exit_angle_histogram(
            res, exit_port_z=SCENE.exit_port_z)
        o["distribution_dzh"] = z_angle_histogram(dz, mask)
        o["distribution_local_exits"] = mask.sum()
        res = trace(k("twofold_pair"), SCENE, n)
        th, ph = (torch.tensor(v, device=device) for v in PAIR)
        o["twofold_pair_counts"] = torch.stack([hits_single_detector(
            res, *detector_position(th, p, GRID.radius, SCENE.exit_port_z),
            GRID.width / 2.0, SCENE.exit_port_z) for p in (ph, ph + 180.0)])
        ranks.append(_np(o))

    out = {}
    for name in ranks[0]:
        stack = np.stack([o[name] for o in ranks])
        out[name] = (stack if name.endswith("_local_exits")
                     else stack.sum(0, dtype=stack.dtype))
    out["retrace_binomial_cells"] = binomial_cells_from_counts(
        k_draw, torch.as_tensor(out["retrace_binomial_counts_M"],
                                dtype=torch.int32).to(device),
        torch.zeros((), dtype=torch.int32, device=device), M,
        per_pos(n_rays), GRID_SMALL.n_positions).cpu().numpy()
    return out


def run_sweeps(mesh, n_rays: int, out_dir: str) -> dict:
    """Every sweep that takes ``mesh=`` on this rank, the files under
    ``out_dir`` (written by rank 0); ``{name: array or path}`` of what the
    rank got back."""
    from ..sweep import (run_distribution, sweep_detector_retrace,
                         sweep_detector_trace_once, sweep_detector_twofold,
                         sweep_insphere_detector, sweep_scatter_retrace)

    dev, npp = mesh.device, per_pos(n_rays)
    grid2 = DetectorGrid(n_theta=2, n_phi=4)
    out = {}

    def observer(name, r):
        out.update({f"{name}_fluxmap": r.fluxmap, f"{name}_path": r.path,
                    f"{name}_n_exited": r.n_exited})

    kw = dict(device=dev, cfg=CFG, mesh=mesh, verbose=mesh.rank == 0)
    observer("trace_once", sweep_detector_trace_once(
        SCENE, SOURCE, n_rays=n_rays, grid=GRID, seed=1,
        save_folder=os.path.join(out_dir, "trace_once"), **kw))
    observer("retrace", sweep_detector_retrace(
        SCENE, SOURCE, n_rays_per_pos=npp, grid=GRID_SMALL, seed=2,
        save_folder=os.path.join(out_dir, "retrace"), **kw))
    observer("retrace_binomial", sweep_detector_retrace(
        SCENE, SOURCE, n_rays_per_pos=npp, grid=GRID_SMALL, seed=3,
        engine="binomial", oversample=OVERSAMPLE,
        save_folder=os.path.join(out_dir, "retrace_binomial"), **kw))
    observer("twofold", sweep_detector_twofold(
        SCENE, SOURCE, n_rays_per_pair=npp, grid=grid2, seed=4,
        save_folder=os.path.join(out_dir, "twofold"), **kw))
    d = run_distribution(SCENE, SOURCE, device=dev, n_rays=n_rays, seed=5,
                         cfg=CFG, mesh=mesh)
    out.update(distribution_n_exited=d.n_exited,
               distribution_angle_hist=d.angle_hist,
               distribution_dz_hist=d.dz_hist,
               distribution_directions=d.directions)
    sweep_file = os.path.join(out_dir, "detector_sweep.txt")
    for retrace in (False, True):
        r = sweep_insphere_detector(
            SCENE_DISK, SOURCE, device=dev, n_rays=npp if retrace else n_rays,
            dtheta=15.0, theta_max=30.0, seed=6, cfg=CFG, retrace=retrace,
            save_path=sweep_file, mesh=mesh)
        out["insphere_retrace_fractions" if retrace
            else "insphere_fractions"] = r.fractions
    out["insphere_path"] = sweep_file
    out["scatter_retrace_fluxmap"] = sweep_scatter_retrace(
        SCENE_BRDF, SOURCE, device=dev, n_rays=n_rays, grid=GRID_BRDF,
        seed=7, cfg=CFG, mesh=mesh).fluxmap
    return _np(out)


def worker(args) -> int:
    """One rank: join the group over the ``FileStore``, run, write
    ``rank<r>.npz``."""
    import torch.distributed as dist

    from . import init_distributed, make_mesh

    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:   # NCCL: a card a rank (LOCAL_RANK, set by launch); gloo: share one
        device = torch.device(
            "cuda", args.rank if args.backend == "nccl" else 0)
    init_distributed(
        backend=args.backend, rank=args.rank, world_size=args.world_size,
        store=dist.FileStore(args.store, args.world_size),
        timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = make_mesh(device)
        out = {}

        def emit(route, seconds, got):
            if mesh.rank == 0:
                print(json.dumps({
                    "route": route, "wall_s": round(seconds, 4),
                    "backend": mesh.backend, "world_size": mesh.world_size,
                    "device": str(mesh.device), "n_rays": args.rays,
                    "outputs": {k: [list(v.shape), int(v.sum())]
                                for k, v in got.items()}}), flush=True)

        if args.what in ("routes", "all"):
            out.update(run_routes(mesh, args.rays, emit))
        if args.what in ("sweeps", "all"):
            out.update({f"sweep_{k}": v for k, v in run_sweeps(
                mesh, args.rays, os.path.join(args.out, "sweeps")).items()})
        np.savez(os.path.join(args.out, f"rank{mesh.rank}.npz"), **out)
        # after the last collective: the other ranks wait for nothing here
        if args.check and args.what != "sweeps" and mesh.rank == 0:
            ref = reference(mesh.world_size, args.rays, mesh.device)
            bad = [k for k, v in ref.items()
                   if not k.endswith("_local_exits")
                   and not np.array_equal(out[k], v)]
            print(json.dumps({"check": "routes against the single-device "
                              "functions", "outputs": len(ref),
                              "differ": bad}), flush=True)
            if bad:
                return 1
    finally:
        dist.destroy_process_group()
    return 0


def launch(n_ranks: int, device: str, rays: int, out: str, what: str = "all",
           timeout: float = 60.0, deadline: float = 300.0,
           extra: tuple = ()) -> int:
    """Start ``n_ranks`` workers of this module as local processes
    (``extra``: more of their arguments), wait for all of them until one
    shared ``deadline`` (seconds), kill what is left, and return 0 only if
    every rank returned 0."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "altair_tpu_torch.parallel.demo",
         "--rank", str(r), "--world-size", str(n_ranks), "--store", store,
         "--device", device, "--rays", str(rays), "--out", out,
         "--what", what, "--timeout", str(timeout), *extra],
        env=dict(env, LOCAL_RANK=str(r)))
        for r in range(n_ranks)]
    end = time.monotonic() + deadline
    rc = 0
    try:
        for p in procs:
            try:
                rc |= abs(p.wait(timeout=max(1.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                rc |= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return int(rc != 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launch", type=int, default=None,
                    help="start N ranks as local processes and wait for them")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--rays", type=int, default=512,
                    help="total rays of a route (split over the ranks)")
    ap.add_argument("--out", default="mesh_demo")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo",
                    help="nccl: rank r traces on cuda:r")
    ap.add_argument("--what", choices=["routes", "sweeps", "all"],
                    default="all")
    ap.add_argument("--check", action="store_true",
                    help="rank 0 holds the routes' outputs against the "
                         "single-device reference; a mismatch exits 1")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a rank waits at the rendezvous and at "
                         "each collective")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--store", default=None,
                    help="the FileStore's file (set by --launch)")
    args = ap.parse_args(argv)
    if args.launch:
        extra = ["--backend", args.backend] + (
            ["--check"] if args.check else [])
        return launch(args.launch, args.device, args.rays, args.out,
                      args.what, args.timeout, extra=tuple(extra))
    if args.rank is None or args.world_size is None or args.store is None:
        ap.error("pass --launch N, or --rank, --world-size and --store")
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
