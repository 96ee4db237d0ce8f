"""Command-line interface of the PyTorch port — the ``fluxmap`` and
``distribution`` subcommands of ``altair_tpu/cli.py``, with the same
arguments and defaults (no ``--mesh``), plus ``--device``:

  altair-tpu-torch fluxmap        <- sweepDetectorTraceOnce / sweepDetector
  altair-tpu-torch distribution   <- distributionSphereDetectorSweep + NRays

    python -m altair_tpu_torch.cli fluxmap --device cuda --rays 100000

``--device`` defaults to ``cuda``; without a visible CUDA device that is
an error, not a fall-back to the CPU (pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys


def _add_scene_args(p: argparse.ArgumentParser):
    p.add_argument("--port-angle", type=float, default=170.0,
                   help="exit-port angle thetaMax in degrees (default 170)")
    p.add_argument("--reflectance", type=float, default=0.99)
    p.add_argument("--roughness", type=float, default=0.01)
    p.add_argument("--max-bounces", type=int, default=50000)
    p.add_argument("--no-exact-rim", action="store_true",
                   help="disable the shell-rim face physics (~2x faster "
                        "tracing; exit fractions land at the top of the "
                        "corpus ranges instead of their centres)")
    p.add_argument("--surface", default="lambertian",
                   choices=["lambertian", "specular", "mixed", "cosn"])
    p.add_argument("--src", type=float, nargs=3, default=[-60.0, 0.0, -75.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--dir", type=float, nargs=3, default=[5.0, 0.0, 0.0],
                   metavar=("DX", "DY", "DZ"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--qmc", type=int, default=0, choices=[0, 1, 2],
                   help="Sobol low-discrepancy draws in the direct "
                        "sampler: 1=digital shift, 2=Owen-scrambled "
                        "(~1/N accuracy on smooth observables; "
                        "docs/ENGINES.md)")
    p.add_argument("--device", default="cuda",
                   help="torch device to trace on (default cuda; an error "
                        "when no CUDA device is visible)")


def _cfg(args):
    from .config import TraceConfig

    return TraceConfig(qmc=args.qmc)


def _device(args):
    """``--device`` as a ``torch.device``; a CUDA device that is not there
    is an error."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "visible (pass --device cpu to run on the CPU)")
    return dev


def _scene_source(args):
    from .config import SphereScene, Source, SurfaceModel

    model = {"lambertian": SurfaceModel.LAMBERTIAN,
             "specular": SurfaceModel.SPECULAR,
             "mixed": SurfaceModel.MIXED_BRDF,
             "cosn": SurfaceModel.COS_N_LOBE}[args.surface]
    scene = SphereScene(
        theta_max_deg=args.port_angle, reflectance=args.reflectance,
        roughness=args.roughness, max_bounces=args.max_bounces,
        surface_model=model, exact_rim=not args.no_exact_rim)
    source = Source(x=args.src[0], y=args.src[1], z=args.src[2],
                    dir_x=args.dir[0], dir_y=args.dir[1], dir_z=args.dir[2])
    return scene, source


def cmd_fluxmap(args):
    from .config import DetectorGrid
    from .sweep import (fluxmap_replicates, sweep_detector_retrace,
                        sweep_detector_trace_once, write_fluxmap_csv)

    device = _device(args)
    scene, source = _scene_source(args)
    cfg = _cfg(args)
    grid = DetectorGrid(n_theta=args.theta_bins, n_phi=args.phi_bins,
                        width=args.detector_size, height=args.detector_size)
    if args.replicates > 1:
        if args.method != "trace-once":
            raise SystemExit("--replicates applies to --method trace-once")
        import numpy as np

        mean, sem = fluxmap_replicates(
            scene, source, device=device, n_rays=args.rays, grid=grid,
            replicates=args.replicates, seed=args.seed, cfg=cfg)
        bright = mean > mean.max() * 0.1
        print(f"{args.replicates} replicates x {args.rays} rays: "
              f"pooled bright-cell sem "
              f"{sem[bright].mean():.3e} (rel "
              f"{(sem[bright] / np.maximum(mean[bright], 1e-12)).mean():.3%})")
        if args.out:
            path = write_fluxmap_csv(args.out, scene, source, grid,
                                     args.rays * args.replicates, mean,
                                     trace_once=True)
            print(f"mean flux map saved to '{path}'")
        return 0
    if args.method == "trace-once":
        res = sweep_detector_trace_once(
            scene, source, device=device, n_rays=args.rays, grid=grid,
            seed=args.seed, cfg=cfg, save_folder=args.out,
            notify=args.notify)
    else:
        res = sweep_detector_retrace(
            scene, source, device=device, n_rays_per_pos=args.rays,
            grid=grid, seed=args.seed, cfg=cfg, save_folder=args.out,
            notify=args.notify, resume_path=args.resume,
            engine=args.retrace_engine, oversample=args.oversample)
    print(f"total {res.total_time_s:.3f}s  trace {res.trace_time_s:.3f}s")
    return 0


def cmd_distribution(args):
    from .sweep import run_distribution, write_angular_dist, write_ray_log

    device = _device(args)
    scene, source = _scene_source(args)
    d = run_distribution(scene, source, device=device, n_rays=args.rays,
                         seed=args.seed, cfg=_cfg(args))
    print(f"Flux of rays through the exit port: {d.n_exited}")
    if args.ray_log:
        write_ray_log(args.ray_log, d.directions)
    if args.angular_dist:
        write_angular_dist(args.angular_dist, d.dz_hist)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="altair-tpu-torch",
        description="integrating-sphere photon tracer on PyTorch (CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fluxmap", help="observer flux-map sweep")
    _add_scene_args(p)
    p.add_argument("--method", choices=["trace-once", "retrace"],
                   default="trace-once")
    p.add_argument("--rays", type=int, default=100_000,
                   help="total rays (trace-once) or rays per position")
    p.add_argument("--theta-bins", type=int, default=180)
    p.add_argument("--phi-bins", type=int, default=90)
    p.add_argument("--detector-size", type=float, default=40.0)
    p.add_argument("--out", default="results")
    p.add_argument("--resume", default=None,
                   help="partial CSV from a killed retrace run")
    p.add_argument("--retrace-engine", choices=["simulate", "binomial"],
                   default="simulate",
                   help="binomial: per-cell retrace statistics sampled "
                        "from one shared trace (means exact, 1/oversample "
                        "excess variance — docs/PARITY.md §9)")
    p.add_argument("--oversample", type=int, default=128,
                   help="shared-sample factor for the binomial engine")
    p.add_argument("--replicates", type=int, default=1,
                   help=">1: run K independent trace-once maps and report "
                        "the mean map with per-cell error bars "
                        "(sweep.fluxmap_replicates; with --qmc each "
                        "replicate is an independent Sobol randomisation)")
    p.add_argument("--notify", action="store_true")
    p.set_defaults(fn=cmd_fluxmap)

    p = sub.add_parser("distribution", help="exit angular distribution")
    _add_scene_args(p)
    p.add_argument("--rays", type=int, default=10_000)
    p.add_argument("--ray-log", default=None,
                   help="write 3dRayLog.txt-dialect directions here")
    p.add_argument("--angular-dist", default=None,
                   help="write angular_dist.txt-dialect histogram here")
    p.set_defaults(fn=cmd_distribution)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
