"""The Plucker scorer's kernel (``csrc/score.cu``) on one CUDA GPU: its
operands as the two map paths hand them over, its time against its plain
version, and its bound.

    python -m altair_tpu_torch.profile_score [--reps R] [--tiles] [--out FILE]

Two shapes (``SHAPES``): ``binomial``, the binomial retrace map's shared
sample (the production scene, 128 x 50,000 Sobol rays, their exits
compacted into ``exit_capacity``'s buffer, about 2.7M valid rows) and
``map100k``, a 100,000-ray MIXED_BRDF trace-once map (a 100,000-row buffer,
about 46k valid), each against the full 180x90 grid.  ``scorer_call``
records the ``plucker_counts`` call of the path's
``fluxmap_trace_once_compact``; each is replayed: the kernel under CUDA
events (mean of ``R`` launches after a warm one), the plain version
(``_hits_block_mxu`` over the path's position chunks, on the card) the
same way, whether their counts differ, and the bound: the valid rows times
the positions times the benchmark's 35 flops a pair over 67 TFLOP/s
(``portbench/metrics/score_roofline_pct.map.py``).  ``--tiles`` also
builds ``score.cu`` for each (positions a thread, threads a block, least
resident blocks an SM) of ``TILES`` and times every build at both
shapes, in turns.  Prints one
JSON line per measurement; ``--out`` also writes them to a file.  Each
line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

MAX_BOUNCES = 4096
SHAPES = ("binomial", "map100k")
# the binomial map's shared sample: oversample x rays a position
BINOMIAL_RAYS = 128 * 50_000
# the benchmark's count of a pair's float operations, and the card's
# float32 peak outside the tensor cores
PAIR_FLOPS = 35
PEAK_FLOPS = 67e12
# (positions a thread, threads a block, least resident blocks an SM)
# builds that --tiles compares
TILES = ((4, 128, 1), (4, 128, 3), (4, 128, 4), (4, 256, 2), (6, 128, 2),
         (3, 128, 4), (4, 64, 8))


def scorer_call(device, shape: str, seed: int = 0) -> dict:
    """The keyword arguments of the ``plucker_counts`` call of one map of
    ``shape`` (see the module's docstring), traced from ``seed``."""
    import dataclasses

    from . import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid,
                   SurfaceModel, TraceConfig, trace_rays_auto)
    from .core import score

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    cfg = TraceConfig()
    if shape == "binomial":
        n = BINOMIAL_RAYS
        cfg = dataclasses.replace(cfg, qmc=1)
    elif shape == "map100k":
        n = 100_000
        scene = scene.with_(surface_model=SurfaceModel.MIXED_BRDF)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    res, _ = trace_rays_auto(torch.Generator().manual_seed(seed), scene,
                             SOURCE_OVERNIGHT, n, cfg, device=device)
    cap = score.exit_capacity(scene, n)
    pos_chunk = score.binomial_pos_chunk(cap) if shape == "binomial" else 1080
    calls = []
    real = score.plucker_counts

    def spy(E_rel, D, rowmask, W, Nrm, n_rows=None, pos_chunk=1080):
        calls.append(dict(E_rel=E_rel, D=D, rowmask=rowmask, W=W, Nrm=Nrm,
                          n_rows=n_rows, pos_chunk=pos_chunk))
        return real(E_rel, D, rowmask, W, Nrm, n_rows, pos_chunk)

    score.plucker_counts = spy
    try:
        score.fluxmap_trace_once_compact(res, DetectorGrid(), cap,
                                         scene.exit_port_z, pos_chunk)
    finally:
        score.plucker_counts = real
    (call,) = calls
    return call


def plain_counts(call: dict) -> torch.Tensor:
    """``plucker_counts``' plain version on the call's own device: the
    valid rows' features, then ``_hits_block_mxu`` over its position
    chunks."""
    from .core import score

    rowmask = call["rowmask"]
    if call["n_rows"] is not None:
        rowmask = rowmask & (torch.arange(rowmask.shape[0],
                                          device=rowmask.device)
                             < call["n_rows"])
    Phi = score._plucker_features(call["E_rel"], call["D"])
    c, W, Nrm = call["pos_chunk"], call["W"], call["Nrm"]
    return torch.cat([score._hits_block_mxu(Phi, call["D"], rowmask,
                                            W[i:i + c], Nrm[i:i + c])
                      for i in range(0, W.shape[0], c)])


def pairs(call: dict) -> int:
    """The call's valid rows times its positions."""
    rows = call["rowmask"]
    if call["n_rows"] is not None:
        rows = rows[:int(call["n_rows"])]
    return int(rows.sum()) * call["W"].shape[0]


def bound_ms(n_pairs: int) -> float:
    """The least time of ``n_pairs`` pairs at the benchmark's count."""
    return n_pairs * PAIR_FLOPS / PEAK_FLOPS * 1e3


def events_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_call(call: dict, reps: int = 10) -> dict:
    """One recorded call: the kernel's time, the plain version's, the
    positions whose counts differ and by how much at most, the bound and
    the kernel's share of it."""
    from .core import score

    args = (call["E_rel"], call["D"], call["rowmask"], call["W"],
            call["Nrm"], call["n_rows"])
    kernel_ms = events_ms(lambda: score.plucker_counts(*args), reps)
    plain_ms = events_ms(lambda: plain_counts(call), max(1, reps // 5))
    diff = (score.plucker_counts(*args).long()
            - plain_counts(call).long()).abs()
    n_pairs = pairs(call)
    b = bound_ms(n_pairs)
    return {"rows": int(call["E_rel"].shape[0]),
            "valid_rows": n_pairs // call["W"].shape[0],
            "positions": int(call["W"].shape[0]), "pairs": n_pairs,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "positions_differing": int((diff > 0).sum()),
            "max_count_diff": int(diff.max()), "bound_ms": b,
            "roofline_pct": 100.0 * b / kernel_ms,
            "bound_by": "operations"}


def build_tiles(tiles=TILES) -> dict:
    """Build ``csrc/score.cu`` once per (positions a thread, threads a
    block, least resident blocks an SM) with the flags of
    ``core/_build.py``, one nvcc each, all at once.  Returns ``{tile:
    (launcher, ptxas lines)}``."""
    from .core import _build, score

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for pt, threads, min_blocks in tiles:
        lib = (_build.BUILD_DIR
               / f"libprofile_score_{pt}x{threads}x{min_blocks}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               f"-DALTAIR_SCORE_POS_PER_THREAD={pt}",
               f"-DALTAIR_SCORE_THREADS={threads}",
               f"-DALTAIR_SCORE_MIN_BLOCKS={min_blocks}", "-o", str(lib),
               str(_build.CSRC / "score.cu")]
        jobs[(pt, threads, min_blocks)] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for key, (lib, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{e}")
        out[key] = (score.score_entry(ctypes.CDLL(str(lib))),
                    [ln.strip() for ln in (o + e).splitlines()
                     if "registers" in ln or "spill" in ln])
    return out


def launch_with(fn, call: dict) -> torch.Tensor:
    """``plucker_counts``' CUDA launch through another build's ``fn``."""
    from .core import score

    return score.launch_score(fn, call["E_rel"], call["D"], call["rowmask"],
                              call["W"], call["Nrm"], call["n_rows"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", action="store_true",
                    help="also time the builds of TILES")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_score: needs a CUDA device", file=sys.stderr)
        return 2
    from .profile_refill import card

    device = torch.device("cuda", 0)
    crd = card()
    tag = {"card": crd["name"], "power_limit_w": crd["power_limit_w"]}
    lines = []

    def emit(obj):
        lines.append({**obj, **tag})
        print(json.dumps(lines[-1]), flush=True)

    calls = {s: scorer_call(device, s, args.seed) for s in SHAPES}
    for s, call in calls.items():
        emit({"shape": s, **time_call(call, args.reps)})
    if args.tiles:
        builds = build_tiles()
        for key, (_, ptxas) in builds.items():
            emit({"tile": list(key), "ptxas": ptxas})
        for s, call in calls.items():
            ref = plain_counts(call).long()
            for _ in range(2):                  # two turns, in order
                for key, (fn, _) in builds.items():
                    ms = events_ms(lambda: launch_with(fn, call), args.reps)
                    diff = (launch_with(fn, call).long() - ref).abs()
                    emit({"shape": s, "tile": list(key), "kernel_ms": ms,
                          "max_count_diff": int(diff.max()),
                          "roofline_pct": 100.0 * bound_ms(pairs(call)) / ms})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
