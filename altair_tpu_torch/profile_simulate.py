"""Where the time goes in the simulate engine's large-batch trace, on one
CUDA GPU.

    python -m altair_tpu_torch.profile_simulate [--n N] [--rounds R] [--out FILE]

Traces N rays (default 4,194,304) of the production scene
(``SCENE_OPTIMIZE``: port 170 deg, exact rim; ``SOURCE_OVERNIGHT``; a
4096-bounce cap as ``bench.py``) through
``trace_rays_auto(engine="simulate")`` in four variants:

* ``A_dispatch``: the refill kernel with the handoff at
  ``trace_cuda._REFILL_HANDOFF``, its straggler finish, and the waves rim
  continuation;
* ``B_no_handoff``: A with the handoff off;
* ``C_bounce``: the bounce kernel alone (``REFILL_MIN`` raised past N);
* ``D_eager_rim``: A with the eager loop in place of the waves rim
  continuation (``_WAVES_CONTINUATION_MIN`` raised past N).

One warm run of each, then R rounds in turns (A B C D, D C B A, ...).  A
run records its wall time (host clock, up to a device sync and the
exit-count readback) and its stages: ``main_trace`` (``_kernel_padded``),
``straggler_finish`` (``_refill_handoff_continue``, part of the main
trace) and ``rim_post_pass`` (the rest: clip test, compactions, rim
continuation, readback).  The stage wrappers sync the device at their
edges.  Then one ``torch.profiler`` run of each variant, with the stage
wrappers off, gives the device's busy time (the union of its activity
intervals) and its activity count.  Prints one JSON line per variant;
``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

VARIANTS = ("A_dispatch", "B_no_handoff", "C_bounce", "D_eager_rim")
MAX_BOUNCES = 4096


@contextlib.contextmanager
def variant(name: str, n: int):
    """Set the dispatch constants of ``name`` and restore them after."""
    from .core import trace, trace_cuda

    saved = (trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF,
             trace._WAVES_CONTINUATION_MIN)
    if name == "B_no_handoff":
        trace_cuda._REFILL_HANDOFF = 0.0
    elif name == "C_bounce":
        trace_cuda.REFILL_MIN = n + 1
    elif name == "D_eager_rim":
        trace._WAVES_CONTINUATION_MIN = n + 1
    try:
        yield
    finally:
        (trace_cuda.REFILL_MIN, trace_cuda._REFILL_HANDOFF,
         trace._WAVES_CONTINUATION_MIN) = saved


@contextlib.contextmanager
def stage_timers(device, stages: dict):
    """Time the main trace and the straggler finish into ``stages``
    (seconds, summed over calls)."""
    from .core import trace_cuda

    names = {"main_trace": "_kernel_padded",
             "straggler_finish": "_refill_handoff_continue"}
    saved = {f: getattr(trace_cuda, f) for f in names.values()}

    def timed(stage, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(device)
            stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    for stage, f in names.items():
        setattr(trace_cuda, f, timed(stage, saved[f]))
    try:
        yield
    finally:
        for f, fn in saved.items():
            setattr(trace_cuda, f, fn)


def trace_once(device, n: int, seed: int):
    """One simulate-engine trace; returns (wall seconds, exit fraction)."""
    from . import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig, trace_rays_auto

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res, rim = trace_rays_auto(torch.Generator().manual_seed(seed),
                               SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES),
                               SOURCE_OVERNIGHT, n,
                               TraceConfig(engine="simulate"), device=device)
    n_exit = int(res.exited_port_mask().sum())
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if int(rim):
        raise RuntimeError(f"seed {seed}: overflow {int(rim)}")
    return wall, n_exit / n


def staged_run(device, n: int, seed: int) -> dict:
    from .core import trace_waves

    stages: dict = {}
    trace_waves.wave_plans.clear()
    with stage_timers(device, stages):
        wall, frac = trace_once(device, n, seed)
    stages["rim_post_pass"] = wall - stages["main_trace"]
    return {"wall_s": wall, "exit_fraction": frac, "stages_s": stages,
            "waves": list(trace_waves.wave_plans)}


def profiled_run(device, n: int, seed: int) -> dict:
    """Device busy time under ``torch.profiler``: the union of the
    device activities' intervals.  None when the profiler saw no device
    activity (no CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .io.profiling import device_busy_s

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = trace_once(device, n, seed)
    busy = device_busy_s(prof)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": None if busy is None else busy / wall,
            "device_activities": sum(e.device_type == DeviceType.CUDA
                                     for e in prof.events())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=500)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_simulate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]

    seed = args.seed
    rows = {v: {"variant": v, "nvidia_smi": smi, "n_rays": args.n,
                "runs": []} for v in VARIANTS}
    for v in VARIANTS:                  # warm runs, not kept
        with variant(v, args.n):
            staged_run(device, args.n, seed)
        seed += 1
    for r in range(args.rounds):
        for v in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
            with variant(v, args.n):
                rows[v]["runs"].append(staged_run(device, args.n, seed))
            seed += 1
    for v in VARIANTS:
        with variant(v, args.n):
            rows[v]["profile"] = profiled_run(device, args.n, seed)
        seed += 1

    lines = [json.dumps(rows[v]) for v in VARIANTS]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
