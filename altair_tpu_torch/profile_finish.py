"""The finish kernel (``csrc/finish.cu``) on one CUDA GPU: its entry states
as the main paths hand them over, its time against its plain version, and
its bound.

    python -m altair_tpu_torch.profile_finish [--reps R] [--out FILE]

For each main path that runs it — the MIXED_BRDF trace-once map's rim
continuation (100,000 rays, exact rim; the bounce kernel's path), the
4,194,304-ray trace's straggler finish and rim continuation (the refill
kernel's path) and the in-sphere retrace sweep's chunk (800,000 rays from
the source through the thick 105 cm shell, ``trace_rays_finish``) — it
records the ``finish`` calls of one trace (``finish_calls``), then
replays each: the kernel under CUDA events (mean
of ``R`` launches after a warm one), ``finish_plain`` once on the host
clock, the lanes on which the two agree (status and bounces) and the
largest position or direction difference on them, the bound: the
longest lane's steps times one step's latency (``finish_step_latency_ms``:
one thread, the port closed, a wall that absorbs nothing, 4096 steps
against 1), the launch's lanes a thread (its pool depth) and its lane use
(``lane_use``).  Prints one JSON line per call; ``--out`` also writes
them to a file.  Each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import sys
import time

import numpy as np
import torch

MAX_BOUNCES = 4096
# the paths timed: (name, law, rays)
PATHS = (("map100k_rim", "MIXED_BRDF", 100_000),
         ("trace4M", "MIXED_BRDF", 4_194_304))
# the in-sphere retrace sweep's chunk: 8 positions of 100,000 rays
INSPHERE_CHUNK = 800_000


def finish_calls(device, scene, n: int, seed: int = 0,
                 source=None) -> list[dict]:
    """The arguments of every ``trace_cuda.finish`` call of one
    ``trace_rays_auto(engine="simulate")`` trace of ``n`` rays of
    ``scene`` from ``source`` (default ``SOURCE_OVERNIGHT``), in call
    order, as keyword dictionaries of ``finish_plain`` (the state planes
    made dense)."""
    from . import SOURCE_OVERNIGHT, TraceConfig, trace_rays_auto
    from .core import trace_cuda

    calls = []
    real = trace_cuda.finish

    def spy(seed, scene_vec, rim_vec, state, model, max_iters, exact_rim,
            **kw):
        calls.append(dict(seed=seed, scene_vec=scene_vec, rim_vec=rim_vec,
                          state=(*(type(v)(*(c.contiguous() for c in v))
                                   for v in state[:3]),
                                 *(t.contiguous() for t in state[3:])),
                          model=model, max_iters=max_iters,
                          exact_rim=exact_rim))
        return real(seed, scene_vec, rim_vec, state, model, max_iters,
                    exact_rim, **kw)

    trace_cuda.finish = spy
    try:
        trace_rays_auto(torch.Generator().manual_seed(seed), scene,
                        SOURCE_OVERNIGHT if source is None else source, n,
                        TraceConfig(engine="simulate"), device=device)
    finally:
        trace_cuda.finish = real
    return calls


def source_entry_call(device, model=None, n: int = INSPHERE_CHUNK,
                      max_iters: int | None = None, seed: int = 0) -> dict:
    """The ``finish`` arguments of the thick-rim route from the source
    (``trace_rays_finish``): ``n`` rays of the in-sphere sweep's shell
    (``SCENE_INSPHERE``, its law ``model``, default Lambertian) from
    ``SOURCE_DEMO``; ``max_iters`` (default the scene's 10,000) caps the
    steps."""
    from . import SCENE_INSPHERE, SOURCE_DEMO, SurfaceModel

    scene = SCENE_INSPHERE
    if model is not None:
        scene = scene.with_(surface_model=SurfaceModel(model))
    (call,) = finish_calls(device, scene, n, seed, SOURCE_DEMO)
    if max_iters is not None:
        call["max_iters"] = max_iters
    return call


def mixed_entry_state(device, model, n: int = 20_000, n_interior: int = 2048,
                      max_iters: int = 256, seed: int = 0) -> dict:
    """``finish`` arguments whose state holds every kind of lane: the rim
    continuation's buffer of an ``n``-ray simulate trace (lanes in the gap
    after their first rim bounce, dead lanes: killed there or padding),
    then ``n_interior`` source rays (interior, RUNNING, 3 bounces so far);
    ``max_iters`` small enough that some lanes reach the cap."""
    from . import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from .core.trace import _source_rays

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, surface_model=model)
    (rim,) = [c for c in finish_calls(device, scene, n, seed)
              if c["exact_rim"]]
    pos, d = _source_rays(SOURCE_OVERNIGHT, n_interior, torch.float32, device)
    extra = (pos, d, pos,
             torch.zeros(n_interior, dtype=torch.int32, device=device),
             torch.full((n_interior,), 3, dtype=torch.int32, device=device),
             torch.zeros(n_interior, dtype=torch.bool, device=device))
    state = tuple(type(a)(*(torch.cat([x, y]) for x, y in zip(a, b)))
                  if isinstance(a, tuple) else torch.cat([a, b])
                  for a, b in zip(rim["state"], extra))
    return {**rim, "state": state, "max_iters": max_iters,
            "model": SurfaceModel(model)}


def lane_kinds(state) -> dict:
    """How many lanes of a ``finish`` state are in the gap, interior
    (both RUNNING), and dead."""
    run = state[3] == 0
    return {"gap": int((run & state[5]).sum()),
            "interior": int((run & ~state[5]).sum()),
            "dead": int((~run).sum())}


def compare(a, b):
    """The share of lanes whose status and bounce count agree, and the
    largest position or direction difference on them: 0 where both are
    NaN (dead padding lanes pass their state through), inf where one is."""
    agree = (a.status == b.status) & (a.n_bounces == b.n_bounces)
    err = 0.0
    for f in ("last_point", "seg_start", "direction"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            d = torch.where(x.isnan() & y.isnan(), 0.0, (x - y).abs())
            d = torch.nan_to_num(d, nan=math.inf)
            if bool(agree.any()):
                err = max(err, float(d[agree].max()))
    return float(agree.float().mean()), err


def schedule(steps, threads: int) -> np.ndarray:
    """The loop iterations each warp of a finish launch runs, from its
    lanes' step counts ``steps`` (one per lane of the buffer) and its
    ``threads``, in the kernel's order (``csrc/finish.cu``): thread g
    starts on lane g; a thread whose lane stops takes its warp's next
    lane at the next iteration, the threads free at one iteration in
    thread order, and steps it in that iteration (a lane that takes no
    step holds it that one iteration).  Warp w's next lanes are its rows
    w*32 + r*threads, less its trailing rows in which no lane steps (the
    kernel writes those back first).  At ``threads >= len(steps)`` no
    thread takes a second lane, and each warp runs its longest lane."""
    s = np.maximum(np.asarray(steps, dtype=np.int64), 0)
    n = s.size
    end = np.zeros(threads, dtype=np.int64)
    end[:min(n, threads)] = s[:threads]
    if threads < n:
        cost = np.maximum(s, 1)
        for w in range(0, threads, 32):
            heap = [(int(end[j]), j) for j in range(w, w + 32)]
            heapq.heapify(heap)
            rows = list(range(w + threads, n, threads))
            while rows and not s[rows[-1]:rows[-1] + 32].any():
                rows.pop()
            for row in rows:
                for lane in range(row, min(n, row + 32)):
                    t, j = heapq.heappop(heap)
                    heapq.heappush(heap, (t + int(cost[lane]), j))
            for t, j in heap:
                end[j] = t
    return end.reshape(-1, 32).max(axis=1)


def lane_use(steps, threads: int) -> tuple[float, int]:
    """Lane-steps over the threads' iterations (each warp's 32 threads
    times its iterations, ``schedule``), and the longest warp's
    iterations: the share of the launch's thread-iterations that stepped
    a lane, leaving out the physics' own branch divergence."""
    s = np.maximum(np.asarray(steps, dtype=np.int64), 0)
    warps = schedule(s, threads)
    return float(s.sum() / max(32 * int(warps.sum()), 1)), int(warps.max())


def finish_step_latency_ms(device, reps: int = 5) -> float:
    """One thread of the finish kernel (exact rim, MIXED_BRDF, interior)
    with the port closed (cos_cap below the sphere) and a wall that
    absorbs nothing: its time for 4096 steps less its time for 1, over
    4095 (CUDA events)."""
    from . import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
    from .core import trace_cuda
    from .core.trace import _source_rays

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES,
                                 surface_model=SurfaceModel.MIXED_BRDF)
    sv, _ = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
    sv[1] = -2.0 * sv[0]
    sv[2] = 1.0
    rim = trace_cuda.rim_operand(scene, device)
    pos, d = _source_rays(SOURCE_OVERNIGHT, 1, torch.float32, device)
    zi = torch.zeros(1, dtype=torch.int32, device=device)
    state = (pos, d, pos, zi, zi, torch.zeros(1, dtype=torch.bool,
                                              device=device))
    times = {}
    for it in (1, MAX_BOUNCES):
        times[it] = events_ms(lambda: trace_cuda.finish(
            (1, 2), sv, rim, state, 2, it, True), reps)
    return (times[MAX_BOUNCES] - times[1]) / (MAX_BOUNCES - 1)


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


def time_call(call: dict, latency_ms: float, reps: int = 20) -> dict:
    """One recorded ``finish`` call: the kernel's time, the plain
    version's, their agreement, the bound (its longest lane's steps, a
    bounce or an exit each, times ``latency_ms``), the launch's lanes a
    thread and its lane use (``lane_use``)."""
    from .core import trace_cuda

    state = call["state"]
    n = int(state[3].shape[0])
    kernel_ms = events_ms(lambda: trace_cuda.finish(**call), reps)
    k = trace_cuda.finish(**call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = trace_cuda.finish_plain(**call)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree, err = compare(k, p)
    steps = (k.n_bounces - state[4]).long() + (k.status == 1).long()
    longest = int(steps.max()) if steps.numel() else 0
    slots = trace_cuda.finish_slots(state[3].device, int(call["model"]),
                                    bool(call["exact_rim"]))
    threads = trace_cuda.finish_grid_threads(n, slots)
    use, iters = lane_use(steps.cpu().numpy(), threads)
    return {"n": n, "exact_rim": bool(call["exact_rim"]),
            "lanes": lane_kinds(state), "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "agree": agree, "max_abs_err_cm": err,
            "lane_steps": int(steps.sum()), "longest_lane_steps": longest,
            "step_latency_ms": latency_ms, "bound_ms": longest * latency_ms,
            "bound_by": "serial chain", "slots": slots, "threads": threads,
            "lanes_per_thread": trace_cuda.finish_lanes_per_thread(n, slots),
            "lane_use": use, "schedule_iterations": iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_finish: needs a CUDA device", file=sys.stderr)
        return 2
    from . import SCENE_OPTIMIZE, SurfaceModel
    from .profile_refill import card

    device = torch.device("cuda", 0)
    crd = card()
    latency = finish_step_latency_ms(device)
    lines = []
    calls = [(name, law, n, call) for name, law, n in PATHS
             for call in finish_calls(
                 device, SCENE_OPTIMIZE.with_(
                     max_bounces=MAX_BOUNCES,
                     surface_model=SurfaceModel[law]), n, args.seed)]
    calls.append(("insphere105_source", "LAMBERTIAN", INSPHERE_CHUNK,
                  source_entry_call(device, seed=args.seed)))
    for name, law, n, call in calls:
        lines.append({"path": name, "law": law, "rays": n,
                      **time_call(call, latency, args.reps),
                      "card": crd["name"],
                      "power_limit_w": crd["power_limit_w"]})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
