"""The program's own tracer (``altair_tpu_torch.io.profiling``) read
against a traced run: its spans and counters per job, on the host clock
that the benchmark's spans and the device's intervals share (the tracer
stamps ``time.perf_counter_ns()``, the benchmark ``time.perf_counter()``).

Readers take a ``harness.Run`` and the program's records (the dict of
``profiling.records()``) and return None where there is nothing to read:
a program without the tracer, or a run in which it was off.  Each job's
spans are the roots that start inside the job's ``(start, end)``.

``host_syncs_per_job`` reads the program's process totals, which count
with tracing off, so a ``--trace 1`` run of the harness reads it as it
stands: the metrics ``host_syncs.map`` and ``host_syncs.trace``.  The
others need the tracer on over the window and the profiled jobs, which
``portbench/harness.py`` does not turn on.  Run as a script, this module
runs a cell's traced run (the harness's window and profiled jobs, without
the comparison) with the program's tracer off and on in turns and prints,
per run, the cell's per-layer metrics, the readings below and the checks
of the tracer's clock:

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        --seconds <s> [--rounds R] [--profile-jobs K] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

from . import arith

# each kernel span's device activity, by a part of the kernel's name
KERNEL_EVENTS = {"kernel.bounce": "bounce_kernel",
                 "kernel.refill": "refill_kernel"}


def program_records():
    """The program's tracer records, or None where the program has no
    tracer (an older checkout)."""
    try:
        from altair_tpu_torch.io import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    return records() if records is not None else None


def host_syncs_per_job(run, records=None):
    """The program's ``host_syncs`` process total over the jobs the
    process ran: the window's and the warm job (every job is the cell's
    shape).  ``records`` defaults to the program's own."""
    records = program_records() if records is None else records
    if not records or "host_syncs" not in records["totals"]:
        return None
    return records["totals"]["host_syncs"] / (len(run.jobs) + 1)


def _s(span):
    return span["start_ns"] * 1e-9, span["end_ns"] * 1e-9


def job_spans(run, records, unprofiled: bool = False):
    """``[(job index, [spans of its roots])]``: every program span grouped
    by the job whose ``(start, end)`` holds its root's start; with
    ``unprofiled``, only the jobs outside the profiled stretch, or all of
    them where there are no others (as ``readers.timed_spans``)."""
    if not records or not records["spans"]:
        return []
    spans = records["spans"]
    roots = {s["id"]: _s(s)[0] for s in spans if s["parent"] is None}
    jobs = list(enumerate(run.jobs))
    if unprofiled and run.profiled is not None:
        outside = [(i, j) for i, j in jobs if j[1] <= run.profiled[0]]
        jobs = outside or jobs
    out = []
    for i, (t0, t1, *_rest) in jobs:
        out.append((i, [s for s in spans
                        if t0 <= roots.get(s["root"], -1.0) <= t1]))
    return out


def stage_ms(run, records, name: str):
    """Mean host milliseconds per job in the spans called ``name``, over
    the jobs outside the profiled stretch."""
    per_job = job_spans(run, records, unprofiled=True)
    total = [sum(s["end_ns"] - s["start_ns"] for s in spans
                 if s["name"] == name) for _, spans in per_job]
    if not any(s["name"] == name for _, spans in per_job for s in spans):
        return None
    return 1e-6 * sum(total) / len(total)


def lane_use_pct(records):
    """100 x live / issued lane-steps over the loops the tracer saw."""
    tot = records["totals"] if records else {}
    issued = tot.get("lane_steps_issued", 0)
    if not issued or "lane_steps_live" not in tot:
        return None
    return 100.0 * tot["lane_steps_live"] / issued


def profiled_spans(run, records, name: str):
    """The program's spans called ``name`` inside the profiled stretch,
    as ``(start, end)`` host seconds."""
    if run.busy is None or not records:
        return []
    lo, hi = run.profiled
    return [_s(s) for s in records["spans"] if s["name"] == name
            and lo <= _s(s)[0] and _s(s)[1] <= hi]


def idle_pct_in(run, records, name: str):
    """The device's idle share inside the profiled spans called ``name``:
    100 x (1 - busy / the spans' host time)."""
    spans = profiled_spans(run, records, name)
    wall = sum(e - s for s, e in spans)
    if not spans or wall <= 0:
        return None
    return arith.idle_pct(sum(arith.covered(run.busy, s, e)
                              for s, e in spans), wall)


def labelled_spans(bench_spans, records):
    """Spans for ``profiling.breakdown``'s labels: each program span as
    ``<benchmark span>/<program span>``, innermost first, then the
    benchmark's own, so that a gap inside a program span is named by the
    innermost one and a gap outside every program span as before."""
    if not records:
        return list(bench_spans)
    by_id = {s["id"]: s for s in records["spans"]}

    def depth(s):
        d = 0
        while s["parent"] is not None:
            s, d = by_id[s["parent"]], d + 1
        return d

    out = []
    for s in sorted(records["spans"], key=depth, reverse=True):
        lo, hi = _s(s)
        outer = next((b for b in bench_spans if b[2] <= lo <= b[3]), None)
        if outer is not None:
            out.append([f"{outer[0]}/{s['name']}", outer[1], lo, hi, {}])
    return out + list(bench_spans)


def child_cover(records, name: str = "trace"):
    """The smallest share, over the spans called ``name``, of their host
    time that their direct children cover."""
    shares = []
    for s in records["spans"] if records else []:
        if s["name"] != name or s["end_ns"] <= s["start_ns"]:
            continue
        kids = sum(k["end_ns"] - k["start_ns"] for k in records["spans"]
                   if k["parent"] == s["id"])
        shares.append(kids / (s["end_ns"] - s["start_ns"]))
    return min(shares) if shares else None


def bench_cover(bench_spans, records, name: str = "trace"):
    """Per benchmark span called ``name`` (which ends in a device sync),
    the share of it that the program's spans called ``name`` overlap:
    ``(smallest, median)``."""
    prog = [_s(s) for s in (records["spans"] if records else [])
            if s["name"] == name]
    shares = []
    for b in bench_spans:
        if b[0] != name or b[3] <= b[2]:
            continue
        inside = sum(max(0.0, min(e, b[3]) - max(s, b[2])) for s, e in prog)
        shares.append(inside / (b[3] - b[2]))
    if not shares:
        return None
    shares.sort()
    return shares[0], shares[len(shares) // 2]


def kernel_offsets(kernels, records, lo: float, hi: float):
    """For every bounce or refill kernel the profiler saw in ``[lo, hi]``,
    on the anchored clock: ``(its start - the start of its kernel span,
    its start - that span's end)`` in seconds, its span being the
    ``kernel.*`` span of its kind whose start lies nearest."""
    out = []
    for span_name, kernel in KERNEL_EVENTS.items():
        spans = [_s(s) for s in records["spans"] if s["name"] == span_name]
        for name, k0, _ in kernels:
            if kernel not in name or not lo <= k0 <= hi or not spans:
                continue
            s0, s1 = min(spans, key=lambda se: abs(k0 - se[0]))
            out.append((k0 - s0, k0 - s1))
    return out


def traced_run(cell: dict, seed: int, seconds: float, device,
               program_tracing: bool):
    """``harness.run_cell``'s traced run without the comparison: one warm
    job, the window, then ``profile_jobs`` jobs under ``torch.profiler``,
    with the program's tracer on from the window's first job to the end
    of the profiled jobs, or off.  Returns ``(run, kernels, records)``:
    the ``harness.Run`` (spans, busy intervals, profiled stretch), the
    profiler's device activities and the program's records (None when
    off)."""
    import torch

    from altair_tpu_torch.io import profiling

    from . import harness
    from .profiling import Recorder, Spans

    t_start = time.perf_counter()
    kind = importlib.import_module(
        f"portbench.jobs.{cell['traffic_data']['job']}")
    job = kind.Program(cell, device)
    job.run(harness.cpu_key(seed, harness.WARM_STREAM), -1,
            Spans(device, False))
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    spans, key_of, jobs = Spans(device, True), harness.job_keys(cell, seed), []

    def one_job(i):
        stream, _ = key_of(i)
        t0 = time.perf_counter()
        out = job.run(harness.cpu_key(*stream), i, spans)
        jobs.append((t0, time.perf_counter(), out.ok, out.rays))

    profiling.clear()
    recorder = Recorder()
    with profiling.tracing() if program_tracing else contextlib.nullcontext():
        w0 = time.perf_counter()
        while not jobs or time.perf_counter() - w0 < seconds:
            one_job(len(jobs))
        first = len(jobs)
        recorder.start()
        for _ in range(int(cell["profile_jobs"])):
            one_job(len(jobs))
        recorder.stop()
    run = harness.Run(cell, setup_s, jobs, spans.items)
    run.busy, kernels = recorder.read()
    run.profiled = (jobs[first][0], jobs[-1][1])
    records = profiling.records() if program_tracing else None
    del job
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, kernels, records


def readings(run, kernels, records) -> dict:
    """The cell's own per-layer metrics (those that read without the
    comparison's facts) and, with the program's records, the readings of
    the program's spans and counters and the checks of its clock."""
    from . import harness
    from .profiling import breakdown

    out = {"jobs": len(run.jobs), "failed": sum(1 for j in run.jobs
                                                if not j[2])}
    metrics = {}
    for m in run.cell["per_layer"]:
        v = harness.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = v
    out["metrics"] = metrics
    lo, hi = run.profiled
    out["busy_s"], out["window_s"] = arith.covered(run.busy, lo, hi), hi - lo
    if records is None:
        return out
    jobs_traced = len(run.jobs)
    offsets = kernel_offsets(kernels, records, lo, hi)
    out["program"] = {
        "rim_ms": stage_ms(run, records, "trace.rim"),
        "straggler_ms": stage_ms(run, records, "trace.straggler"),
        "main_ms": stage_ms(run, records, "trace.main"),
        "trace_ms": stage_ms(run, records, "trace"),
        "host_syncs_per_job": records["totals"].get("host_syncs", 0)
        / jobs_traced,
        "lane_use_pct": lane_use_pct(records),
        "rim_idle_pct": idle_pct_in(run, records, "trace.rim"),
        "rim_cont_idle_pct": idle_pct_in(run, records, "trace.rim.cont"),
        "straggler_idle_pct": idle_pct_in(run, records, "trace.straggler"),
        "main_idle_pct": idle_pct_in(run, records, "trace.main"),
        "trace_child_cover_min": child_cover(records),
        "bench_trace_cover": bench_cover(run.spans, records),
        "kernels_checked": len(offsets),
        "kernel_start_minus_span_start_min_s": min(
            (a for a, _ in offsets), default=None),
        "kernel_start_minus_span_end_max_s": max(
            (b for _, b in offsets), default=None),
        "totals": records["totals"],
        "routes": sorted({s["attrs"].get("route") for s in records["spans"]
                          if s["name"] == "trace"} - {None}),
    }
    out["breakdown"] = breakdown(run.busy, kernels,
                                 labelled_spans(run.spans, records), lo, hi)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of (off, on), the order turning each round")
    ap.add_argument("--profile-jobs", type=int,
                    help="profile this many jobs instead of the cell's "
                         "profile_jobs (more kernels for the clock check)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    cell = harness.load_cell(harness.HERE.parent, args.workload)
    if args.profile_jobs:
        cell["profile_jobs"] = args.profile_jobs
    info = harness.device_info(device)
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            run, kernels, records = traced_run(cell, args.seed + r,
                                               args.seconds, device, on)
            line = json.dumps({"workload": args.workload,
                               "seed": args.seed + r, "program_tracing": on,
                               "device": info,
                               **readings(run, kernels, records)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
