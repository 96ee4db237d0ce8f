"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result line.

A cell is found by name.  ``BENCHMARK.json`` at the checkout's root names
its configuration and traffic and lists the metrics; the files are
``portbench/workloads/<cell>.json`` (the cell's own numbers: how many
jobs to profile and to sample, the reference's ray count, the limits),
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``
(whose ``"job"`` names ``portbench/jobs/<job>.py``) and
``portbench/metrics/<metric>.py`` for every metric.  Adding a cell, a
configuration, a mix or a metric adds files and entries; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# top-level module names the process may not hold once the window closes:
# the JAX stack, the JAX package and the repository's JAX-era harnesses
FORBIDDEN = ("jax", "jaxlib", "flax", "altair_tpu", "chip_smoke", "bench",
             "benchmarks")
# streams of the seed besides the jobs' (job i takes stream i)
WARM_STREAM = 1 << 40
SAMPLE_STREAM = (1 << 40) + 1
REFERENCE_STREAM = (1 << 40) + 2
ORDER_STREAM = (1 << 40) + 3
# the seed of a traffic's fixed job pool (``job_keys``)
POOL_SEED = 20261018


def stream_seed(seed: int, stream: int) -> int:
    """A 62-bit seed for one stream of ``--seed`` (any non-negative
    whole number)."""
    (s,) = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)
    return int(s) >> 2


def cpu_key(seed: int, stream: int):
    import torch

    return torch.Generator().manual_seed(stream_seed(seed, stream))


def job_keys(cell: dict, seed: int):
    """``key_of(i) -> ((seed, stream), repeat)``: the stream job ``i`` of
    a run draws from, and whether an earlier job of the run drew it.
    Without a ``job_pool`` job ``i`` takes stream ``i`` of ``--seed``.
    With ``"job_pool": K`` in the traffic file every seed runs the same K
    jobs (streams of ``POOL_SEED``), in an order the seed draws, cycling:
    the work of a window no longer depends on the seed (a heavy tail of
    slow jobs made the trace-once maps' ``map_s`` differ by 30% from seed
    to seed and by 1-4% between two runs of one seed)."""
    pool = cell["traffic_data"].get("job_pool")
    if not pool:
        return lambda i: ((seed, i), False)
    order = list(range(int(pool)))
    random.Random(stream_seed(seed, ORDER_STREAM)).shuffle(order)
    return lambda i: ((POOL_SEED, order[i % len(order)]), i >= len(order))


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``modules`` (default ``sys.modules``) that
    are in ``FORBIDDEN``, compared whole: ``altair_tpu_torch`` is not
    ``altair_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> dict:
    """Everything a run needs to know about ``workload``, read from
    ``BENCHMARK.json`` under ``root`` and the benchmark's files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = json.loads((HERE / "workloads" / f"{workload}.json").read_text())
    cell.update(name=workload, chips=int(entry["chips"]),
                config=entry["config"], traffic=entry["traffic"])
    cell["config_data"] = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    cell["traffic_data"] = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())

    def applies(m, reported):
        if "workloads" in m:
            return workload in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    names = {m["name"] for m in e2e}
    cell["end_to_end"] = e2e
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m, names)]
    return cell


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell, the set-up time, the window's
    jobs ``[(start, end, ok, rays)]``, and in a traced run the profile."""

    cell: dict
    setup_s: float
    jobs: list
    spans: list = dataclasses.field(default_factory=list)
    busy: list | None = None
    profiled: tuple | None = None       # (start, end) host seconds
    facts: dict = dataclasses.field(default_factory=dict)

    @property
    def completed(self):
        return [j for j in self.jobs if j[2]]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             side: str = "Program", t_start: float | None = None,
             log=print) -> dict:
    """Run ``cell`` once on ``device`` and return the result object.
    ``side`` is ``"Program"`` or, for the calibration, ``"Control"``.
    ``t_start`` is the host-clock time of the process start (set-up is
    counted from it)."""
    import torch

    from .profiling import Recorder, Spans, breakdown

    t_start = time.perf_counter() if t_start is None else t_start
    kind = importlib.import_module(
        f"portbench.jobs.{cell['traffic_data']['job']}")
    job = getattr(kind, side)(cell, device)

    # ---- set-up: one warm job of the cell's own shape -----------------
    warm = job.run(cpu_key(seed, WARM_STREAM), -1, Spans(device, False))
    if not warm.ok:
        raise RuntimeError(f"the warm job failed: {warm.error}")
    del warm
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window: jobs back to back, one client --------------------
    spans = Spans(device, trace)
    sampler = random.Random(stream_seed(seed, SAMPLE_STREAM))
    n_sample = int(cell["sample_jobs"])
    sampled = []          # (job, payload), a reservoir sample of distinct jobs
    outs, records = [], []
    key_of = job_keys(cell, seed)

    def one_job(i):
        stream, repeat = key_of(i)
        t0 = time.perf_counter()
        try:
            out = job.run(cpu_key(*stream), i, spans)
        except Exception as exc:   # a job that raises is a failed job
            from .jobs import Out

            log(f"job {i} raised:\n{traceback.format_exc()}", file=sys.stderr)
            out = Out(False, job.rays, error=repr(exc))
        records.append((t0, time.perf_counter(), out.ok, out.rays))
        out.repeat = repeat
        if out.ok and not repeat:
            seen = sum(1 for o in outs if not o.repeat)
            if len(sampled) < n_sample:
                sampled.append((i, out.payload))
            else:
                k = sampler.randrange(seen + 1)
                if k < n_sample:
                    sampled[k] = (i, out.payload)
        out.payload = None
        outs.append(out)

    w0 = time.perf_counter()
    while not outs or time.perf_counter() - w0 < seconds:
        one_job(len(outs))
    # a traced run ends with profile_jobs more jobs under torch.profiler:
    # jobs after a profile run slower, so the spans of the window come
    # first
    recorder, profiled = None, None
    if trace:
        recorder = Recorder()
        recorder.start()
        first = len(outs)
        for _ in range(int(cell["profile_jobs"])):
            one_job(len(outs))
        recorder.stop()
        profiled = (records[first][0], records[-1][1])

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run = Run(cell, setup_s, records, spans.items)
    breakdown_ = None
    device_extra = {}
    if recorder:
        busy, kernels = recorder.read()
        lo, hi = profiled
        run.busy, run.profiled = busy, profiled
        from .arith import covered

        device_extra = {"busy_s": covered(busy, lo, hi), "window_s": hi - lo}
        breakdown_ = breakdown(busy, kernels, spans.items, lo, hi)
        del kernels, recorder

    # ---- the comparison, after the window and with its state freed ----
    payloads = [job.neutral(p) for _, p in sorted(sampled, key=lambda x: x[0])]
    del sampled, job
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, REFERENCE_STREAM))
    numbers, facts = kind.judge(cell, outs, payloads, ref_gen, device)
    run.facts = facts
    from .judge import check

    correct, lines = check(numbers, cell["limits"])

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(outs),
        "failed": sum(1 for o in outs if not o.ok),
        "metrics": metrics,
        "device": {**device_info(device), "memory_peak_bytes": memory_peak,
                   **device_extra},
    }
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in lines.items()}
    return result


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    info.update(_power_limit())
    return info


def _power_limit() -> dict:
    """The card's power limit as ``nvidia-smi`` reads it (a card set below
    700 W runs slower under load)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return {"power_limit_w": float(out[0])}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux:
    from ``/proc/self/stat``; elsewhere the time of this call)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


def main(argv=None) -> int:
    import argparse

    t_start = process_start()
    ap = argparse.ArgumentParser(
        description="Run one cell of the altair_tpu_torch benchmark once "
                    "and print its result as one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    root = Path.cwd()
    cell = load_cell(root, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one host thread for torch's own CPU work: spare threads of the
    # intra-op pool contend with the eager loops' dispatch thread
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start=t_start)
    found = forbidden_modules()
    if found:
        print("portbench: the process holds " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, line in result["checks"].items():
        print(f"check {name}: {line['value']} (limit {line['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def finite(x):
    """``x``, or None where it is not a finite number (JSON has no
    infinity)."""
    return x if x is None or math.isfinite(x) else None
