"""The port's tracer (``altair_tpu_torch.io.profiling``): spans, their ids
and nesting, the counters, what tracing costs when off, and the span sites
of the trace path on small CPU traces."""

import collections
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel,
                              TraceConfig, trace_rays_auto)
from altair_tpu_torch.core import route as route_mod, trace as T
from altair_tpu_torch.io import profiling

torch.set_num_threads(1)

# the waves tracer (float64 rules out the kernels and the direct sampler)
# for the main trace, then the eager rim continuation: one loop.waves, two
# loop.eager
WAVES_SCENE = SCENE_OPTIMIZE.with_(max_bounces=300)
WAVES_CFG = TraceConfig(dtype=torch.float64, block_iters=16,
                        engine="simulate")


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.clear()
    yield
    profiling.clear()


def _spans(name=None):
    return [s for s in profiling.records()["spans"]
            if name is None or s["name"] == name]


def _waves_trace(monkeypatch):
    monkeypatch.setattr(route_mod, "WAVES_MIN", 512)
    return trace_rays_auto(torch.Generator().manual_seed(3), WAVES_SCENE,
                           SOURCE_OVERNIGHT, 1024, WAVES_CFG, device="cpu")


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_span_nesting_parent_and_root_ids():
    with profiling.tracing():
        with profiling.span("a", k=1) as a:
            with profiling.span("b"):
                with profiling.span("c") as c:
                    c.set(late=2)
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    s = {x["name"]: x for x in _spans()}
    assert [x["name"] for x in _spans()] == ["a", "b", "c", "d", "e"]
    assert s["a"]["parent"] is None and s["a"]["root"] == s["a"]["id"] == a.id
    assert s["b"]["parent"] == s["d"]["parent"] == s["a"]["id"]
    assert s["c"]["parent"] == s["b"]["id"]
    assert {s[n]["root"] for n in "abcd"} == {s["a"]["id"]}
    assert s["e"]["parent"] is None and s["e"]["root"] == s["e"]["id"]
    assert len({x["id"] for x in s.values()}) == 5
    assert s["a"]["attrs"] == {"k": 1} and s["c"]["attrs"] == {"late": 2}
    for x in s.values():
        assert x["start_ns"] <= x["end_ns"]
    assert s["a"]["start_ns"] <= s["b"]["start_ns"] <= s["c"]["start_ns"]
    assert s["c"]["end_ns"] <= s["b"]["end_ns"] <= s["a"]["end_ns"]


def test_counters_per_root_and_process_totals():
    profiling.count("x", 2)                  # tracing off: totals only
    with profiling.tracing():
        with profiling.span("r1") as r1:
            profiling.count("x")
            with profiling.span("child"):
                profiling.count("x", 3)
                profiling.count("y", torch.tensor(5))   # read lazily
        with profiling.span("r2") as r2:
            profiling.count("x")
        profiling.count("x")                 # on, outside any span
    rec = profiling.records()
    assert rec["totals"] == {"x": 8, "y": 5}
    assert rec["counters"] == {r1.id: {"x": 4, "y": 5}, r2.id: {"x": 1},
                               None: {"x": 1}}
    profiling.clear()
    assert profiling.records() == {"spans": [], "counters": {}, "totals": {}}


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    calls = []
    real = profiling.time.perf_counter_ns
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: calls.append(1) or real())
    with profiling.span("outside") as sp:
        sp.set(a=1)
    assert not sp.on
    res, rim = _waves_trace(monkeypatch)
    rec = profiling.records()
    assert calls == [] and rec["spans"] == [] and rec["counters"] == {}
    # the always-on counters still count
    assert rec["totals"]["host_syncs"] > 0
    assert "lane_steps_live" not in rec["totals"]


def test_tracing_adds_only_the_documented_lane_ops(monkeypatch):
    """The aten ops of a small trace with tracing on, less the lane-use
    ops, are the ops with tracing off, and the results are equal.  The
    lane-use ops: per loop step a compare and an add; per ``loop.eager`` a
    ``zeros_like`` and a ``sum``; per ``loop.waves`` a ``zeros_like`` a
    wave, a ``cat`` and a ``sum``."""
    with _AtenOps() as off:
        res_off, _ = _waves_trace(monkeypatch)
    with profiling.tracing(), _AtenOps() as on:
        res_on, _ = _waves_trace(monkeypatch)
    eager, waves = _spans("loop.eager"), _spans("loop.waves")
    assert len(eager) == 2 and len(waves) == 1
    steps = (sum(s["attrs"]["iterations"] for s in eager)
             + sum(it for s in waves for _, it in s["attrs"]["waves"]))
    n_waves = sum(len(s["attrs"]["waves"]) for s in waves)
    want = collections.Counter({
        "aten.eq.Scalar": steps, "aten.add_.Tensor": steps,
        "aten.zeros_like.default": len(eager) + n_waves,
        "aten.sum.default": len(eager) + len(waves),
        "aten.cat.default": len(waves)})
    assert on.ops - off.ops == want and off.ops - on.ops == {}
    for f in ("status", "n_bounces"):
        assert torch.equal(getattr(res_on, f), getattr(res_off, f))
    for f in ("last_point", "seg_start", "direction"):
        assert torch.equal(getattr(res_on, f).stack(),
                           getattr(res_off, f).stack())


def _counting_step(scene, n, cfg, running):
    step = T.make_bounce_step(torch.Generator().manual_seed(9), scene, n,
                              cfg, "cpu")
    max_iters = int(scene.max_bounces)

    def counted(it, carry):
        if it < max_iters:
            running.append(int((carry[3] == T.RUNNING).sum()))
        return step(it, carry)

    return counted


@pytest.mark.parametrize("exact_rim", [False, True])
def test_lane_steps_live_is_the_per_step_count_of_running_lanes(exact_rim):
    scene = SCENE_OPTIMIZE.with_(max_bounces=200, exact_rim=exact_rim)
    cfg, n = TraceConfig(block_iters=8), 512
    pos, d = T._source_rays(SOURCE_OVERNIGHT, n, torch.float32, "cpu")
    zeros = torch.zeros((n,), dtype=torch.int32)
    carry = (pos, d, pos, zeros, zeros, torch.zeros((n,), dtype=torch.bool))
    running = []
    step = _counting_step(scene, n, cfg, running)
    with profiling.tracing():
        T._while_trace(step, carry, 200, 8)
    (loop,) = _spans("loop.eager")
    tot = profiling.records()["totals"]
    assert loop["attrs"]["iterations"] == len(running) > 0
    assert tot["lane_steps_live"] == sum(running)
    assert tot["lane_steps_issued"] == n * len(running)


@pytest.mark.parametrize("max_bounces,block",
                         [(1000, 16), (40, 16), (48, 16)])
def test_host_syncs_are_the_alive_checks(max_bounces, block):
    """An eager trace reads the device once per alive check: one before
    each block, and one more that finds every lane dead unless the loop
    stopped at the cap."""
    scene = SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False)
    cfg = TraceConfig(block_iters=block)
    with profiling.tracing():
        T.trace_rays(torch.Generator().manual_seed(5), scene,
                     SOURCE_OVERNIGHT, 1024, cfg, device="cpu")
    (loop,) = _spans("loop.eager")
    its = loop["attrs"]["iterations"]
    checks = math.ceil(its / block) + (its < max_bounces)
    assert profiling.records()["totals"]["host_syncs"] == checks
    assert (its < max_bounces) == (max_bounces == 1000)


@pytest.mark.parametrize("route,scene,cfg", [
    ("direct", SCENE_OPTIMIZE.with_(max_bounces=1000), TraceConfig()),
    ("bounce", SCENE_OPTIMIZE.with_(max_bounces=300,
                                    surface_model=SurfaceModel.MIXED_BRDF),
     TraceConfig(engine="simulate"))])
def test_trace_children_cover_its_host_time(route, scene, cfg):
    with profiling.tracing():
        trace_rays_auto(torch.Generator().manual_seed(2), scene,
                        SOURCE_OVERNIGHT, 4096, cfg, device="cpu")
    spans = _spans()
    (top,) = [s for s in spans if s["name"] == "trace"]
    assert top["attrs"] == {"n_rays": 4096, "route": route}
    kids = [s for s in spans if s["parent"] == top["id"]]
    assert [s["name"] for s in kids] == ["trace.main", "trace.rim"]
    covered = sum(s["end_ns"] - s["start_ns"] for s in kids)
    assert covered >= 0.95 * (top["end_ns"] - top["start_ns"])
    (cont,) = [s for s in spans if s["name"] == "trace.rim.cont"]
    assert cont["attrs"]["kind"] == ("hybrid" if route == "direct"
                                     else "kernel")
    assert cont["parent"] == kids[1]["id"]
    assert all(s["root"] == top["id"] for s in spans)


def test_score_and_binomial_spans():
    from altair_tpu_torch import DetectorGrid
    from altair_tpu_torch.core.score import fluxmap_retrace_binomial

    grid = DetectorGrid(n_theta=6, n_phi=3)
    stats = {}
    with profiling.tracing():
        fluxmap_retrace_binomial(torch.Generator().manual_seed(1),
                                 SCENE_OPTIMIZE.with_(max_bounces=500),
                                 SOURCE_OVERNIGHT, grid, 200, oversample=4,
                                 pos_chunk=5, device="cpu", stats=stats)
    spans = _spans()
    (top,) = [s for s in spans if s["parent"] is None]
    assert top["name"] == "map.binomial"
    assert [s["name"] for s in spans if s["parent"] == top["id"]] == [
        "trace", "score", "score.draw"]
    (score,) = [s for s in spans if s["name"] == "score"]
    assert score["attrs"]["positions"] == 18 and score["attrs"]["chunks"] == 4
    assert set(stats) == {"trace_s", "score_s", "draw_s",
                          "compaction_overflow"}
    counters = profiling.records()["counters"][top["id"]]
    assert counters["host_syncs"] >= 2          # the overflow reads


def test_a_span_labels_a_running_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing(), profiling.span("labelled"):
            torch.ones(4).sum()
        with profiling.span("untraced"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "labelled" in names and "untraced" not in names
