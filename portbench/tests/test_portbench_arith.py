"""The benchmark's arithmetic on hand-made inputs."""

import math

import pytest

from portbench import arith, profiling
from portbench.harness import Run, forbidden_modules, metric_reader


def jobs(walls, ok=None):
    out, t = [], 100.0
    for i, w in enumerate(walls):
        out.append((t, t + w, True if ok is None else ok[i], 1000))
        t += w
    return out


def run_of(walls, ok=None, **kw):
    return Run({"traffic_data": {"rays": 1000}}, 12.5, jobs(walls, ok), **kw)


def test_map_s_is_window_over_completed_maps():
    r = run_of([0.5, 0.25, 0.75, 0.5], ok=[True, True, False, True])
    assert metric_reader("map_s").read(r) == pytest.approx(2.0 / 3)


def test_rays_per_s_counts_completed_jobs_over_the_window():
    r = run_of([1.0, 1.0, 2.0], ok=[True, False, True])
    assert metric_reader("rays_per_s").read(r) == pytest.approx(2000 / 4.0)
    assert metric_reader("setup_s").read(r) == 12.5


def test_idle_share_from_synthetic_intervals():
    busy = arith.merge([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.5, 11.0)])
    assert busy == [(0.0, 2.0), (3.0, 4.0), (9.5, 11.0)]
    assert arith.covered(busy, 1.0, 10.0) == pytest.approx(2.5)
    assert arith.idle_pct(2.5, 9.0) == pytest.approx(100 * (1 - 2.5 / 9))
    r = run_of([10.0], busy=busy, profiled=(0.0, 10.0))
    assert metric_reader("device_idle_pct.map").read(r) == pytest.approx(65.0)
    assert arith.gaps(busy, 1.0, 10.0) == [(2.0, 3.0, 0), (4.0, 9.5, 1)]


def test_least_time_and_the_bound_that_binds():
    t, bound = arith.least_time(67e12, 1e9)
    assert t == pytest.approx(1.0) and bound == "compute"
    t, bound = arith.least_time(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and bound == "memory"
    pct, bound = arith.roofline_pct(6.7e12, 0.0, 0.2)
    assert pct == pytest.approx(50.0) and bound == "compute"


def test_roofline_readers_count_the_frozen_work():
    busy = [(0.0, 0.001)]
    spans = [["trace", 0, 0.0, 0.01, {"bounce_steps": 10_000_000}],
             ["score", 0, 0.02, 0.03, {"pairs": 1_000_000}]]
    cell = {"traffic_data": {"rays": 1000},
            "config_data": {"scene": {"surface_model": "MIXED_BRDF"},
                            "grid": {"n_theta": 10, "n_phi": 10}}}
    r = Run(cell, 1.0, jobs([0.05]), spans, busy, (0.0, 0.05))
    flops = 10_000_000 * 114.2
    assert metric_reader("trace_roofline_pct.trace").read(r) == pytest.approx(
        100 * (flops / 67e12) / 0.001)
    assert metric_reader("trace_roofline_pct.map").read(r) == pytest.approx(
        100 * (flops / 67e12) / 0.001)
    # no device time inside the score span: nothing to read
    assert metric_reader("score_roofline_pct.map").read(r) is None
    r.busy = [(0.0, 0.001), (0.02, 0.021)]
    assert metric_reader("score_roofline_pct.map").read(r) == pytest.approx(
        100 * (35e6 / 67e12) / 0.001)


def test_span_means_skip_the_profiled_stretch():
    spans = [["trace", 0, 0.0, 0.2, {}], ["trace", 1, 1.0, 1.4, {}],
             ["score", 1, 1.4, 1.5, {}], ["trace", 2, 2.0, 2.9, {}]]
    r = run_of([1.0], spans=spans, busy=[], profiled=(2.0, 3.0))
    assert metric_reader("trace_ms.map").read(r) == pytest.approx(300.0)
    assert metric_reader("score_ms.map").read(r) == pytest.approx(100.0)


def test_breakdown_names_gaps_by_span():
    kernels = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k3", 3.0, 4.0),
               ("k1", 6.0, 6.5)]
    busy = arith.merge((s, e) for _, s, e in kernels)
    spans = [["trace", 0, 0.0, 4.5, {}], ["score", 0, 4.5, 7.0, {}]]
    b = profiling.breakdown(busy, kernels, spans, 0.0, 8.0)
    assert b["device_ops"] == [["k1", 1.5], ["k2", 1.5], ["k3", 1.0]]
    assert b["idle_gaps"] == [["score after k3", 2.0],
                              ["between_jobs after k1", 1.5],
                              ["trace after k2", 1.0]]


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules({"jax.numpy": 1, "jaxlib": 1,
                              "altair_tpu.core": 1}) == [
        "altair_tpu", "jax", "jaxlib"]
    assert forbidden_modules({"altair_tpu_torch": 1,
                              "altair_tpu_torch.core": 1, "jaxtyping": 1,
                              "benchmark_utils": 1}) == []
    assert math.isfinite(arith.PEAK_FLOPS)


def test_job_pool_runs_the_same_jobs_in_an_order_the_seed_draws():
    from portbench.harness import POOL_SEED, job_keys

    pooled = {"traffic_data": {"job_pool": 4}}
    a = [job_keys(pooled, 11)(i) for i in range(9)]
    b = [job_keys(pooled, 12)(i) for i in range(9)]
    assert sorted(k for k, _ in a[:4]) == sorted(k for k, _ in b[:4])
    assert {k[0] for k, _ in a} == {POOL_SEED}
    assert [k for k, _ in a[4:8]] == [k for k, _ in a[:4]]   # cycling
    assert [r for _, r in a] == [False] * 4 + [True] * 5
    assert a == [job_keys(pooled, 11)(i) for i in range(9)]
    free = job_keys({"traffic_data": {}}, 11)
    assert [free(i) for i in range(3)] == [((11, i), False) for i in range(3)]
