"""The readers of the program's tracer records (``portbench.program_trace``)
and the breakdown's labels, on synthetic records: two jobs in the window,
one profiled, each a ``trace`` root with its stages."""

import pytest

from portbench import program_trace as P
from portbench.harness import Run, metric_reader
from portbench.profiling import breakdown

NS = 10 ** 9


def _span(i, name, parent, root, start, end, **attrs):
    return {"id": i, "name": name, "parent": parent, "root": root,
            "start_ns": int(start * NS), "end_ns": int(end * NS),
            "attrs": attrs}


def _job(base, first_id, rim=(0.4, 0.8), cont=(0.5, 0.8)):
    """A job's program spans from host second ``base``: ``trace`` over
    [0.1, 0.9], ``trace.main`` [0.1, 0.4] with ``trace.straggler``
    [0.3, 0.4], ``trace.rim`` and ``trace.rim.cont``."""
    r = first_id
    return [_span(r, "trace", None, r, base + 0.1, base + 0.9),
            _span(r + 1, "trace.main", r, r, base + 0.1, base + 0.4),
            _span(r + 2, "trace.straggler", r + 1, r, base + 0.3,
                  base + 0.4),
            _span(r + 3, "trace.rim", r, r, base + rim[0], base + rim[1]),
            _span(r + 4, "trace.rim.cont", r + 3, r, base + cont[0],
                  base + cont[1], kind="waves")]


@pytest.fixture
def traced():
    """Jobs [0, 1] and [1, 2] in the window, [2, 3] profiled; the device
    busy in the profiled job over [2.1, 2.5] and [2.7, 2.75]."""
    jobs = [(0.0, 1.0, True, 10), (1.0, 2.0, True, 10), (2.0, 3.0, True, 10)]
    bench = [["trace", i, i + 0.05, i + 0.95, {}] for i in range(3)]
    run = Run({"per_layer": []}, 1.0, jobs, bench)
    run.busy = [(2.1, 2.5), (2.7, 2.75)]
    run.profiled = (2.0, 3.0)
    spans = (_job(0.0, 1)
             + _job(1.0, 11, rim=(0.4, 0.6), cont=(0.45, 0.6))
             + _job(2.0, 21))
    records = {"spans": sorted(spans, key=lambda s: s["start_ns"]),
               "counters": {},
               "totals": {"host_syncs": 60, "lane_steps_issued": 1000,
                          "lane_steps_live": 250}}
    return run, records


@pytest.mark.parametrize("metric", ["rim_ms.map", "rim_ms.trace"])
def test_rim_ms_is_the_mean_rim_time_of_the_unprofiled_jobs(traced,
                                                            metric):
    run, records = traced
    assert P.stage_ms(run, records, "trace.rim") == pytest.approx(300.0)


@pytest.mark.parametrize("metric", ["straggler_ms.trace"])
def test_straggler_ms(traced, metric):
    run, records = traced
    assert P.stage_ms(run, records, "trace.straggler") == pytest.approx(
        100.0)
    assert P.stage_ms(run, records, "trace.nothing") is None


@pytest.mark.parametrize("metric", ["host_syncs.map", "host_syncs.trace"])
def test_host_syncs_per_job_counts_the_warm_job(traced, metric):
    run, records = traced
    assert P.host_syncs_per_job(run, records) == 15.0
    assert P.host_syncs_per_job(run, {"spans": [], "counters": {},
                                      "totals": {}}) is None


@pytest.mark.parametrize("metric", ["host_syncs.map", "host_syncs.trace"])
def test_host_syncs_metric_reads_the_program_or_nothing(traced, metric,
                                                        monkeypatch):
    """The metric file reads the program's own process totals, and reads
    nothing from a program without the tracer (the parent's)."""
    run, records = traced
    reader = metric_reader(metric)
    monkeypatch.setattr(P, "program_records", lambda: records)
    assert reader.read(run) == 15.0
    monkeypatch.setattr(P, "program_records", lambda: None)
    assert reader.read(run) is None


def test_host_syncs_metric_reads_the_live_tracer(traced):
    from altair_tpu_torch.io import profiling

    run, _ = traced
    profiling.clear()
    try:
        for _ in range(8):
            profiling.count("host_syncs")
        assert metric_reader("host_syncs.map").read(run) == 2.0
    finally:
        profiling.clear()


@pytest.mark.parametrize("metric",
                         ["lane_use_pct.map", "lane_use_pct.trace"])
def test_lane_use_pct(traced, metric):
    _, records = traced
    assert P.lane_use_pct(records) == 25.0
    assert P.lane_use_pct({"totals": {"lane_steps_issued": 10}}) is None
    assert P.lane_use_pct(None) is None


@pytest.mark.parametrize("metric",
                         ["rim_idle_pct.map", "rim_idle_pct.trace"])
def test_rim_idle_pct_is_the_idle_share_inside_the_profiled_rim(traced,
                                                                metric):
    run, records = traced
    # trace.rim of the profiled job: [2.4, 2.8], busy [2.4, 2.5] and
    # [2.7, 2.75]: 0.15 of 0.4 s
    assert P.idle_pct_in(run, records, "trace.rim") == pytest.approx(62.5)
    run.busy = None
    assert P.idle_pct_in(run, records, "trace.rim") is None


def test_breakdown_label_names_the_innermost_program_span(traced):
    run, records = traced
    kernels = [("void bounce_kernel<0, false>", 2.1, 2.5),
               ("FillFunctor", 2.7, 2.75)]
    spans = P.labelled_spans(run.spans, records)
    gaps = dict(breakdown(run.busy, kernels, spans, *run.profiled)
                ["idle_gaps"])
    # [2.0, 2.1]: before the program's trace span; [2.5, 2.7]: inside
    # trace.rim.cont; [2.75, 3.0]: in trace, after its children
    assert gaps == pytest.approx({
        "trace": 0.1, "trace/trace.rim.cont after bounce_kernel<0, false>":
        0.2, "trace/trace after FillFunctor": 0.25})
    # without program records the labels are the benchmark's own
    plain = dict(breakdown(run.busy, kernels,
                           P.labelled_spans(run.spans, None),
                           *run.profiled)["idle_gaps"])
    assert plain == pytest.approx({
        "trace": 0.1, "trace after bounce_kernel<0, false>": 0.2,
        "trace after FillFunctor": 0.25})


def test_clock_and_cover_checks(traced):
    run, records = traced
    records["spans"].append(_span(40, "kernel.bounce", 22, 21, 2.11, 2.12,
                                  n=10))
    kernels = [("void bounce_kernel<0, false>", 2.125, 2.5),
               ("void bounce_kernel<0, false>", 2.105, 2.5),
               ("void refill_kernel<0, true>", 2.2, 2.5)]
    # each kernel against the bounce span that starts nearest; no refill
    # span, no offset
    assert P.kernel_offsets(kernels, records, 2.0, 3.0) == [
        pytest.approx((0.015, 0.005)), pytest.approx((-0.005, -0.015))]
    assert P.kernel_offsets(kernels, records, 1.0, 2.0) == []
    assert P.child_cover(records) == pytest.approx(0.5 / 0.8)
    smallest, median = P.bench_cover(run.spans, records)
    assert (smallest, median) == pytest.approx((0.8 / 0.9, 0.8 / 0.9))
