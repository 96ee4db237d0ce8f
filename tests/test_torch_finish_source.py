"""The thick-rim route of ``trace_rays_auto`` on the CPU: rays traced from
the source with the in-loop exact-rim physics by one call of the finish
kernel (``trace_cuda.trace_rays_finish``; its plain version here), against
the JAX package's in-loop exact-rim ``trace_rays``; the scenes that take
the route and those that keep their loops; the cap; and the in-sphere
sweep's laps (``stats=``), spans and counter.  The CUDA kernel is held
against ``finish_plain`` on these entry states on the card
(``tests/test_torch_finish_cuda.py``)."""

import functools

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from altair_tpu.config import SCENE_INSPHERE, SOURCE_DEMO
from altair_tpu.core.trace import trace_rays as j_trace
from altair_tpu_torch import TraceConfig, convert, trace_rays_auto
from altair_tpu_torch.core import route as route_mod
from altair_tpu_torch.core import trace as trace_mod, trace_cuda
from altair_tpu_torch.core.trace import EXITED, RUNNING, SUSPENDED
from altair_tpu_torch.io import profiling
from altair_tpu_torch.sweep import sweep_insphere_detector

torch.set_num_threads(1)

N = 8192
# the macro's thick shell (100.1-105 cm, reflectance 1), its bounce cap
# cut so that the CPU loops stay cheap (a few percent of the rays reach it)
SCENE = SCENE_INSPHERE.with_(max_bounces=512)
R_IN = float(SCENE.inner_radius)
EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 513)


def _classes(status, last, seg, bounces):
    """Per ray, the fractions compared with JAX: port exits (segment from
    the inner sphere or the source), rim exits (from the rim face, out of
    the gap), suspended rays, and the bounce-count histogram."""
    st = np.asarray(status)
    r_seg = np.linalg.norm(np.asarray(seg), axis=1)
    ex = st == EXITED
    out = {"exit": ex, "port_exit": ex & (r_seg <= R_IN + 1e-3),
           "rim_exit": ex & (r_seg > R_IN + 1e-3),
           "suspended": st == SUSPENDED}
    b = np.asarray(bounces)
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        out[f"bounces[{lo},{hi})"] = (b >= lo) & (b < hi)
    return out


@functools.cache
def _jax_in_loop():
    """JAX's in-loop exact-rim trace of N rays: the classes and the exit
    directions' z components."""
    jr = j_trace(jax.random.key(21), SCENE, SOURCE_DEMO, N)
    cls = _classes(jr.status, np.asarray(jr.last_point.stack()),
                   np.asarray(jr.seg_start.stack()), jr.n_bounces)
    ex = np.asarray(jr.status) == EXITED
    return cls, np.asarray(jr.direction.z)[ex]


def _spy_finish(monkeypatch):
    calls = []
    real = trace_cuda.finish

    def spy(seed, scene_vec, rim_vec, state, model, max_iters, exact_rim,
            **kw):
        calls.append({"n": state[3].shape[0], "exact_rim": exact_rim,
                      "max_iters": max_iters, **kw})
        return real(seed, scene_vec, rim_vec, state, model, max_iters,
                    exact_rim, **kw)

    monkeypatch.setattr(trace_cuda, "finish", spy)
    return calls


def test_source_route_matches_jax_in_loop(monkeypatch):
    """Exit fraction, port and rim exits, suspended rays and every bin of
    the bounce histogram within 4 sigma of JAX's in-loop exact-rim trace,
    and the exit directions' z within the two-sample KS test at 1e-4
    (independent streams); one finish call over the whole batch; no
    overflow; no ray left running."""
    calls = _spy_finish(monkeypatch)
    res, ovf = trace_rays_auto(torch.Generator().manual_seed(5),
                               convert.scene(SCENE),
                               convert.source(SOURCE_DEMO), N, TraceConfig(),
                               device="cpu")
    assert calls == [{"n": N, "exact_rim": True, "max_iters": 512,
                      "entry": "source"}]
    assert int(ovf) == 0 and int(ovf.grouped_drops) == 0
    st = res.status.numpy()
    assert not (st == RUNNING).any()
    ref, ref_dz = _jax_in_loop()
    cls = _classes(st, res.last_point.stack().numpy(),
                   res.seg_start.stack().numpy(), res.n_bounces.numpy())
    assert cls["rim_exit"].any() and cls["suspended"].any()
    for name, v in cls.items():
        f_j, f_p = ref[name].mean(), v.mean()
        sigma = np.sqrt(2 * max(f_j * (1 - f_j), 1.0 / N) / N)
        assert abs(f_p - f_j) < 4 * sigma, (name, f_p, f_j)
    dz = res.direction.z.numpy()[st == EXITED]
    assert ks_2samp(dz, ref_dz).pvalue > 1e-4


def _callable_law(gen, incident, normal, scene):
    from altair_tpu_torch.core.sampling import cosine_hemisphere

    return cosine_hemisphere(gen, normal)


@pytest.mark.parametrize("case,route", [
    ("float32", "finish"), ("engine_simulate", "finish"),
    ("float64", "eager"), ("history", "eager"), ("callable", "eager")])
def test_route_is_chosen_by_the_scene(monkeypatch, case, route):
    """A thick rim under a static law in float32 and without history
    takes the route (``route="finish"``, one finish call from the source,
    whatever the engine); float64, path history and a scatter callable
    keep the eager in-loop trace and never call the finish."""
    scene = convert.scene(SCENE.with_(max_bounces=64))
    cfg = TraceConfig()
    if case == "engine_simulate":
        cfg = TraceConfig(engine="simulate")
    elif case == "float64":
        cfg = TraceConfig(dtype=torch.float64)
    elif case == "history":
        cfg = TraceConfig(keep_history=4)
    elif case == "callable":
        scene = scene.with_(surface_model=_callable_law)
    assert trace_mod.rim_deferred_capacity_shift(scene) is None
    assert route_mod.plan([scene], cfg, 256) == (route, None, None)
    calls = _spy_finish(monkeypatch)
    profiling.clear()
    with profiling.tracing():
        res, ovf = trace_rays_auto(torch.Generator().manual_seed(2), scene,
                                   convert.source(SOURCE_DEMO), 256, cfg,
                                   device="cpu")
    spans = profiling.records()["spans"]
    profiling.clear()
    (top,) = [s for s in spans if s["name"] == "trace"]
    assert top["attrs"]["route"] == route
    assert int(ovf) == 0 and not bool((res.status == RUNNING).any())
    loops = [s["name"] for s in spans if s["name"].startswith("loop.")]
    if route == "finish":
        assert calls == [{"n": 256, "exact_rim": True, "max_iters": 64,
                          "entry": "source"}]
        assert loops == []
    else:
        assert calls == [] and loops == ["loop.eager"]


def test_thin_rims_keep_their_routes():
    """A rim the deferred post-pass takes, or no exact rim at all, is no
    thick rim: such scenes do not take the route, whatever the engine."""
    from altair_tpu.config import SCENE_OPTIMIZE

    thin = convert.scene(SCENE_OPTIMIZE)
    assert trace_mod.rim_deferred_capacity_shift(thin) is not None
    for scene in (thin, convert.scene(SCENE.with_(exact_rim=False))):
        for engine in ("auto", "simulate"):
            assert route_mod.plan([scene], TraceConfig(engine=engine),
                                  256).main != "finish"


def test_lanes_at_the_cap_come_back_suspended():
    """At a cap of 12 steps the lanes still running come back SUSPENDED
    with at most 12 bounces, and they are exactly the rays that the same
    key traces past 12 steps with the whole cap (a lane's draws are keyed
    by its lane and step); no overflow."""
    src = convert.source(SOURCE_DEMO)

    def run(cap):
        return trace_rays_auto(torch.Generator().manual_seed(8),
                               convert.scene(SCENE.with_(max_bounces=cap)),
                               src, 2048, TraceConfig(), device="cpu")

    short, ovf = run(12)
    full, _ = run(512)
    assert int(ovf) == 0 and int(ovf.grouped_drops) == 0
    st = short.status
    assert (st == SUSPENDED).any() and not (st == RUNNING).any()
    assert int(short.n_bounces.max()) <= 12
    # steps a finished ray took: its bounces, plus one for the exit flight
    # and one for each re-entry from the gap (at most the bounces again)
    done = st != SUSPENDED
    assert torch.equal(full.status[done], st[done])
    assert torch.equal(full.n_bounces[done], short.n_bounces[done])
    assert (full.n_bounces[~done] >= short.n_bounces[~done]).all()
    assert int((full.n_bounces[~done] > 12).sum()) > 0


@pytest.mark.parametrize("retrace", [True, False])
def test_sweep_stats_change_no_result(retrace):
    """``sweep_insphere_detector(stats={})`` gives the fractions of
    ``stats=None`` for one seed, one trace lap and one score lap per
    traced batch (ordered, each batch's rays and bounce sum), the span
    ``sweep.insphere`` over a ``trace`` (route ``finish``) and a
    ``score.insphere`` per batch, and ``insphere.disk_tests`` counting
    the ray-disk pairs."""
    scene = convert.scene(SCENE.with_(max_bounces=256))
    kw = dict(device="cpu", n_rays=400, dtheta=15.0, theta_max=45.0,
              disk_radius=30.0, seed=4, save_path=None, retrace=retrace)
    plain = sweep_insphere_detector(scene, convert.source(SOURCE_DEMO), **kw)
    stats = {}
    profiling.clear()
    with profiling.tracing():
        timed = sweep_insphere_detector(scene, convert.source(SOURCE_DEMO),
                                        stats=stats, **kw)
    rec = profiling.records()
    profiling.clear()
    np.testing.assert_array_equal(timed.fractions, plain.fractions)
    assert timed.fractions.sum() > 0
    P = 14
    batches = 2 if retrace else 1
    rays = 8 * 400 if retrace else 400
    assert set(stats) == {"trace", "score"}
    assert len(stats["trace"]) == len(stats["score"]) == batches
    last = 0.0
    for tr, sc in zip(stats["trace"], stats["score"]):
        assert last <= tr["start"] <= tr["end"] == sc["start"] <= sc["end"]
        last = sc["end"]
        assert tr["rays"] == sc["rays"] == rays
        assert isinstance(tr["bounce_steps"], int)
        assert tr["bounce_steps"] > rays
        assert sc["disks"] == (8 if retrace else P)
    (top,) = [s for s in rec["spans"] if s["name"] == "sweep.insphere"]
    assert top["attrs"] == {"positions": P, "n_rays": 400,
                            "retrace": retrace, "chunks": batches}
    kids = [s for s in rec["spans"] if s["parent"] == top["id"]]
    assert [s["name"] for s in kids] == ["trace", "score.insphere"] * batches
    assert all(s["attrs"]["route"] == "finish" for s in kids
               if s["name"] == "trace")
    assert rec["totals"]["insphere.disk_tests"] == (
        batches * rays if retrace else rays * P)
