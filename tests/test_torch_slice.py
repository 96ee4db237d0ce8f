"""Port parity for the whole trace-once flux-map slice: ``trace_rays_auto``
+ ``fluxmap_trace_once_compact`` for both engines (and the simulate
engine's large-batch path, at a small size with its thresholds lowered),
the CSV of ``sweep_detector_trace_once``, and the package's independence
from JAX."""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import altair_tpu_torch as T
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid, TraceConfig
from altair_tpu.core.score import exit_capacity, fluxmap_trace_once_compact as j_score
from altair_tpu.core.trace_waves import trace_rays_auto as j_auto
from altair_tpu.sweep.observer import sweep_detector_trace_once as j_sweep
from altair_tpu_torch import convert
from altair_tpu_torch.core import route, trace as trace_mod, trace_cuda
from altair_tpu_torch.core.geometry import detector_position, line_hits_disk
from altair_tpu_torch.core.score import fluxmap_trace_once_compact as t_score
from altair_tpu_torch.sweep import sweep_detector_trace_once as t_sweep

torch.set_num_threads(1)

N = 32_768
SCENE = SCENE_OPTIMIZE.with_(max_bounces=256)
GRID = DetectorGrid(n_theta=18, n_phi=9)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hits_per_ray(res, grid):
    """[N] count of grid positions each ray's final segment hits: the
    summands of the map total, for its standard error."""
    th = grid.theta_centers().repeat_interleave(grid.n_phi)
    ph = grid.phi_centers().repeat(grid.n_theta)
    c, n = detector_position(th, ph, grid.radius, -100.0)
    mask = res.exited_port_mask()
    lp = res.last_point
    d = res.direction
    col = lambda v: v[:, None]
    row = lambda v: v[None, :]
    hit = line_hits_disk(type(lp)(col(lp.x), col(lp.y), col(lp.z)),
                         type(d)(col(d.x), col(d.y), col(d.z)),
                         type(c)(row(c.x), row(c.y), row(c.z)),
                         type(n)(row(n.x), row(n.y), row(n.z)),
                         grid.width / 2.0)
    return (hit & mask[:, None]).sum(1).double().numpy()


@functools.cache
def _jax_slice(engine, scene=SCENE, n=N):
    """JAX's trace_rays_auto + the compacting scorer: ``(result, counts,
    score overflow)``, cached per configuration."""
    jr = j_auto(jax.random.key(9), scene, SOURCE_OVERNIGHT, n,
                TraceConfig(engine=engine))
    jc, jo = j_score(jr, GRID, exit_capacity(scene, n), scene.exit_port_z)
    return jr, jc, int(jo)


def _assert_slice_matches_jax(engine, seed, scene=SCENE, n=N):
    """The port's trace_rays_auto + scorer against JAX's: exit fraction
    and map total within 4 sigma (independent streams), zero compaction
    and rim overflow."""
    jr, jc, jo = _jax_slice(engine, scene, n)
    tr, rim_ovf = T.trace_rays_auto(
        torch.Generator().manual_seed(seed), convert.scene(scene),
        convert.source(SOURCE_OVERNIGHT), n, T.TraceConfig(engine=engine),
        device="cpu")
    tc, to = t_score(tr, convert.grid(GRID), exit_capacity(scene, n),
                     scene.exit_port_z)
    assert jo == int(to) == int(rim_ovf) == 0

    f_j = float(jr.exited_port_mask().sum()) / n
    f_t = float(tr.exited_port_mask().sum()) / n
    assert abs(f_t - f_j) < 4 * np.sqrt(2 * f_j * (1 - f_j) / n), (f_t, f_j)

    h = _hits_per_ray(tr, convert.grid(GRID))
    assert h.sum() == int(tc.sum())            # the scorer counts the same
    sigma_total = np.sqrt(2 * n * h.var())
    assert abs(int(tc.sum()) - int(np.asarray(jc).sum())) < 4 * sigma_total


@pytest.mark.parametrize("engine", ["auto", "simulate"])
def test_slice_matches_jax(engine):
    """Exit fraction and map total within 4 sigma of JAX's (independent
    streams), zero compaction and rim overflow."""
    _assert_slice_matches_jax(engine, 9)


def test_large_batch_simulate_matches_jax(monkeypatch):
    """The large-batch simulate path at a small size: with REFILL_MIN
    lowered, the main trace runs the refill kernel (its plain version here)
    with the tail handoff, its stragglers and the rim continuation each run
    one finish (the finish kernel's plain version here), and the result
    matches JAX's simulate engine within 4 sigma with zero overflow."""
    calls = {"refill_plain": 0, "finish": []}
    real_plain = trace_cuda.refill_plain
    real_finish = trace_cuda.finish

    def spy_plain(*a, **k):
        calls["refill_plain"] += 1
        return real_plain(*a, **k)

    def spy_finish(seed, scene_vec, rim_vec, state, model, max_iters,
                   exact_rim):
        calls["finish"].append((state[0].x.shape[0], bool(exact_rim)))
        return real_finish(seed, scene_vec, rim_vec, state, model,
                           max_iters, exact_rim)

    monkeypatch.setattr(trace_cuda, "refill_plain", spy_plain)
    monkeypatch.setattr(trace_cuda, "finish", spy_finish)
    monkeypatch.setattr(trace_cuda, "REFILL_MIN", 1024)
    _assert_slice_matches_jax("simulate", 19)
    assert calls["refill_plain"] == 1
    # the handoff's stragglers (simple mode), then the rim continuation
    # at N >> 4 lanes (exact rim)
    lanes = trace_cuda.REFILL_LANES * trace_cuda._REFILL_BUDGET
    thresh = int(trace_cuda._REFILL_HANDOFF * lanes)
    assert calls["finish"] == [(N // lanes * thresh, False), (N >> 4, True)]


@pytest.mark.parametrize("where", ["handoff", "rim"])
def test_overflow_reaches_rim_total(monkeypatch, where):
    """Rays a trace cannot finish reach RimOverflow.total.  The refill
    handoff's straggler finish (simple mode) runs the finish kernel, whose
    buffer holds every straggler: the total is 0.  The deferred rim of a
    float64 scene (the eager continuation) whose buffer is smaller than
    its clipped rays leaves the rest EXITED and counts exactly them."""
    src = convert.source(SOURCE_OVERNIGHT)
    gen = torch.Generator().manual_seed(2)
    if where == "handoff":
        monkeypatch.setattr(trace_cuda, "REFILL_MIN", 1024)
        scene = convert.scene(SCENE.with_(exact_rim=False))
        cfg = T.TraceConfig(engine="simulate")
        assert route.plan([scene], cfg, 8192) == ("refill", None, None)
        _, ovf = T.trace_rays_auto(gen, scene, src, 8192, cfg, device="cpu")
        assert int(ovf) == 0
        return
    clipped = []
    real_gather = route._compact_gather

    def spy_gather(mask, *a, **k):
        clipped.append(int(mask.sum()))
        return real_gather(mask, *a, **k)

    monkeypatch.setattr(route, "_compact_gather", spy_gather)
    # 32,768 >> 7 = 256 lanes, the buffer's minimum; ~2% of the rays clip
    _, ovf = route.trace_rays_rim_deferred(
        gen, convert.scene(SCENE), src, N,
        T.TraceConfig(dtype=torch.float64, engine="simulate"),
        capacity_shift=7, device="cpu")
    assert len(clipped) == 1 and clipped[0] > 2 * 256
    assert int(ovf) == clipped[0] - 256 and int(ovf.grouped_drops) == 0


@pytest.mark.parametrize("engine", ["auto", "simulate"])
def test_thick_rim_matches_jax(engine):
    """A thick rim (no deferred post-pass) runs the in-loop exact-rim
    physics in both packages, whatever the engine: the port from the
    source in one finish call (``trace_rays_finish``, its plain version
    here), the JAX package in its in-loop ``trace_rays``.  Exit fraction
    and map total within 4 sigma."""
    scene = SCENE.with_(outer_radius=110.0)
    assert trace_mod.rim_deferred_capacity_shift(convert.scene(scene)) is None
    _assert_slice_matches_jax(engine, 5, scene, 8192)


def test_csv_header_matches_jax(tmp_path):
    """The same header lines (the timestamp line aside) for the same
    configuration, and a map of the same shape."""
    kw = dict(n_rays=4096, grid=GRID, seed=3, verbose=False)
    jp = j_sweep(SCENE, SOURCE_OVERNIGHT, save_folder=str(tmp_path / "j"),
                 **kw)
    tp = t_sweep(convert.scene(SCENE), convert.source(SOURCE_OVERNIGHT),
                 device="cpu", save_folder=str(tmp_path / "t"),
                 **dict(kw, grid=convert.grid(GRID)))
    assert os.path.basename(jp.path) == os.path.basename(tp.path)

    def header(path):
        with open(path) as fh:
            lines = fh.read().splitlines()
        head = lines[:lines.index("theta,phi,fraction") + 1]
        return [ln for ln in head if "Generated:" not in ln], lines

    jh, jl = header(jp.path)
    th, tl = header(tp.path)
    assert th == jh
    assert len(tl) == len(jl)
    assert tp.fluxmap.shape == (18, 9) and tp.n_rays == 4096
    assert 0.38 < tp.n_exited / 4096 < 0.47


def test_stdout_stamps_match_jax(monkeypatch, capsys):
    """The same stdout protocol from both sweeps: the ``[DEBUG TIME ...]``
    stamps in the same order with the same text (seconds masked), then
    the exit-count line."""
    import re

    import altair_tpu.sweep.observer as j_observer
    import altair_tpu_torch.sweep.observer as t_observer

    def protocol(module, run):
        # debug_stamp writes to the stream it bound at import, which no
        # capture fixture sees: record its messages instead
        stamps = []
        monkeypatch.setattr(module, "debug_stamp", stamps.append)
        capsys.readouterr()
        run()
        return ([re.sub(r"\d+\.\d+", "#", m) for m in stamps],
                [re.sub(r"\d+ out", "# out", ln)
                 for ln in capsys.readouterr().out.splitlines() if ln])

    kw = dict(n_rays=4096, grid=GRID, seed=3, save_folder=None)
    j = protocol(j_observer, lambda: j_sweep(SCENE, SOURCE_OVERNIGHT, **kw))
    t = protocol(t_observer, lambda: t_sweep(
        convert.scene(SCENE), convert.source(SOURCE_OVERNIGHT), device="cpu",
        **dict(kw, grid=convert.grid(GRID))))
    assert t == j
    assert t[0] == ["Starting sweep setup", "Tracing all rays once",
                    "Ray tracing completed in # s",
                    "Detector sweep completed in # s"]
    assert t[1] == ["Total rays exiting port: # out of 4096"]


def test_unported_branches_raise():
    """What still raises, as in the JAX package: engine="direct" has no
    closed form for a non-Lambertian wall, and no path history."""
    s = convert.scene(SCENE)
    so = convert.source(SOURCE_OVERNIGHT)
    g = torch.Generator()
    with pytest.raises(NotImplementedError):
        T.trace_rays_auto(g, s.with_(surface_model=T.SurfaceModel.MIXED_BRDF),
                          so, 64, T.TraceConfig(engine="direct"),
                          device="cpu")
    with pytest.raises(ValueError):
        T.trace_rays_auto(g, s, so, 64,
                          T.TraceConfig(engine="direct", keep_history=4),
                          device="cpu")


def test_history_and_callable_run_through_auto():
    """Path history and a custom scatter callable both run through
    ``trace_rays_auto`` (the eager tracers), with every ray finished."""
    from altair_tpu_torch.core.sampling import cosine_hemisphere

    s = convert.scene(SCENE)
    so = convert.source(SOURCE_OVERNIGHT)
    g = torch.Generator().manual_seed(1)
    res, ovf = T.trace_rays_auto(g, s, so, 256, T.TraceConfig(keep_history=4),
                                 device="cpu")
    assert res.history.shape == (4, 256, 3) and int(ovf) == 0
    assert int(res.history_len.min()) >= 2
    hook = s.with_(surface_model=lambda gen, inc, n, sc:
                   cosine_hemisphere(gen, n))
    res, ovf = T.trace_rays_auto(g, hook, so, 256, device="cpu")
    assert int(ovf) == 0 and res.history is None
    assert set(res.status.unique().tolist()) <= {1, 2, 3}
    assert 0.25 < (res.status == 1).float().mean() < 0.6


def test_package_imports_no_jax():
    code = ("import sys, altair_tpu_torch, altair_tpu_torch.sweep, "
            "altair_tpu_torch.convert, altair_tpu_torch.core.trace_cuda, "
            "altair_tpu_torch.core.qmc, altair_tpu_torch.core.score, "
            "altair_tpu_torch.cli, altair_tpu_torch.viz, "
            "altair_tpu_torch.analysis, altair_tpu_torch.native, "
            "altair_tpu_torch.io.profiling, altair_tpu_torch.parallel, "
            "altair_tpu_torch.parallel.demo; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'altair_tpu.'))  or m == 'altair_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
