"""Port parity of path history (``TraceConfig.keep_history``) and of the
custom scatter callable against ``altair_tpu`` on the CPU.  The streams
differ, so traces are compared statistically (4 sigma, stated per test);
what is deterministic (the buffer's structure, the dispatch facts) is held
exactly."""

import functools

import jax
import numpy as np
import pytest
import torch

from altair_tpu import TraceConfig as JCfg
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
from altair_tpu.core import sampling as jsampling
from altair_tpu.core import score as jscore
from altair_tpu.core import trace as jtrace
from altair_tpu.core import trace_direct as jdirect
from altair_tpu.core.trace_waves import trace_rays_auto as j_auto
import altair_tpu_torch as T
from altair_tpu_torch import convert
from altair_tpu_torch.core import sampling as tsampling
from altair_tpu_torch.core import score as tscore
from altair_tpu_torch.core import trace as ttrace
from altair_tpu_torch.core import trace_cuda, trace_direct as tdirect

torch.set_num_threads(1)

SCENE = SCENE_OPTIMIZE.with_(max_bounces=512)
T_SCENE = convert.scene(SCENE)
T_SOURCE = convert.source(SOURCE_OVERNIGHT)
N, K = 1500, 24


@functools.cache
def _history(package: str, k: int = K):
    """A history trace of N rays as the port's ``TraceResult`` on the CPU:
    the JAX package's carried across, or the port's own."""
    if package == "jax":
        res = jtrace.trace_rays(jax.random.key(3), SCENE, SOURCE_OVERNIGHT, N,
                                JCfg(keep_history=k))
        return convert.trace_result(res, "cpu")
    return ttrace.trace_rays(torch.Generator().manual_seed(3), T_SCENE,
                             T_SOURCE, N, T.TraceConfig(keep_history=k),
                             device="cpu")


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_history_structure(package):
    """What the buffer holds, in both packages: slot 0 is the source point;
    a ray's last recorded point is its last point while the buffer has
    room; every point between lies on the inner sphere (1e-3 cm) or on the
    rim band between the shell radii; lengths lie in [2, K]."""
    res = _history(package)
    hist, hlen = res.history.numpy(), res.history_len.numpy()
    assert hist.shape == (K, N, 3) and hlen.shape == (N,)
    assert hlen.min() >= 2 and hlen.max() == K
    src = [SOURCE_OVERNIGHT.x, SOURCE_OVERNIGHT.y, SOURCE_OVERNIGHT.z]
    np.testing.assert_array_equal(hist[0], np.tile(np.float32(src), (N, 1)))
    room = hlen < K
    assert room.any() and (~room).any()
    last = res.last_point.stack().numpy()
    np.testing.assert_array_equal(hist[hlen - 1, np.arange(N)][room],
                                  last[room])
    slot = np.arange(K)[:, None]
    interior = (slot >= 1) & (slot < (hlen - 1)[None, :])
    r = np.linalg.norm(hist, axis=2)[interior]
    on_wall = np.abs(r - SCENE.inner_radius) < 1e-3
    on_rim = (r > SCENE.inner_radius - 1e-3) & (r < SCENE.outer_radius + 1e-3)
    assert (on_wall | on_rim).all() and on_wall.mean() > 0.9
    # slots past a ray's length were never written
    assert (hist[slot >= hlen[None, :]] == 0).all()


def test_history_len_matches_jax():
    """Mean ``history_len`` (saturating at K) of the two packages within
    4 sigma of the two-sample spread, and the share of saturated rays."""
    j, t = _history("jax"), _history("torch")
    jl, tl = j.history_len.numpy().astype(float), t.history_len.numpy().astype(float)
    sigma = np.sqrt((jl.var() + tl.var()) / N)
    assert abs(jl.mean() - tl.mean()) < 4 * sigma
    pj, pt = (jl == K).mean(), (tl == K).mean()
    assert abs(pj - pt) < 4 * np.sqrt(2 * pj * (1 - pj) / N)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_full_buffer_overwrites_last_slot(package):
    """K = 3: once the buffer is full the last slot is overwritten, so it
    holds the ray's last point, and ``history_len`` stays at K."""
    res = _history(package, 3)
    hlen = res.history_len.numpy()
    assert set(np.unique(hlen)) <= {2, 3} and (hlen == 3).mean() > 0.9
    np.testing.assert_array_equal(res.history[hlen - 1, np.arange(N)].numpy(),
                                  res.last_point.stack().numpy())


def test_trace_paths_census_matches_jax():
    """``viz.trace_paths`` census fractions (hit / exit / noexit /
    suspended) of N rays within 4 sigma of the JAX package's, and the
    path payload's shapes."""
    from altair_tpu.viz import trace_paths as j_paths
    from altair_tpu_torch.viz import trace_paths as t_paths

    kw = dict(n_rays=N, seed=5, keep_history=K, detector_width=60.0)
    jp = j_paths(SCENE, SOURCE_OVERNIGHT, **kw)
    tp = t_paths(T_SCENE, T_SOURCE, device="cpu", **kw)
    assert sum(tp.census.values()) == N
    assert tp.points.shape == (K, N, 3) and tp.lengths.shape == (N,)
    assert tp.source == jp.source
    for a, b in zip(tp.detector, jp.detector):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    for cls in ("hit", "exit", "noexit", "suspended"):
        p = jp.census[cls] / N
        sigma = np.sqrt(2 * max(p, 1 / N) * (1 - p) / N)
        assert abs(tp.census[cls] / N - p) < 4 * sigma, (cls, tp.census,
                                                          jp.census)


def _lambertian_hook(sampling):
    def hook(key, incident, normal, scene):
        return sampling.cosine_hemisphere(key, normal)
    return hook


@functools.cache
def _exit_stats(package: str, custom: bool):
    """(exit fraction, mean bounces) of 4000 rays on the simple-rim scene
    with the built-in Lambertian law or the same law as a callable."""
    n = 4000
    if package == "jax":
        scene = SCENE.with_(exact_rim=False)
        if custom:
            scene = scene.with_(surface_model=_lambertian_hook(jsampling))
        res = j_auto(jax.random.key(9), scene, SOURCE_OVERNIGHT, n,
                     JCfg(engine="simulate"))
        status, b = np.asarray(res.status), np.asarray(res.n_bounces)
    else:
        scene = T_SCENE.with_(exact_rim=False)
        if custom:
            scene = scene.with_(surface_model=_lambertian_hook(tsampling))
        res, ovf = T.trace_rays_auto(torch.Generator().manual_seed(9), scene,
                                     T_SOURCE, n,
                                     T.TraceConfig(engine="simulate"),
                                     device="cpu")
        assert int(ovf) == 0
        status, b = res.status.numpy(), res.n_bounces.numpy()
    return (status == 1).mean(), b.mean(), b.std(), n


@pytest.mark.parametrize("package,custom", [("jax", True), ("torch", False),
                                            ("torch", True)])
def test_callable_hook_is_the_lambertian_law(package, custom):
    """A callable that returns the cosine law traces like the built-in law:
    exit fraction and mean bounce count within 4 sigma of the JAX built-in
    run, for JAX's hook and for the port's built-in law and hook."""
    p0, b0, s0, n = _exit_stats("jax", False)
    p, b, s, _ = _exit_stats(package, custom)
    assert abs(p - p0) < 4 * np.sqrt(2 * p0 * (1 - p0) / n)
    assert abs(b - b0) < 4 * np.sqrt((s0 ** 2 + s ** 2) / n)


def test_callable_receives_the_bounce_operands():
    """The hook gets ``(generator, incident, normal, scene)`` and its
    return value is the scattered direction."""
    z = torch.zeros(4)
    v, w = T.Vec3(z, z, z + 1), T.Vec3(z + 1, z, z)
    seen = []

    def hook(gen, incident, normal, scene):
        seen.append((gen, incident, normal, scene))
        return incident

    g = torch.Generator()
    out = tsampling.scatter(g, hook, v, w, "scene")
    assert out is v and seen == [(g, v, w, "scene")]


def test_dispatch_facts_match_jax():
    """A callable is no static law and history needs the eager loop: the
    kernels, the closed-form sampler and the exit capacity treat them as
    the JAX package does."""
    hook_j, hook_t = _lambertian_hook(jsampling), _lambertian_hook(tsampling)
    js, ts = SCENE.with_(surface_model=hook_j), T_SCENE.with_(
        surface_model=hook_t)
    assert not trace_cuda.kernel_applicable(ts, T.TraceConfig())
    assert not trace_cuda.kernel_applicable(T_SCENE,
                                            T.TraceConfig(keep_history=4))
    assert (tdirect.direct_applicable(ts, T.TraceConfig())
            == jdirect.direct_applicable(js, JCfg()) is False)
    assert (tdirect.direct_applicable(T_SCENE, T.TraceConfig(keep_history=4))
            == jdirect.direct_applicable(SCENE, JCfg(keep_history=4))
            is False)
    assert (tscore.exit_capacity(ts, 1000) == jscore.exit_capacity(js, 1000)
            == 1000)
    assert (tscore.exit_capacity(T_SCENE, 1000)
            == jscore.exit_capacity(SCENE, 1000) < 1000)
    # the kernels' own entry points refuse both
    for scene, cfg in ((ts, T.TraceConfig()),
                       (T_SCENE, T.TraceConfig(keep_history=4))):
        with pytest.raises(NotImplementedError):
            trace_cuda.trace_rays_bounce(torch.Generator(),
                                         scene.with_(exact_rim=False),
                                         T_SOURCE, 8, cfg, device="cpu")


def test_auto_routes_history_and_refuses_where_jax_does():
    """``trace_rays_auto`` sends history to the eager loop on any engine
    but "direct" (ValueError, as in JAX); the deferred-rim tracer has no
    history buffer in either package; ``trace_rays_fast`` falls back to the
    eager loop for history and for a callable, as the JAX one does."""
    g = torch.Generator().manual_seed(0)
    for engine in ("auto", "simulate"):
        res, ovf = T.trace_rays_auto(
            g, T_SCENE, T_SOURCE, 64,
            T.TraceConfig(keep_history=5, engine=engine), device="cpu")
        assert res.history.shape == (5, 64, 3) and int(ovf) == 0
        assert res.history_len.dtype == torch.int32
    with pytest.raises(ValueError, match="history"):
        T.trace_rays_auto(g, T_SCENE, T_SOURCE, 64,
                          T.TraceConfig(keep_history=5, engine="direct"),
                          device="cpu")
    with pytest.raises(ValueError, match="history"):
        j_auto(jax.random.key(0), SCENE, SOURCE_OVERNIGHT, 64,
               JCfg(keep_history=5, engine="direct"))
    with pytest.raises(ValueError, match="history"):
        ttrace.trace_rays_rim_deferred(g, T_SCENE, T_SOURCE, 64,
                                       T.TraceConfig(keep_history=5),
                                       device="cpu")
    with pytest.raises(ValueError, match="history"):
        jtrace.trace_rays_rim_deferred(jax.random.key(0), SCENE,
                                       SOURCE_OVERNIGHT, 64,
                                       JCfg(keep_history=5))
    res, _ = trace_cuda.trace_rays_fast(g, T_SCENE, T_SOURCE, 64,
                                        T.TraceConfig(keep_history=5),
                                        device="cpu")
    assert res.history is not None
    res, _ = trace_cuda.trace_rays_fast(
        g, T_SCENE.with_(surface_model=_lambertian_hook(tsampling)),
        T_SOURCE, 64, device="cpu")
    assert res.history is None and res.status.shape == (64,)
    # without history the result carries none
    res, _ = T.trace_rays_auto(g, T_SCENE, T_SOURCE, 64, device="cpu")
    assert res.history is None and res.history_len is None
