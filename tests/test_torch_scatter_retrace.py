"""Port parity of ``sweep/scatter_retrace.py`` (the two-stage
``nonLambertianFlux.C`` pipeline) against ``altair_tpu`` on the CPU: the
deterministic part of the from-state retrace elementwise (rtol 1e-5, atol
1e-4 cm), the traced fractions and the sweep's map total statistically
(4 sigma; the streams differ)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu import TraceConfig as JCfg
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid
from altair_tpu.core import geometry as jgeo
from altair_tpu.sweep import scatter_retrace as jsr
import altair_tpu_torch as T
from altair_tpu_torch import convert
from altair_tpu_torch.core import geometry as tgeo
from altair_tpu_torch.sweep import scatter_retrace as tsr

torch.set_num_threads(1)

# the CLI's BRDF (0.4 / 0.6 / 0.3) on the production scene; the simple rim
# keeps the JAX programs cheap to compile
SCENE = SCENE_OPTIMIZE.with_(max_bounces=768, exact_rim=False,
                             specular_prob=0.4, diffuse_prob=0.6,
                             brdf_roughness=0.3)
T_SCENE = convert.scene(SCENE)
T_SOURCE = convert.source(SOURCE_OVERNIGHT)
N = 5000


def test_outside_starts_fly_straight_as_in_jax():
    """Starts beyond the shell (r >= inner radius + 0.5 cm) take no step:
    EXITED at once, last point on the world box along the given direction,
    segment start the given point, no bounce; elementwise equal to the JAX
    function on the same inputs.  (With no ray RUNNING the loop draws
    nothing, so the result is deterministic.)"""
    rng = np.random.default_rng(5)
    n = 64
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = (u * rng.uniform(100.7, 290.0, (n, 1))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jres = jsr._retrace_from(jax.random.key(0), SCENE,
                             jgeo.Vec3(*(jnp.asarray(c) for c in pos.T)),
                             jgeo.Vec3(*(jnp.asarray(c) for c in d.T)), n,
                             JCfg())
    tres = tsr._retrace_from(torch.Generator(), T_SCENE,
                             tgeo.Vec3(*(torch.from_numpy(c.copy())
                                         for c in pos.T)),
                             tgeo.Vec3(*(torch.from_numpy(c.copy())
                                         for c in d.T)), n, T.TraceConfig(),
                             device="cpu")
    assert (tres.status == 1).all() and (np.asarray(jres.status) == 1).all()
    assert (tres.n_bounces == 0).all()
    for name in ("last_point", "seg_start", "direction"):
        for a, b in zip(getattr(tres, name), getattr(jres, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4)
    np.testing.assert_array_equal(tres.seg_start.stack().numpy(), pos)
    face = np.abs(tres.last_point.stack().numpy()).max(axis=1)
    np.testing.assert_allclose(face, SCENE.world_half, rtol=1e-5)


def test_on_shell_starts_are_traced():
    """The 0.5 cm tolerance keeps wall endpoints (|p| = r up to rounding)
    on the traceable side: they bounce on (but for the few aimed straight
    at the port), and none is left RUNNING."""
    n = 512
    g = torch.Generator().manual_seed(2)
    u = torch.randn(n, 3, generator=g)
    u = u / u.norm(dim=1, keepdim=True)
    u[:, 2] = u[:, 2].abs()                      # away from the port
    u = u / u.norm(dim=1, keepdim=True)
    pos = tgeo.Vec3(*(u * (100.1 + 0.4)).unbind(1))
    inward = tgeo.Vec3(*(-u).unbind(1))
    res = tsr._retrace_from(g, T_SCENE, pos, inward, n, T.TraceConfig(),
                            device="cpu")
    assert set(res.status.unique().tolist()) <= {1, 2, 3}
    straight_out = res.n_bounces == 0
    assert straight_out.float().mean() < 0.05
    assert (res.status[straight_out] == 1).all()


@functools.cache
def _fractions(package: str, only_absorbed: bool):
    """(exit, absorbed, suspended fractions, port-exit fraction, mean
    bounces of stage 2 and their std) of the scattered rays."""
    if package == "jax":
        res = jsr.trace_scatter_retrace(
            jax.random.key(4), SCENE, SOURCE_OVERNIGHT, N, JCfg(),
            only_rescatter_absorbed=only_absorbed)
        status = np.asarray(res.status)
        z = np.asarray(res.last_point.z)
        b = np.asarray(res.n_bounces)
    else:
        res, ovf = tsr.trace_scatter_retrace(
            torch.Generator().manual_seed(4), T_SCENE, T_SOURCE, N,
            T.TraceConfig(), only_rescatter_absorbed=only_absorbed,
            device="cpu")
        assert int(ovf) == 0
        status = res.status.numpy()
        z = res.last_point.z.numpy()
        b = res.n_bounces.numpy()
    assert set(np.unique(status)) <= {1, 2, 3}
    port = ((status == 1) & (z < SCENE.exit_port_z)).mean()
    return ((status == 1).mean(), (status == 2).mean(), (status == 3).mean(),
            port, b.mean(), b.std())


@pytest.mark.parametrize("only_absorbed", [False, True])
def test_scatter_retrace_fractions_match_jax(only_absorbed):
    """EXITED, ABSORBED and port-exit fractions of the scattered rays and
    the mean stage-2 bounce count within 4 sigma of the JAX package's (two
    independent samples of 5000 rays), with the macro's quirks in both:
    every stage-1 endpoint is rescattered, or only those on the shell."""
    j = _fractions("jax", only_absorbed)
    t = _fractions("torch", only_absorbed)
    for pj, pt in zip(j[:4], t[:4]):
        assert abs(pt - pj) < 4 * np.sqrt(2 * max(pj, 1 / N) * (1 - pj) / N), (
            j, t)
    assert abs(t[4] - j[4]) < 4 * np.sqrt((j[5] ** 2 + t[5] ** 2) / N)
    assert t[0] > 0.3 and t[1] > 0.1


def test_rescatter_quirks_change_the_result():
    """Rescattering only the on-shell endpoints leaves the exited rays'
    box endpoints flying on, so more rays count as exits than when every
    endpoint is rescattered about its outward ``endpoint.Unit()``."""
    every = _fractions("torch", False)
    shell = _fractions("torch", True)
    assert shell[3] > every[3]


def test_sweep_map_total_matches_jax():
    """``sweep_scatter_retrace`` on the 45x20 grid with the 10 cm detector:
    the map's total hit fraction within 4 sigma of the JAX package's
    (Poisson on the two hit totals), the shape and the defaults."""
    js = jsr.sweep_scatter_retrace(SCENE, SOURCE_OVERNIGHT, n_rays=N, seed=6)
    ts = tsr.sweep_scatter_retrace(T_SCENE, T_SOURCE, device="cpu", n_rays=N,
                                   seed=6)
    assert ts.fluxmap.shape == js.fluxmap.shape == (45, 20)
    assert ts.n_rays == N and ts.wall_time_s > 0
    hj, ht = js.fluxmap.sum() * N, ts.fluxmap.sum() * N
    assert hj > 50
    assert abs(ht - hj) < 4 * np.sqrt(hj + ht), (ht, hj)
    import inspect

    jd = inspect.signature(jsr.sweep_scatter_retrace).parameters
    td = inspect.signature(tsr.sweep_scatter_retrace).parameters
    assert convert.grid(jd["grid"].default) == td["grid"].default
    assert td["n_rays"].default == jd["n_rays"].default == 100_000
    assert td["mesh"].default is jd["mesh"].default is None
    assert td["device"].default is inspect.Parameter.empty


def test_exact_rim_and_mixed_wall_scenes_finish():
    """Port only: the production exact-rim scene (stage 1 the direct engine
    under the deferred rim, stage 2 the in-loop rim) and a MIXED_BRDF wall
    (stage 1 the simulate engine) end every ray EXITED, ABSORBED or
    SUSPENDED with a zero overflow."""
    for scene in (T_SCENE.with_(exact_rim=True),
                  T_SCENE.with_(surface_model=T.SurfaceModel.MIXED_BRDF)):
        res, ovf = tsr.trace_scatter_retrace(
            torch.Generator().manual_seed(8), scene, T_SOURCE, 2048,
            device="cpu")
        assert int(ovf) == 0
        assert set(res.status.unique().tolist()) <= {1, 2, 3}
        assert (res.status == 1).float().mean() > 0.2
