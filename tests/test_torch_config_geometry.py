"""Port parity: configuration dataclasses, ``convert``, and the geometry
primitives of ``altair_tpu_torch`` against ``altair_tpu`` on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import altair_tpu.config as jcfg
import altair_tpu.core.geometry as jgeo
import altair_tpu_torch.config as tcfg
import altair_tpu_torch.core.geometry as tgeo
from altair_tpu.core.trace import TraceResult as JTraceResult
from altair_tpu.core.trace_pallas import _kernel_operands
from altair_tpu_torch import convert
from altair_tpu_torch.core.trace_cuda import kernel_operands

torch.set_num_threads(1)

CLASSES = ["SphereScene", "Source", "DetectorGrid", "TraceConfig"]
PRESETS = ["SCENE_V1", "SCENE_OPTIMIZE", "SCENE_DEMO", "SCENE_INSPHERE",
           "SOURCE_V1", "SOURCE_DEMO", "SOURCE_OVERNIGHT"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        if a.name == "dtype":   # jnp.float32 vs torch.float32
            assert np.dtype(a.default).name == str(b.default).split(".")[-1]
        else:
            assert a.default == b.default, a.name


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    j = getattr(jcfg, name)
    t = getattr(tcfg, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_surface_models_and_helpers():
    assert {m.name: int(m) for m in tcfg.SurfaceModel} == \
        {m.name: int(m) for m in jcfg.SurfaceModel}
    for port in (150.0, 160.0, 164.0, 170.0, 175.0):
        assert tcfg.port_escape_probability(port) == \
            jcfg.port_escape_probability(port)
        for rho in (0.9, 0.99, 1.0):
            assert tcfg.expected_exit_fraction(port, rho) == \
                jcfg.expected_exit_fraction(port, rho)


@pytest.mark.parametrize("bad", [
    dict(source=dict(x=200.0)), dict(source=dict(dir_x=0.0, dir_y=0.0)),
    dict(scene=dict(theta_max_deg=80.0)), dict(scene=dict(reflectance=1.5)),
])
def test_validate_rejects_like_jax(bad):
    for mod in (jcfg, tcfg):
        scene = mod.SCENE_OPTIMIZE.with_(**bad.get("scene", {}))
        source = mod.SOURCE_OVERNIGHT.with_(**bad.get("source", {}))
        with pytest.raises(ValueError):
            mod.validate(scene, source)
    tcfg.validate(tcfg.SCENE_OPTIMIZE, tcfg.SOURCE_OVERNIGHT)


def test_grid_centers_equal():
    g = jcfg.DetectorGrid(n_theta=7, n_phi=5, theta_lo=3.0)
    t = convert.grid(g)
    np.testing.assert_allclose(t.theta_centers().numpy(),
                               np.asarray(g.theta_centers()), rtol=1e-6)
    np.testing.assert_allclose(t.phi_centers().numpy(),
                               np.asarray(g.phi_centers()), rtol=1e-6)


def test_convert_round_trips():
    scene = jcfg.SCENE_OPTIMIZE.with_(
        theta_max_deg=164.0, reflectance=0.95, max_bounces=77,
        surface_model=jcfg.SurfaceModel.MIXED_BRDF, exact_rim=False)
    source = jcfg.SOURCE_V1.with_(x=-10.0, dir_z=0.5)
    grid = jcfg.DetectorGrid(n_theta=12, n_phi=6, width=30.0)
    cfg = jcfg.TraceConfig(block_iters=8, engine="simulate")
    for obj, conv in ((scene, convert.scene), (source, convert.source),
                      (grid, convert.grid)):
        back = type(obj)(**dataclasses.asdict(conv(obj)))
        assert back == obj
    tc = convert.trace_config(cfg)
    assert tc.dtype == torch.float32 and tc.block_iters == 8
    assert tc.engine == "simulate"
    assert isinstance(convert.scene(scene).surface_model, tcfg.SurfaceModel)


def test_convert_trace_result_and_seed():
    rng = np.random.default_rng(0)
    n = 33
    v = lambda: jgeo.Vec3(*(jnp.asarray(rng.normal(size=n), jnp.float32)
                            for _ in range(3)))
    res = JTraceResult(jnp.asarray(rng.integers(0, 4, n), jnp.int32), v(),
                       v(), v(), jnp.asarray(rng.integers(0, 99, n),
                                             jnp.int32))
    t = convert.trace_result(res, "cpu")
    assert t.status.dtype == torch.int32 and t.n_bounces.dtype == torch.int32
    for f in ("last_point", "seg_start", "direction"):
        for c in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(t, f), c).numpy(),
                np.asarray(getattr(getattr(res, f), c)))
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(res.status))
    key = jax.random.key(123456)
    seed, _, _ = _kernel_operands(key, jcfg.SCENE_OPTIMIZE,
                                  jcfg.SOURCE_OVERNIGHT)
    assert convert.seed_words(jax.random.key_data(key)) == \
        tuple(int(s) for s in np.asarray(seed))


@pytest.mark.parametrize("model", list(jcfg.SurfaceModel))
def test_kernel_operands_match_jax(model):
    """The float32 operand vectors the bounce kernel reads (cos_cap, the
    law's parameters, the normalised direction) equal JAX's to 1 ulp."""
    scene = jcfg.SCENE_OPTIMIZE.with_(surface_model=model, max_bounces=4096,
                                      exact_rim=False)
    _, sv, srcv = _kernel_operands(jax.random.key(0), scene,
                                   jcfg.SOURCE_OVERNIGHT)
    a, b = kernel_operands(convert.scene(scene),
                           convert.source(jcfg.SOURCE_OVERNIGHT), "cpu")
    np.testing.assert_allclose(a.numpy(), np.asarray(sv), rtol=1.2e-7, atol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(srcv), rtol=1.2e-7,
                               atol=0)


# ---------------------------------------------------------------------------
# geometry, elementwise on random float32 inputs
# ---------------------------------------------------------------------------

N = 4096
# f32 transcendental implementations differ by an ulp or two between XLA
# and torch; geometry is a few operations deep, so 1e-5 relative (plus an
# absolute floor for values near 0) bounds them
RTOL, ATOL = 1e-5, 1e-4


def _rand_vec(rng, scale=1.0, unit=False):
    a = rng.normal(size=(3, N)).astype(np.float32)
    if unit:
        a /= np.linalg.norm(a, axis=0, keepdims=True)
    return (a * scale).astype(np.float32)


def _both(a):
    return (jgeo.Vec3(*(jnp.asarray(x) for x in a)),
            tgeo.Vec3(*(torch.from_numpy(x.copy()) for x in a)))


def _close(t, j, rtol=RTOL, atol=ATOL):
    if isinstance(t, tgeo.Vec3):
        for c in "xyz":
            _close(getattr(t, c), getattr(j, c), rtol, atol)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    # interior points (|p| < 100) and unit directions
    p = _rand_vec(rng, 1.0)
    p *= (rng.uniform(0, 95, N) / np.linalg.norm(p, axis=0)).astype(np.float32)
    return dict(p=p, d=_rand_vec(rng, unit=True), n=_rand_vec(rng, unit=True),
                far=_rand_vec(rng, 150.0))


def test_vec3_and_basis(inputs):
    (jn, tn), (jd, td) = _both(inputs["n"]), _both(inputs["d"])
    _close(tn.cross(td), jn.cross(jd))
    _close(tn.normalized(1e-20), jn.normalized(1e-20))
    ju, jv = jgeo.orthonormal_basis(jn)
    tu, tv = tgeo.orthonormal_basis(tn)
    _close(tu, ju)
    _close(tv, jv)
    # the sign convention at -0.0: a comparison, not copysign
    z = torch.tensor([-0.0])
    _, v = tgeo.orthonormal_basis(tgeo.Vec3(z, z, z))
    jz = jnp.asarray([-0.0], jnp.float32)
    _, jv = jgeo.orthonormal_basis(jgeo.Vec3(jz, jz, jz))
    assert float(v.y) == float(jv.y[0]) == 1.0   # copysign would give -1


def test_sphere_and_box(inputs):
    (jp, tp), (jd, td) = _both(inputs["p"]), _both(inputs["d"])
    _close(tgeo.ray_sphere_exit_t(tp, td, 100.1),
           jgeo.ray_sphere_exit_t(jp, jd, 100.1))
    _close(tgeo.sphere_hit(tp, td, 100.1), jgeo.sphere_hit(jp, jd, 100.1))
    _close(tgeo.ray_box_exit_t(tp, td, 300.0),
           jgeo.ray_box_exit_t(jp, jd, 300.0))
    (jf, tf) = _both(inputs["far"])
    for r in (100.1, 101.0):
        j = np.asarray(jgeo.sphere_crossing_t(jf, jd, r))
        t = tgeo.sphere_crossing_t(tf, td, r).numpy()
        np.testing.assert_array_equal(t >= 1e29, j >= 1e29)
        _close(torch.from_numpy(t[j < 1e29]), j[j < 1e29])


def test_rim_cone(inputs):
    """The rim cone crossing from points near the port (the only place it
    is ever evaluated), and the rim-face normal."""
    rng = np.random.default_rng(7)
    cos_tm = float(np.cos(np.deg2rad(np.float32(170.0))))
    p = _rand_vec(rng, 3.0)
    p[2] += -100.0
    (jp, tp), (jd, td) = _both(p), _both(inputs["d"])
    j = np.asarray(jgeo.cone_crossing_t(jp, jd, cos_tm, 100.1, 101.0))
    t = tgeo.cone_crossing_t(tp, td, cos_tm, 100.1, 101.0).numpy()
    hit_j, hit_t = j < 1e29, t < 1e29
    # a root within float rounding of the band edge may flip
    assert (hit_j != hit_t).mean() < 1e-3
    both = hit_j & hit_t
    assert both.sum() > 50
    np.testing.assert_allclose(t[both], j[both], rtol=1e-4, atol=1e-4)
    _close(tgeo.cone_face_normal(tp), jgeo.cone_face_normal(jp))


def test_detector_position_keeps_normal_quirk():
    th = np.linspace(0.5, 89.5, 90, dtype=np.float32)
    ph = np.linspace(2.0, 358.0, 90, dtype=np.float32)
    jc, jn = jgeo.detector_position(jnp.asarray(th), jnp.asarray(ph), 100.0)
    tc, tn = tgeo.detector_position(torch.from_numpy(th),
                                    torch.from_numpy(ph), 100.0)
    _close(tc, jc)
    _close(tn, jn)
    # the stored normal is (-dvec.y, dvec.x, dvec.z)/|dvec|, not the aim
    dvec = np.stack([tc.x.numpy(), tc.y.numpy(), tc.z.numpy() + 100.0])
    dvec /= np.linalg.norm(dvec, axis=0)
    np.testing.assert_allclose(tn.x.numpy(), -dvec[1], atol=1e-6)
    np.testing.assert_allclose(tn.y.numpy(), dvec[0], atol=1e-6)


def test_detector_position_aimed_matches_jax():
    """The aimed variant: same centre, the normal -dvec/|dvec| (the
    reference's own case is ``tests/test_geometry.py``'s aimed test)."""
    rng = np.random.default_rng(11)
    th = rng.uniform(0.5, 89.5, N).astype(np.float32)
    ph = rng.uniform(0, 360, N).astype(np.float32)
    jc, jn = jgeo.detector_position_aimed(jnp.asarray(th), jnp.asarray(ph),
                                          100.0, -100.0)
    tc, tn = tgeo.detector_position_aimed(torch.from_numpy(th),
                                          torch.from_numpy(ph), 100.0, -100.0)
    _close(tc, jc)
    _close(tn, jn)
    port = tgeo.Vec3(*(torch.tensor(v) for v in (0.0, 0.0, -100.0)))
    aim = (port - tc).normalized()
    _close(tn, jgeo.Vec3(*(jnp.asarray(c.numpy()) for c in aim)))


def test_in_port_cap_matches_jax(inputs):
    """Sphere points against the cap test, at the cap's edge too."""
    rng = np.random.default_rng(12)
    q = _rand_vec(rng, unit=True) * np.float32(100.1)
    tm = np.deg2rad(rng.choice(np.float32([150.0, 164.0, 170.0, 178.0]),
                               N)).astype(np.float32)
    jq, tq = _both(q)
    j = np.asarray(jgeo.in_port_cap(jq, 100.1, jnp.asarray(tm)))
    t = tgeo.in_port_cap(tq, 100.1, torch.from_numpy(tm)).numpy()
    assert 0 < j.sum() < N
    # a point within float rounding of the cap's edge may flip
    edge = np.abs(q[2] - 100.1 * np.cos(tm)) < 1e-3
    np.testing.assert_array_equal(t[~edge], j[~edge])
    top = tgeo.Vec3(*(torch.tensor([v]) for v in (0.0, 0.0, 100.0)))
    bottom = tgeo.Vec3(*(torch.tensor([v]) for v in (0.0, 0.0, -100.0)))
    tm170 = torch.deg2rad(torch.tensor(170.0))
    assert not bool(tgeo.in_port_cap(top, 100.0, tm170))
    assert bool(tgeo.in_port_cap(bottom, 100.0, tm170))


def test_line_hits_disk(inputs):
    rng = np.random.default_rng(3)
    th = rng.uniform(0, 90, N).astype(np.float32)
    ph = rng.uniform(0, 360, N).astype(np.float32)
    jc, jn = jgeo.detector_position(jnp.asarray(th), jnp.asarray(ph), 100.0)
    tc, tn = tgeo.detector_position(torch.from_numpy(th),
                                    torch.from_numpy(ph), 100.0)
    pts = _rand_vec(rng, 20.0)
    pts[2] -= 150.0
    (jp, tp), (jd, td) = _both(pts), _both(inputs["d"])
    j = np.asarray(jgeo.line_hits_disk(jp, jd, jc, jn, 20.0))
    t = tgeo.line_hits_disk(tp, td, tc, tn, 20.0).numpy()
    assert j.sum() > 20
    # only pairs within rounding of the disk edge may differ
    assert (j != t).sum() <= 2
