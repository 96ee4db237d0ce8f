"""Port parity of ``sweep/series.py`` against ``altair_tpu`` on the CPU:
the folder naming and the batched source/scene constructors elementwise, the
engine plan's refusals, the sequential loop's folders and files, and
``run_series_vmapped`` per member statistically (4 sigma) for both axes."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu import TraceConfig as JCfg
from altair_tpu.config import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid,
                               Source, SurfaceModel)
from altair_tpu.sweep import series as jser
import altair_tpu_torch as T
from altair_tpu_torch import convert
from altair_tpu_torch.config import expected_exit_fraction
from altair_tpu_torch.core import route as troute, trace as ttrace
from altair_tpu_torch.sweep import series as tser

torch.set_num_threads(1)

SIMPLE = SCENE_OPTIMIZE.with_(max_bounces=1024, exact_rim=False)
GRID = DetectorGrid(n_theta=6, n_phi=4)
T_SIMPLE = convert.scene(SIMPLE)
T_RIM = T_SIMPLE.with_(exact_rim=True)
T_SOURCE = convert.source(SOURCE_OVERNIGHT)
T_GRID = convert.grid(GRID)
PORTS = (164.0, 170.0, 176.0)
XS = np.float32([-60.0, -40.0, 10.5])


@pytest.mark.parametrize("src,tag", [
    (SOURCE_OVERNIGHT, 164), (Source(x=-60.9, y=0.4, z=-75.5), 170.0),
    (Source(x=12.0, y=-3.7, z=0.0), 163.99)])
def test_series_folder_matches_jax(src, tag):
    assert (tser.series_folder("portAngleSweep", convert.source(src), tag)
            == jser.series_folder("portAngleSweep", src, tag))


def test_stack_sources_and_members_match_jax():
    """Every field of the batched source and every concrete member equal
    to the JAX package's, float32; the constructors refuse what JAX refuses."""
    js = jser.stack_sources(SOURCE_OVERNIGHT, x=jnp.asarray(XS),
                            dir_y=jnp.asarray([0.0, 1.0, 2.0]))
    ts = tser.stack_sources(T_SOURCE, x=XS, dir_y=[0.0, 1.0, 2.0])
    for f in ("x", "y", "z", "dir_x", "dir_y", "dir_z", "wavelength_nm"):
        t = getattr(ts, f)
        assert t.dtype == torch.float32 and t.shape == (3,)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(js, f)))
    jm, tm = list(jser.source_members(js)), list(tser.source_members(ts))
    assert len(tm) == 3
    for a, b in zip(tm, jm):
        assert a == convert.source(b)
    for mod, src in ((tser, T_SOURCE), (jser, SOURCE_OVERNIGHT)):
        with pytest.raises(ValueError):
            mod.stack_sources(src)
        with pytest.raises(ValueError):
            mod.stack_sources(src, x=np.zeros(3), y=np.zeros(2))
        with pytest.raises(TypeError):
            list(mod.source_members(src))


def test_stack_scenes_matches_jax():
    """Numeric fields batched to float32 ``[n]``, static fields scalar, as
    in the JAX package; the port's ``scene_members`` gives the concrete
    scenes back."""
    ports = np.arange(163, 179)
    js = jser.stack_scenes(SCENE_OPTIMIZE, theta_max_deg=jnp.asarray(ports))
    ts = tser.stack_scenes(convert.scene(SCENE_OPTIMIZE), theta_max_deg=ports)
    for f in ("inner_radius", "outer_radius", "theta_max_deg", "reflectance",
              "roughness", "world_half", "exit_port_z", "cos_n"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.surface_model == T.SurfaceModel.LAMBERTIAN
    assert (ts.max_bounces, ts.exact_rim) == (js.max_bounces, js.exact_rim)
    members = list(tser.scene_members(ts))
    assert [m.theta_max_deg for m in members] == [float(p) for p in ports]
    assert members[7] == convert.scene(SCENE_OPTIMIZE).with_(
        theta_max_deg=170.0, inner_radius=float(np.float32(100.1)),
        reflectance=float(np.float32(0.99)),
        roughness=float(np.float32(0.01)),
        specular_prob=float(np.float32(0.4)),
        diffuse_prob=float(np.float32(0.6)),
        brdf_roughness=float(np.float32(0.3)))


def test_series_tracer_refusals_match_jax():
    """``engine="direct"`` with a non-Lambertian wall, or with a member
    whose rim is too thick to defer, raises in both packages."""
    mixed_j = SCENE_OPTIMIZE.with_(surface_model=SurfaceModel.MIXED_BRDF)
    thick_j = SCENE_OPTIMIZE.with_(outer_radius=110.0)
    for scene in (mixed_j, thick_j):
        with pytest.raises(NotImplementedError):
            jser._series_tracer(scene, [170.0], JCfg(engine="direct"))
        with pytest.raises(NotImplementedError):
            tser._series_tracer(convert.scene(scene), [170.0],
                                T.TraceConfig(engine="direct"), 2048)


def test_series_tracer_plans_one_capacity(monkeypatch):
    """The deferred rim post-pass runs at the smallest shift any member
    plans (the largest buffer); a thick-rim member sends every member to
    the in-loop rim: the finish route, one finish launch from the source
    (its plain version here)."""
    seen = []
    real = troute._rim_deferred

    def spy(gen, scene, source, n, cfg, capacity_shift, *a):
        seen.append(capacity_shift)
        return real(gen, scene, source, n, cfg, capacity_shift, *a)

    ports = [163.0, 178.0]
    shifts = [ttrace.rim_deferred_capacity_shift(
        T_RIM.with_(theta_max_deg=p)) for p in ports]
    assert shifts[0] != shifts[1]
    monkeypatch.setattr(troute, "_rim_deferred", spy)
    tracer = tser._series_tracer(T_RIM, ports, T.TraceConfig(), 2048)
    for p in ports:
        res, rim = tracer(torch.Generator().manual_seed(1),
                          T_RIM.with_(theta_max_deg=p), T_SOURCE, 2048,
                          T.TraceConfig(), device="cpu")
        assert int(rim.total) == 0 and res.status.shape == (2048,)
    assert seen == [min(shifts)] * 2
    finishes = []
    real_finish = troute.trace_rays_finish

    def spy_finish(gen, scene, source, n, cfg, *, device):
        finishes.append(n)
        return real_finish(gen, scene, source, n, cfg, device=device)

    monkeypatch.setattr(troute, "trace_rays_finish", spy_finish)
    thick = T_RIM.with_(outer_radius=110.0)
    res, rim = tser._series_tracer(thick, [170.0], T.TraceConfig(), 512)(
        torch.Generator().manual_seed(1), thick, T_SOURCE, 512,
        T.TraceConfig(), device="cpu")
    assert int(rim.total) == 0 and (res.status != 0).all()
    assert finishes == [512] and seen == [min(shifts)] * 2


@functools.cache
def _jax_series(axis: str):
    if axis == "ports":
        return jser.run_series_vmapped(SIMPLE, SOURCE_OVERNIGHT,
                                       port_angles=PORTS, n_rays=6000,
                                       grid=GRID, seed=2)
    return jser.run_series_vmapped(
        SIMPLE, sources=jser.stack_sources(SOURCE_OVERNIGHT,
                                           x=jnp.asarray(XS)),
        n_rays=6000, grid=GRID, seed=2)


@pytest.mark.parametrize("axis", ["ports", "sources"])
def test_run_series_vmapped_matches_jax(axis):
    """Exits per member within 4 sigma of the JAX package's (two
    independent binomial counts of 6000 rays), map totals within 4 sigma
    (Poisson on the hit counts), shapes and dtypes as JAX's, for the
    port-angle axis and for the source axis."""
    jc, je = _jax_series(axis)
    n = 6000
    if axis == "ports":
        tc, te = tser.run_series_vmapped(T_SIMPLE, T_SOURCE, device="cpu",
                                         port_angles=PORTS, n_rays=n,
                                         grid=T_GRID, seed=2)
    else:
        tc, te = tser.run_series_vmapped(
            T_SIMPLE, device="cpu",
            sources=tser.stack_sources(T_SOURCE, x=XS), n_rays=n,
            grid=T_GRID, seed=2)
    assert tc.shape == np.asarray(jc).shape == (3, 6, 4)
    assert te.shape == np.asarray(je).shape == (3,)
    for i in range(3):
        p = je[i] / n
        assert abs(te[i] - je[i]) < 4 * np.sqrt(2 * n * p * (1 - p)), (te, je)
        tot_j, tot_t = jc[i].sum(), tc[i].sum()
        assert abs(tot_t - tot_j) < 4 * np.sqrt(2.0 * max(tot_j, 1)) + 4 * (
            tot_j / je[i]) * np.sqrt(2 * n * p * (1 - p))
    if axis == "ports":
        # members differ by their port, and follow the port law
        assert te[0] > te[1] > te[2]
    else:
        # moving the source does not move the exit fraction
        law = expected_exit_fraction(170.0, 0.99)
        assert (np.abs(te / n - law)
                < 4 * np.sqrt(law * (1 - law) / n)).all()


@functools.cache
def _jax_exact_rim_exits(n):
    """JAX's exact-rim series (the direct sampler under the deferred rim
    post-pass at the members' shared capacity)."""
    return jser.run_series_vmapped(SIMPLE.with_(exact_rim=True, max_bounces=512),
                                   SOURCE_OVERNIGHT, port_angles=PORTS,
                                   n_rays=n, grid=GRID, seed=4)[1]


@pytest.mark.parametrize("engine", ["auto", "simulate"])
def test_run_series_vmapped_exact_rim_members(engine):
    """Exact-rim scene: the direct engine and the simulate engine (on the
    CPU its kernel's plain version) give every member an exit count within
    4 sigma of the JAX package's exact-rim series (two binomial counts of
    4096 rays) and below the no-rim law; member i does not depend on the
    members after it (``fold_in(key, i)``)."""
    n = 4096
    cfg = T.TraceConfig(engine=engine)
    scene = T_RIM.with_(max_bounces=512)
    c, e = tser.run_series_vmapped(scene, T_SOURCE, device="cpu",
                                   port_angles=PORTS, n_rays=n, grid=T_GRID,
                                   seed=4, cfg=cfg)
    for port, ex, jex in zip(PORTS, e, _jax_exact_rim_exits(n)):
        law = expected_exit_fraction(port, 0.99)
        sigma = np.sqrt(law * (1 - law) / n)
        assert 0.90 * law - 4 * sigma < ex / n < law + 4 * sigma, (port, ex)
        pj = jex / n
        assert abs(ex - jex) < 4 * np.sqrt(2 * n * pj * (1 - pj)), (port, ex,
                                                                    jex)
    c1, e1 = tser.run_series_vmapped(scene, T_SOURCE, device="cpu",
                                     port_angles=PORTS[:1], n_rays=n,
                                     grid=T_GRID, seed=4, cfg=cfg)
    if engine == "auto":
        # one shared plan: a member's draw only depends on the plan, and
        # the first member's plan is the series' (its shift is the smallest)
        np.testing.assert_array_equal(c1[0], c[0])
        assert e1[0] == e[0]


def test_run_series_vmapped_guards():
    with pytest.raises(ValueError, match="exactly one"):
        tser.run_series_vmapped(T_SIMPLE, T_SOURCE, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tser.run_series_vmapped(
            T_SIMPLE, T_SOURCE, device="cpu", port_angles=[170.0],
            sources=tser.stack_sources(T_SOURCE, x=XS))
    with pytest.raises(ValueError, match="outside"):
        tser.run_series_vmapped(
            T_SIMPLE, device="cpu",
            sources=tser.stack_sources(T_SOURCE, x=[-60.0, -99.0]))


def test_run_series_writes_the_reference_folders(tmp_path):
    """The sequential loop against JAX's: the same folders and file
    names (``_1`` for the repeat) for sources x port angles x repeats, the
    seed going up by one per run."""
    kw = dict(port_angles=[164.0, 170.0], repeats=2, n_rays=1500,
              prefix="portAngleSweep", seed=7, verbose=False)
    jr = jser.run_series(SIMPLE, SOURCE_OVERNIGHT, grid=GRID,
                         sources=[SOURCE_OVERNIGHT,
                                  SOURCE_OVERNIGHT.with_(x=-40.0)],
                         save_root=str(tmp_path / "j"), **kw)
    tr = tser.run_series(T_SIMPLE, T_SOURCE, device="cpu", grid=T_GRID,
                         sources=[T_SOURCE, T_SOURCE.with_(x=-40.0)],
                         save_root=str(tmp_path / "t"), **kw)
    assert len(tr) == len(jr) == 8

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert "portAngleSweep_-40_0_-75_170" in os.listdir(tmp_path / "t")
    assert sum(f.endswith("_1.csv") for f in tree(tmp_path / "t")) == 4
    # repeats are different draws of the same scene
    assert not np.array_equal(tr[0].fluxmap, tr[1].fluxmap)
    assert tser.run_series(T_SIMPLE, T_SOURCE, device="cpu", grid=T_GRID,
                           save_root=None, repeats=1, n_rays=500,
                           verbose=False)[0].path is None
