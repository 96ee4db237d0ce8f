"""Port parity of the in-sphere disk scorer (``core/score.py``) and of
``sweep/insphere.py`` against ``altair_tpu`` on the CPU: the placement and
the hit test elementwise (rtol 1e-5, atol 1e-4 cm) on the same inputs, the
``detector_sweep3.txt`` dialect byte for byte, and the sweep's profile
statistically (the streams differ)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu.config import (SCENE_INSPHERE, SCENE_OPTIMIZE, SOURCE_DEMO,
                               SOURCE_OVERNIGHT)
from altair_tpu.core import geometry as jgeo
from altair_tpu.core import score as jscore
from altair_tpu.core.trace_waves import trace_rays_auto as j_auto
from altair_tpu.sweep import insphere as jins
from altair_tpu_torch import convert
from altair_tpu_torch.core import geometry as tgeo
from altair_tpu_torch.core import score as tscore
from altair_tpu_torch.sweep import insphere as tins

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
THETAS = np.concatenate([RNG.uniform(-60, 60, 61), [0.0, 45.0, -45.0]]
                        ).astype(np.float32)
PHIS = np.concatenate([RNG.uniform(0, 360, 61), [0.0, 180.0, 0.0]]
                      ).astype(np.float32)


@pytest.mark.parametrize("aimed", [False, True])
def test_disk_position_matches_jax(aimed):
    """Centres and normals elementwise, for the reference's phi-independent
    tilted normal and for the aimed one; the tilted normal has no y
    component and does not depend on phi."""
    jc, jn = jscore.insphere_disk_position(jnp.asarray(THETAS),
                                           jnp.asarray(PHIS), 200.0, -100.0,
                                           aimed=aimed)
    tc, tn = tscore.insphere_disk_position(torch.from_numpy(THETAS),
                                           torch.from_numpy(PHIS), 200.0,
                                           -100.0, aimed=aimed)
    for j, t in zip(tuple(jc) + tuple(jn), tuple(tc) + tuple(tn)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_allclose(tn.norm2().numpy(), 1.0, atol=1e-5)
    if not aimed:
        assert (tn.y == 0).all()
        _, tn2 = tscore.insphere_disk_position(
            torch.from_numpy(THETAS), torch.from_numpy(PHIS) + 77.0)
        # phi moves the centre's azimuth only: |d_xy| and d_z stay, up to
        # float32 rounding of the centre
        np.testing.assert_allclose(tn2.stack().numpy(), tn.stack().numpy(),
                                   atol=1e-5)


@functools.cache
def _jax_trace():
    """4000 rays of the production scene traced by the JAX package."""
    return j_auto(jax.random.key(2), SCENE_OPTIMIZE.with_(max_bounces=1024),
                  SOURCE_OVERNIGHT, 4000)


def test_hit_mask_matches_jax_on_a_jax_trace():
    """``insphere_disk_hit_mask`` / ``hits_insphere_disk`` on a JAX
    ``TraceResult`` carried across: the same mask per ray for a scalar disk
    and for a disk per ray, the same counts, and the batched
    ``hits_insphere_disks`` equal to the loop over positions.  The disks
    are big (40 cm) so that hundreds of rays hit."""
    jres = _jax_trace()
    tres = convert.trace_result(jres, "cpu")
    th = np.float32([-30.0, -5.0, 0.0, 5.0, 20.0, 45.0])
    ph = np.float32([0.0, 180.0, 0.0, 0.0, 180.0, 0.0])
    jc, jn = jscore.insphere_disk_position(jnp.asarray(th), jnp.asarray(ph))
    tc, tn = tscore.insphere_disk_position(torch.from_numpy(th),
                                           torch.from_numpy(ph))
    total = 0
    for i in range(len(th)):
        jm = np.asarray(jscore.insphere_disk_hit_mask(
            jres, jgeo.Vec3(jc.x[i], jc.y[i], jc.z[i]),
            jgeo.Vec3(jn.x[i], jn.y[i], jn.z[i]), 40.0))
        tm = tscore.insphere_disk_hit_mask(
            tres, tgeo.Vec3(tc.x[i], tc.y[i], tc.z[i]),
            tgeo.Vec3(tn.x[i], tn.y[i], tn.z[i]), 40.0)
        np.testing.assert_array_equal(tm.numpy(), jm)
        jh = int(jscore.hits_insphere_disk(
            jres, jgeo.Vec3(jc.x[i], jc.y[i], jc.z[i]),
            jgeo.Vec3(jn.x[i], jn.y[i], jn.z[i]), 40.0))
        assert int(tscore.hits_insphere_disk(
            tres, tgeo.Vec3(tc.x[i], tc.y[i], tc.z[i]),
            tgeo.Vec3(tn.x[i], tn.y[i], tn.z[i]), 40.0)) == jh == jm.sum()
        total += jh
    assert total > 300
    # a disk per ray (the retrace path's gather)
    owner = np.arange(4000) % len(th)
    jm = np.asarray(jscore.insphere_disk_hit_mask(
        jres, jgeo.Vec3(jc.x[owner], jc.y[owner], jc.z[owner]),
        jgeo.Vec3(jn.x[owner], jn.y[owner], jn.z[owner]), 40.0))
    tm = tscore.insphere_disk_hit_mask(
        tres, tgeo.Vec3(tc.x[owner], tc.y[owner], tc.z[owner]),
        tgeo.Vec3(tn.x[owner], tn.y[owner], tn.z[owner]), 40.0)
    np.testing.assert_array_equal(tm.numpy(), jm)
    # all disks at once, in blocks that do not divide P
    batched = tscore.hits_insphere_disks(tres, tc.stack(), tn.stack(), 40.0,
                                         pos_block=4)
    loop = [int(tscore.hits_insphere_disk(
        tres, tgeo.Vec3(tc.x[i], tc.y[i], tc.z[i]),
        tgeo.Vec3(tn.x[i], tn.y[i], tn.z[i]), 40.0)) for i in range(len(th))]
    assert batched.tolist() == loop and batched.dtype == torch.int32


def test_hit_needs_a_forward_exit():
    """The disk absorbs: a ray whose line meets the disk behind its final
    segment (t < 0), or that did not exit, is no hit."""
    one = torch.ones(3)
    res = convert.trace_result(_jax_trace(), "cpu")._replace(
        status=torch.tensor([1, 1, 2], dtype=torch.int32),
        seg_start=tgeo.Vec3(0 * one, 0 * one, -100 * one),
        direction=tgeo.Vec3(0 * one, 0 * one, torch.tensor([-1.0, 1.0, -1.0])),
        last_point=tgeo.Vec3(0 * one, 0 * one, -300 * one),
        n_bounces=torch.zeros(3, dtype=torch.int32))
    c, n = tscore.insphere_disk_position(torch.tensor(0.0), torch.tensor(0.0))
    assert tscore.insphere_disk_hit_mask(res, c, n, 5.0).tolist() == [
        True, False, False]


def test_fmt_and_dialect_match_jax(tmp_path):
    """``_fmt`` on the sweep's own numpy values, and a sweep file written
    by each package read back by both readers: the same header, the same
    theta and phi columns byte for byte, fractions that round-trip."""
    vals = list(np.arange(-45.0, 45.25, 0.5)) + [0.1 + 0.2, 1e-5, 123456.7,
                                                  np.float64(3) / 7, 0.0]
    assert [tins._fmt(v) for v in vals] == [jins._fmt(v) for v in vals]
    assert tins._fmt(np.arange(-1.0, 1.0, 0.5)[1]) == "-0.5"
    scene = SCENE_OPTIMIZE.with_(max_bounces=512, exact_rim=False)
    kw = dict(n_rays=3000, dtheta=7.5, theta_max=45.0, disk_radius=30.0)
    jr = jins.sweep_insphere_detector(scene, SOURCE_OVERNIGHT,
                                      save_path=str(tmp_path / "j.txt"), **kw)
    tr = tins.sweep_insphere_detector(convert.scene(scene),
                                      convert.source(SOURCE_OVERNIGHT),
                                      device="cpu",
                                      save_path=str(tmp_path / "t.txt"), **kw)
    np.testing.assert_array_equal(tr.thetas, jr.thetas)
    np.testing.assert_array_equal(tr.phis, jr.phis)
    jl = (tmp_path / "j.txt").read_text().splitlines()
    tl = (tmp_path / "t.txt").read_text().splitlines()
    assert tl[0] == jl[0] == "Theta(deg)\tPhi(deg)\tHitFraction"
    assert len(tl) == len(jl) == 1 + 13 * 2
    assert [ln.split("\t")[:2] for ln in tl] == [ln.split("\t")[:2]
                                                 for ln in jl]
    for reader in (tins.read_detector_sweep, jins.read_detector_sweep):
        th, ph, fr = reader(str(tmp_path / "t.txt"))
        np.testing.assert_array_equal(th, tr.thetas)
        np.testing.assert_array_equal(ph, tr.phis)
        np.testing.assert_allclose(fr, tr.fractions, rtol=1e-5, atol=1e-9)
    assert tr.fractions.sum() > 0 and tr.n_rays == 3000


# the corpus scene (thick rim: the in-loop exact-rim trace in both
# packages), shortened so that the CPU loop stays cheap
CORPUS_SCENE = SCENE_INSPHERE.with_(reflectance=0.98, max_bounces=768)


@functools.cache
def _profiles(retrace: bool):
    """(JAX fractions, port fractions, n) of the same sweep."""
    if retrace:
        # a thin-shell Lambertian scene: both packages take the direct
        # sampler, 14 positions in chunks of 8 (the last one padded)
        scene = SCENE_OPTIMIZE.with_(exact_rim=False, max_bounces=1024)
        kw = dict(n_rays=6000, dtheta=15.0, theta_max=45.0, disk_radius=30.0,
                  retrace=True, seed=3, save_path=None)
    else:
        scene = CORPUS_SCENE
        kw = dict(n_rays=12000, dtheta=5.0, theta_max=45.0, disk_radius=20.0,
                  seed=3, save_path=None)
    jr = jins.sweep_insphere_detector(scene, SOURCE_DEMO, **kw)
    tr = tins.sweep_insphere_detector(convert.scene(scene),
                                      convert.source(SOURCE_DEMO),
                                      device="cpu", **kw)
    return jr.fractions, tr.fractions, kw["n_rays"]


@pytest.mark.parametrize("retrace", [False, True])
def test_sweep_profile_matches_jax(retrace):
    """Hit fractions per position within 4 sigma of the JAX package's at
    the same N (two independent binomial estimates; sigma from JAX's
    fraction floored at one hit), and the profile's total within 4 sigma.
    Trace-once positions share one batch, so their total is held to the
    sum of the per-position sigmas."""
    jf, tf, n = _profiles(retrace)
    assert jf.shape == tf.shape == ((14,) if retrace else (38,))
    p = np.maximum(jf, 1.0 / n)
    sigma = np.sqrt(2 * p * (1 - p) / n)
    assert (np.abs(tf - jf) < 4 * sigma).all(), (tf, jf)
    assert jf.sum() > 20 / n
    tot_sigma = sigma.sum() if not retrace else np.sqrt((sigma ** 2).sum())
    assert abs(tf.sum() - jf.sum()) < 4 * tot_sigma


def test_retrace_agrees_with_trace_once_and_is_chunk_keyed():
    """Port only: the retrace fractions lie within 5 sigma of a trace-once
    run of 8x the rays; a padded last chunk (P = 14, chunk 4) changes no
    fraction's law; and the first chunk's positions do not depend on how
    many chunks follow (chunk i is keyed by ``fold_in(key, i)``)."""
    scene = convert.scene(SCENE_OPTIMIZE.with_(exact_rim=False,
                                               max_bounces=1024))
    src = convert.source(SOURCE_DEMO)
    kw = dict(device="cpu", disk_radius=30.0, dtheta=15.0, seed=5,
              save_path=None)
    once = tins.sweep_insphere_detector(scene, src, n_rays=32000, **kw)
    re4 = tins.sweep_insphere_detector(scene, src, n_rays=4000, retrace=True,
                                       pos_chunk=4, **kw)
    p = np.maximum(once.fractions, 1 / 32000)
    sigma = np.sqrt(p * (1 - p) * (1 / 4000 + 1 / 32000))
    assert (np.abs(re4.fractions - once.fractions) < 5 * sigma).all()
    short = tins.sweep_insphere_detector(scene, src, n_rays=4000,
                                         retrace=True, pos_chunk=4,
                                         theta_max=15.0, **kw)
    assert short.fractions.shape == (6,) and re4.fractions.shape == (14,)
    # theta -15..15 are positions 4..9 of the long sweep but 0..5 of the
    # short one: other chunks, other streams, the same law
    assert not np.array_equal(short.fractions, re4.fractions[4:10])
    again = tins.sweep_insphere_detector(scene, src, n_rays=4000,
                                         retrace=True, pos_chunk=4, **kw)
    np.testing.assert_array_equal(again.fractions, re4.fractions)
