"""Port parity: stream compaction (bit-equal) and the four scatter laws
(statistical) of ``altair_tpu_torch`` against ``altair_tpu`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import altair_tpu.core.compact as jcompact
import altair_tpu.core.geometry as jgeo
import altair_tpu.core.sampling as jsampling
import altair_tpu_torch.core.compact as tcompact
import altair_tpu_torch.core.geometry as tgeo
import altair_tpu_torch.core.sampling as tsampling
from altair_tpu.config import SCENE_OPTIMIZE, SurfaceModel
from altair_tpu_torch import convert

torch.set_num_threads(1)


# below and above the JAX package's 4*1024-lane switch to its blocked path
@pytest.mark.parametrize("n,density,size", [
    (1000, 0.3, 400), (1000, 0.3, 200), (5000, 0.05, 400),
    (70_000, 0.02, 2048), (70_000, 0.02, 1000), (70_001, 0.5, 40_000),
])
def test_nonzero_indices_bit_equal(n, density, size):
    mask = np.random.default_rng(n + size).random(n) < density
    j = np.asarray(jcompact.nonzero_indices(jnp.asarray(mask), size, n))
    t = tcompact.nonzero_indices(torch.from_numpy(mask), size, n)
    assert t.shape == (size,)
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("n,density,size,group_capacity", [
    (70_000, 0.01, 2048, 1024),   # roomy: nothing dropped
    (70_003, 0.01, 2048, 300),    # too few groups: lanes dropped
    (4_000, 0.2, 2000, 64),
])
def test_nonzero_indices_grouped_bit_equal(n, density, size, group_capacity):
    mask = np.random.default_rng(n).random(n) < density
    jidx, jdrop = jcompact.nonzero_indices_grouped(jnp.asarray(mask), size, n,
                                                   group_capacity)
    tidx, tdrop = tcompact.nonzero_indices_grouped(torch.from_numpy(mask),
                                                   size, n, group_capacity)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert int(tdrop) == int(jdrop)
    if group_capacity * 8 < mask.sum():
        assert int(tdrop) > 0


N = 20_000


def _mean_cos(v, n):
    c = (v.x * n.x + v.y * n.y + v.z * n.z)
    c = np.asarray(c, np.float64)
    return c.mean(), c.var(), (c < -1e-6).mean()


@pytest.mark.parametrize("model", list(SurfaceModel))
def test_scatter_law_mean_cosine(model):
    """Mean cosine to the normal of each law within 4 sigma of JAX's
    (independent streams; sigma from both samples' variances), the share
    of directions below the surface likewise (nonzero only for
    MIXED_BRDF's additive tilt, which the reference does not flip back),
    and unit outputs."""
    rng = np.random.default_rng(int(model))
    nrm = rng.normal(size=(3, N)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    inc = rng.normal(size=(3, N)).astype(np.float32)
    inc /= np.linalg.norm(inc, axis=0)
    inc *= -np.sign((inc * nrm).sum(0))       # incident heads into the wall
    scene = SCENE_OPTIMIZE.with_(surface_model=model)

    jn = jgeo.Vec3(*map(jnp.asarray, nrm))
    jd = jgeo.Vec3(*map(jnp.asarray, inc))
    jout = jsampling.scatter(jax.random.key(11), model, jd, jn, scene)
    tn = tgeo.Vec3(*(torch.from_numpy(a.copy()) for a in nrm))
    td = tgeo.Vec3(*(torch.from_numpy(a.copy()) for a in inc))
    tout = tsampling.scatter(torch.Generator().manual_seed(11),
                             convert.scene(scene).surface_model, td, tn,
                             convert.scene(scene))

    jm, jv, jbelow = _mean_cos(jgeo.Vec3(*map(np.asarray, jout)),
                               jgeo.Vec3(*map(np.asarray, jn)))
    tm, tv, tbelow = _mean_cos(tgeo.Vec3(*(a.numpy() for a in tout)),
                               tgeo.Vec3(*(a.numpy() for a in tn)))
    sigma = np.sqrt(jv / N + tv / N)
    assert abs(tm - jm) < 4 * sigma, (tm, jm, sigma)
    p = max(jbelow, 1.0 / N)
    assert abs(tbelow - jbelow) < 4 * np.sqrt(2 * p * (1 - p) / N)
    norm = (tout.x ** 2 + tout.y ** 2 + tout.z ** 2).sqrt()
    np.testing.assert_allclose(norm.numpy(), 1.0, atol=1e-5)


def test_custom_scatter_callable_not_ported():
    """The custom scatter callable is ported now (the name is kept): the
    hook is called as the JAX one, ``(generator, incident, normal, scene)``,
    and its return value is the scattered direction."""
    z = torch.zeros(4)
    v = tgeo.Vec3(z, z, z + 1)
    w = tgeo.Vec3(z + 1, z, z)
    assert tsampling.scatter(torch.Generator(), lambda *a: a[1], v, w,
                             None) is v
    assert tsampling.scatter(torch.Generator(), lambda *a: a[2], v, w,
                             None) is w
