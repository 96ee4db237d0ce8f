"""Port parity: the wave-compaction tracer (``trace_rays_waves``,
``trace_waves_from_state``, ``waves_safe``) against the JAX package's.

The two packages draw from different streams, so the traces are held
statistically: exit fraction and mean bounce count within 4 sigma, and the
overflow counts of both packages (zero with a sound schedule, nonzero with
an undersized one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
from altair_tpu.core.geometry import Vec3 as JVec3
from altair_tpu.core.trace_waves import (trace_rays_waves as j_waves,
                                         trace_waves_from_state as j_from_state,
                                         waves_safe as j_safe)
from altair_tpu_torch import convert
from altair_tpu_torch.core import trace_waves
from altair_tpu_torch.core.geometry import Vec3
from altair_tpu_torch.core.trace import ABSORBED, EXITED, RUNNING

torch.set_num_threads(1)

N = 32_768
SCENE = SCENE_OPTIMIZE.with_(max_bounces=1024, exact_rim=False)
# four waves (32768 -> 8192 -> 2048 -> 1024 lanes) and a tail: 128
# iterations leave ~10% of the rays alive, inside the 4x shrink
KW = dict(wave_iters=128, shrink=4, min_wave=1024)


def _assert_same_law(a_status, a_bounces, b_status, b_bounces):
    """Exit fraction and mean bounce count within 4 sigma (the standard
    error of a difference of two independent means)."""
    for name, a, b in (("exit fraction", a_status == EXITED,
                        b_status == EXITED),
                       ("mean bounces", a_bounces, b_bounces)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        sigma = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 4 * sigma, \
            (name, a.mean(), b.mean(), sigma)


@functools.cache
def _jax_waves():
    res, ovf = jax.jit(lambda k: j_waves(k, SCENE, SOURCE_OVERNIGHT, N,
                                         **KW))(jax.random.key(4))
    return res, int(ovf)


def test_wave_schedule():
    """The static plan the tracer follows: the shrinking widths, the
    first-wave override, and the tail's remaining iterations."""
    assert trace_waves.wave_schedule(N, 1024, **KW) == (
        [(32768, 128), (8192, 128), (2048, 128), (1024, 128)], (1024, 512))
    assert trace_waves.wave_schedule(N, 300, 128, 4, 1024, 16) == (
        [(32768, 16), (8192, 128), (2048, 128), (1024, 28)], None)
    assert trace_waves.wave_schedule(2048, 96, 96, 4, 16384) == (
        [(2048, 96)], None)


def test_waves_matches_jax():
    ref, j_ovf = _jax_waves()
    trace_waves.wave_plans.clear()
    res, ovf = trace_waves.trace_rays_waves(
        torch.Generator().manual_seed(4), convert.scene(SCENE),
        convert.source(SOURCE_OVERNIGHT), N, device="cpu", **KW)
    assert int(ovf) == j_ovf == 0
    # the run records the plan it followed
    waves, tail = trace_waves.wave_schedule(N, int(SCENE.max_bounces), **KW)
    assert list(trace_waves.wave_plans) == [
        {"width": N, "waves": waves, "tail": tail}]
    st = res.status.numpy()
    assert set(np.unique(st)) <= {1, 2}
    assert (res.last_point.z.numpy()[st == EXITED] < -100.0).mean() > 0.99
    _assert_same_law(st, res.n_bounces.numpy(), np.asarray(ref.status),
                     np.asarray(ref.n_bounces))


def _live_state(n):
    """A source batch of n rays with 30% live lanes (every 10th lane's
    first three), as numpy arrays: ``(pos, dir, status, live)``."""
    src = SOURCE_OVERNIGHT
    d = np.array([src.dir_x, src.dir_y, src.dir_z], np.float32)
    d /= np.linalg.norm(d)
    pos = [np.full(n, v, np.float32) for v in (src.x, src.y, src.z)]
    dirs = [np.full(n, v, np.float32) for v in d]
    live = (np.arange(n) % 10) < 3
    status = np.where(live, RUNNING, ABSORBED).astype(np.int32)
    return pos, dirs, status, live


def test_waves_from_state_matches_jax():
    """From a mid-flight state with 30% live lanes and a short first wave
    (the rim continuation's knob): the live lanes follow the same law in
    both packages, dead lanes stay as they were, no overflow."""
    kw = dict(KW, first_wave_iters=16)
    pos, dirs, status, live = _live_state(N)

    def state(vec, arr, zeros_b):
        p, d = vec(*map(arr, pos)), vec(*map(arr, dirs))
        return (p, d, p, arr(status), arr(np.zeros(N, np.int32)), zeros_b)

    jstate = state(JVec3, jnp.asarray, jnp.zeros(N, bool))
    ref, j_ovf = jax.jit(lambda k: j_from_state(
        k, SCENE, jstate, TraceConfig(), **kw))(jax.random.key(7))
    tstate = state(Vec3, torch.from_numpy, torch.zeros(N, dtype=torch.bool))
    res, ovf = trace_waves.trace_waves_from_state(
        torch.Generator().manual_seed(7), convert.scene(SCENE), tstate,
        device="cpu", **kw)
    assert int(ovf) == int(j_ovf) == 0
    st = res.status.numpy()
    assert ((st[live] == 1) | (st[live] == 2)).all()
    assert (st[~live] == ABSORBED).all()
    assert (res.n_bounces.numpy()[~live] == 0).all()
    _assert_same_law(st[live], res.n_bounces.numpy()[live],
                     np.asarray(ref.status)[live],
                     np.asarray(ref.n_bounces)[live])


def test_undersized_shrink_overflows_in_both():
    """8 iterations kill ~13% of the rays, so a 64x shrink cannot hold the
    survivors: both packages count the lost rays, and suspend them."""
    kw = dict(wave_iters=8, shrink=64, min_wave=16)
    n = 4096
    _, j_ovf = jax.jit(lambda k: j_waves(k, SCENE, SOURCE_OVERNIGHT, n,
                                         **kw))(jax.random.key(1))
    res, ovf = trace_waves.trace_rays_waves(
        torch.Generator().manual_seed(1), convert.scene(SCENE),
        convert.source(SOURCE_OVERNIGHT), n, device="cpu", **kw)
    assert int(j_ovf) > 0 and int(ovf) > 0
    # ~87% of the batch survives the first wave; 64 lanes go on
    assert abs(int(ovf) - int(j_ovf)) < 0.05 * n
    assert (res.status.numpy() == 3).sum() >= int(ovf)


@pytest.mark.parametrize("theta,rho,iters,shrink", [
    (170.0, 0.99, 256, 16), (170.0, 0.99, 128, 4), (170.0, 0.99, 32, 4),
    (176.0, 0.999, 256, 16), (160.0, 0.9, 96, 4)])
def test_waves_safe_matches_jax(theta, rho, iters, shrink):
    scene = SCENE.with_(theta_max_deg=theta, reflectance=rho)
    assert (trace_waves.waves_safe(convert.scene(scene), iters, shrink)
            == j_safe(scene, iters, shrink))
