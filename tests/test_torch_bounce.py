"""Port parity: the bounce kernel's plain PyTorch version against the Pallas
``_bounce_kernel`` run in the TPU interpreter, per lane.

Both draw from the counter-based hash generator (``hw_prng=False`` on the
JAX side, ``rng="hash"`` on the port's), seeded with the same JAX key
words, so each lane sees the same uniforms and the comparison is per lane.
The CUDA kernel itself is held against this plain version on the card
(``tests/test_torch_bounce_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel, TraceConfig
from altair_tpu.core.trace_pallas import _fmix32, trace_rays_pallas
from altair_tpu_torch import convert
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.core.trace import EXITED
from altair_tpu_torch.io import profiling

torch.set_num_threads(1)

N = 16_384
MAX_BOUNCES = 64


@functools.cache
def _pallas_ref(model):
    """The Pallas kernel in the interpreter (software hash stream) at N
    rays, simple mode: ``(key, TraceResult)``, cached per law because the
    interpreter takes seconds a run."""
    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False,
                                 surface_model=model)
    key = jax.random.key(int(model) + 7)
    return key, trace_rays_pallas(key, scene, SOURCE_OVERNIGHT, N,
                                  TraceConfig(), interpret=True,
                                  hw_prng=False)


def _operands(model):
    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False,
                                 surface_model=model)
    return trace_cuda.kernel_operands(
        convert.scene(scene), convert.source(SOURCE_OVERNIGHT), "cpu")


def launches(kernel: str) -> int:
    """The kernel's launches in this process (the tracer's process total)."""
    return profiling.records()["totals"].get(f"kernel.{kernel}.launches", 0)


def _hash_plain(model):
    """The port's bounce on CPU tensors (its plain version), hash stream,
    seeded with the words of ``_pallas_ref``'s key."""
    key, _ = _pallas_ref(model)
    scene_vec, src_vec = _operands(model)
    before = launches("bounce")
    out = trace_cuda.bounce(convert.seed_words(jax.random.key_data(key)),
                            scene_vec, src_vec, N, int(model), MAX_BOUNCES,
                            rng="hash")
    assert launches("bounce") == before  # CPU: plain path
    return out


def _assert_same_law(out, ref):
    """Exit fraction and mean bounce count of two traces agree within 4
    sigma (the standard error of a difference of two independent means;
    conservative where both use one stream)."""
    for name, a, b in (
            ("exit fraction", out.status.numpy() == EXITED,
             np.asarray(ref.status) == EXITED),
            ("mean bounces", out.n_bounces.numpy(),
             np.asarray(ref.n_bounces))):
        a, b = a.astype(np.float64), b.astype(np.float64)
        sigma = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 4 * sigma, \
            (name, a.mean(), b.mean(), sigma)


@pytest.mark.parametrize("model,max_bounces", [
    (SurfaceModel.LAMBERTIAN, MAX_BOUNCES),
    (SurfaceModel.MIXED_BRDF, MAX_BOUNCES),
    (SurfaceModel.COS_N_LOBE, MAX_BOUNCES),
])
def test_plain_bounce_matches_pallas_per_lane(model, max_bounces):
    """Status and bounce count agree on >= 99.9% of lanes.  Positions are
    compared on the agreeing lanes: >= 99% within 1e-2 cm.  XLA's and
    torch's float32 sin/cos/rsqrt differ by an ulp or two, and that drift
    accumulates bounce by bounce, so positions are not bit-equal; the
    statuses are, because the draws are.

    SPECULAR is held statistically instead
    (``test_plain_specular_matches_pallas``)."""
    _, ref = _pallas_ref(model)
    out = _hash_plain(model)
    agree = ((out.status.numpy() == np.asarray(ref.status))
             & (out.n_bounces.numpy() == np.asarray(ref.n_bounces)))
    assert agree.mean() >= 0.999, agree.mean()
    assert int(out.n_bounces.max()) <= max_bounces
    for field in ("last_point", "seg_start"):
        err = np.max([np.abs(getattr(getattr(out, field), c).numpy()
                             - np.asarray(getattr(getattr(ref, field), c)))
                      for c in "xyz"], axis=0)[agree]
        assert (err <= 1e-2).mean() >= 0.99, (field, np.quantile(err, 0.99))
    assert (out.status.numpy() == EXITED).mean() > 0.2


def test_plain_specular_matches_pallas():
    """SPECULAR's near-mirror chain (roughness 0.01) amplifies the ulp
    drift between XLA's and torch's float32 trig to ~1e-2 cm within 16
    bounces and flips a few tenths of a percent of the cap tests by 64, so
    it is not held to the per-lane criterion: >= 99% of lanes agree, and
    the exit fraction and mean bounce count are within 4 sigma of the
    Pallas kernel's."""
    _, ref = _pallas_ref(SurfaceModel.SPECULAR)
    out = _hash_plain(SurfaceModel.SPECULAR)
    agree = ((out.status.numpy() == np.asarray(ref.status))
             & (out.n_bounces.numpy() == np.asarray(ref.n_bounces)))
    assert agree.mean() >= 0.99, agree.mean()
    _assert_same_law(out, ref)


def test_hash_draws_bit_equal():
    """The plain version's int64 hash is the Pallas kernel's ``_fmix32``
    and ``_sw_uniform`` formula, bit for bit (``_sw_uniform`` itself only
    runs inside a Pallas kernel, so its formula is restated here in jnp)."""
    lane = np.arange(0, 1 << 21, 32, dtype=np.uint32).reshape(-1, 128)
    seed = np.uint32(0xDEADBEEF)
    lane_h = _fmix32(jnp.asarray(lane) ^ seed)
    t_lane_h = trace_cuda._fmix32(torch.from_numpy(lane.astype(np.int64))
                                  ^ int(seed))
    np.testing.assert_array_equal(t_lane_h.numpy(),
                                  np.asarray(lane_h).astype(np.int64))
    for it, nd in ((0, 3), (5, 7), (4095, 37)):
        ref = [np.asarray((_fmix32(lane_h + jnp.uint32(it * nd + i)
                                   * jnp.uint32(0x9E3779B9)) >> 8)
                          .astype(jnp.float32) * np.float32(2.0 ** -24))
               for i in range(nd)]
        got = trace_cuda._hash_draws(t_lane_h, it, nd)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), r)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors (Random123 kat_vectors)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = trace_cuda.philox4x32_10(
            *(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
        assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("model", list(SurfaceModel))
def test_philox_mode_physics(model):
    """The production (philox) stream: every law traces, exits leave
    through the port plane, absorptions sit on the shell, a rerun is
    identical, and the exit fraction and mean bounce count are within 4
    sigma of the Pallas kernel's (hash stream) under the same law and
    cap."""
    scene_vec, src_vec = _operands(model)
    n = 4000          # the kernel takes any N: no block multiple
    out = trace_cuda.bounce((123, 456), scene_vec, src_vec, n, int(model),
                            MAX_BOUNCES, rng="philox")
    st = out.status.numpy()
    assert set(np.unique(st)) <= {1, 2, 3}
    assert (out.last_point.z.numpy()[st == EXITED] < -100.0).all()
    p = np.stack([c.numpy() for c in out.last_point])[:, st == 2]
    np.testing.assert_allclose(np.linalg.norm(p, axis=0), 100.1, atol=1e-2)
    again = trace_cuda.bounce((123, 456), scene_vec, src_vec, n, int(model),
                              MAX_BOUNCES, rng="philox")
    np.testing.assert_array_equal(again.n_bounces.numpy(),
                                  out.n_bounces.numpy())
    _assert_same_law(out, _pallas_ref(model)[1])


def test_wrapper_guards():
    scene = convert.scene(SCENE_OPTIMIZE.with_(exact_rim=False))
    sv, srcv = trace_cuda.kernel_operands(
        scene, convert.source(SOURCE_OVERNIGHT), "cpu")
    with pytest.raises(ValueError):
        trace_cuda.bounce((1, 2), sv, srcv, 8, 0, 16, rng="threefry")
    with pytest.raises(ValueError):
        trace_cuda.bounce((1, 2), sv.double(), srcv, 8, 0, 16)
    with pytest.raises(ValueError):
        trace_cuda.bounce((1, 2), sv[:4], srcv, 8, 0, 16)
    with pytest.raises(ValueError):
        trace_cuda.bounce((1, 2), sv.to("meta"), srcv.to("meta"), 8, 0, 16)
    with pytest.raises(NotImplementedError):
        trace_cuda.trace_rays_bounce(torch.Generator(),
                                     scene.with_(exact_rim=True),
                                     convert.source(SOURCE_OVERNIGHT), 8,
                                     device="cpu")
    empty = trace_cuda.bounce((1, 2), sv, srcv, 0, 0, 16)
    assert empty.status.shape == (0,)
