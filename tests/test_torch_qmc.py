"""Port parity of the Sobol/QMC option (``altair_tpu_torch/core/qmc.py``):
the generator and both randomisations bit for bit against
``altair_tpu.core.qmc``, the direct sampler on a Sobol block elementwise
against JAX's ``qmc=1`` trace, and the accuracy claim of
``tests/test_qmc.py`` on the port's own streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, TraceConfig
from altair_tpu.core import qmc as jqmc
from altair_tpu.core.trace_direct import trace_rays_direct as j_direct
from altair_tpu_torch import convert
from altair_tpu_torch import TraceConfig as TCfg
from altair_tpu_torch.core import qmc as tqmc
from altair_tpu_torch.core.trace import EXITED, _source_rays
from altair_tpu_torch.core.trace_direct import (trace_direct_from_uniforms,
                                                trace_rays_direct)
from altair_tpu_torch.core.route import trace_rays_auto

torch.set_num_threads(1)

SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096, exact_rim=False)


def _jax_words(key, dim):
    """The ``[dim, 1]`` randomisation words JAX's ``sobol_uniforms`` draws
    from ``key``."""
    return torch.from_numpy(np.asarray(
        jax.random.bits(key, (dim, 1), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 1000, 4097])
def test_sobol_bits_bit_equal(n):
    """Every dimension 1..16: a dimension's row does not depend on how many
    dimensions are drawn, so JAX's 16-dim block holds the reference for
    each."""
    ref = np.asarray(jqmc.sobol_bits(n, jqmc.MAX_DIM)).astype(np.int64)
    assert tqmc.MAX_DIM == jqmc.MAX_DIM
    for dim in range(1, tqmc.MAX_DIM + 1):
        np.testing.assert_array_equal(tqmc.sobol_bits(n, dim).numpy(),
                                      ref[:dim], err_msg=f"dim {dim}")


@pytest.mark.parametrize("mode", ["shift", "owen"])
def test_sobol_uniforms_bit_equal(mode):
    """Fed JAX's own words, both randomisations give JAX's float32 values
    exactly."""
    key = jax.random.key(11)
    ref = np.asarray(jqmc.sobol_uniforms(key, 4097, 7, mode=mode))
    out = tqmc.sobol_uniforms_from_words(_jax_words(key, 7), 4097, 7,
                                         mode=mode)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_direct_sampler_on_sobol_block():
    """``trace_direct_from_uniforms`` on the shifted Sobol block equals
    JAX's ``trace_rays_direct`` with ``qmc=1`` on the same key: status and
    bounce counts exactly; on EXITED lanes the segment start (on the
    sphere) within 1e-4 cm and the direction within 1e-5.  The last point
    lies ~300 cm out on the box, where an ulp of direction (XLA and torch
    trig differ by one or two) moves it by a few float32 ulps of 3e-5 cm:
    it is held to 1e-3 cm, as in tests/test_torch_trace_direct.py."""
    n = 8192
    key = jax.random.key(2025)
    ref = j_direct(key, SCENE, SOURCE_OVERNIGHT, n, TraceConfig(qmc=1))
    u = tqmc.sobol_uniforms_from_words(_jax_words(key, 7), n, 7)
    pos0, dir0 = _source_rays(convert.source(SOURCE_OVERNIGHT), n,
                              torch.float32, "cpu")
    out = trace_direct_from_uniforms(u, convert.scene(SCENE), pos0, dir0,
                                     torch.zeros(n, dtype=torch.int32))
    status = np.asarray(ref.status)
    np.testing.assert_array_equal(out.status.numpy(), status)
    np.testing.assert_array_equal(out.n_bounces.numpy(),
                                  np.asarray(ref.n_bounces))
    ex = status == EXITED
    assert ex.sum() > 1000
    for field, tol in (("seg_start", 1e-4), ("direction", 1e-5),
                       ("last_point", 1e-3)):
        for c in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(out, field), c).numpy()[ex],
                np.asarray(getattr(getattr(ref, field), c))[ex],
                rtol=0, atol=tol, err_msg=f"{field}.{c}")


def _chain_exit_prob(scene) -> float:
    """Closed-form P(EXITED) of the direct chain when the first flight does
    not escape (true for SOURCE_OVERNIGHT), as in tests/test_qmc.py."""
    f = (1.0 + np.cos(np.deg2rad(scene.theta_max_deg))) / 2.0
    rho = scene.reflectance
    return rho * f / (1.0 - (1.0 - f) * rho)


@pytest.mark.parametrize("qmc", [1, 2])
def test_qmc_exit_fraction_beats_mc(qmc):
    """Mirrors tests/test_qmc.py::test_qmc_exit_fraction_beats_mc on the
    port's streams: the RMSE of the exit fraction across 16 independent
    randomisations sits below half the binomial sem, below the
    pseudorandom path's RMSE, and the mean is unbiased."""
    n, reps = 4096, 16
    truth = _chain_exit_prob(SCENE)
    scene, src = convert.scene(SCENE), convert.source(SOURCE_OVERNIGHT)

    def est(cfg, seed0):
        return np.array([float((trace_rays_direct(
            torch.Generator().manual_seed(seed0 + i), scene, src, n, cfg,
            device="cpu").status == EXITED).float().mean())
            for i in range(reps)])

    q = est(TCfg(qmc=qmc), 100)
    m = est(TCfg(), 200)
    rmse_q = float(np.sqrt(np.mean((q - truth) ** 2)))
    rmse_m = float(np.sqrt(np.mean((m - truth) ** 2)))
    sem = float(np.sqrt(truth * (1 - truth) / n))
    assert rmse_q < 0.5 * sem, (rmse_q, sem)
    assert rmse_q < rmse_m, (rmse_q, rmse_m)
    assert abs(q.mean() - truth) < 4 * sem / np.sqrt(reps) + 1e-3


@pytest.mark.parametrize("qmc", [1, 2])
def test_qmc_composes_with_rim_deferral(qmc):
    """An exact-rim scene runs the direct main trace and the hybrid's
    closed-form finish on Sobol blocks; the exit fraction stays in the
    window of tests/test_qmc.py::test_qmc_composes_with_rim_deferral (at
    50k rays, half of its 100k), no overflow, and the same key reproduces
    the trace."""
    scene = convert.scene(SCENE_OPTIMIZE.with_(max_bounces=4096))

    def run():
        return trace_rays_auto(torch.Generator().manual_seed(5), scene,
                               convert.source(SOURCE_OVERNIGHT), 50_000,
                               TCfg(qmc=qmc), device="cpu")

    (res, ovf), (res2, _) = run(), run()
    assert int(ovf) == 0
    np.testing.assert_array_equal(res.status.numpy(), res2.status.numpy())
    frac = float(res.exited_port_mask().float().mean())
    assert 0.418 < frac < 0.433, frac


def test_qmc_guards():
    with pytest.raises(ValueError):
        tqmc.sobol_bits(8, tqmc.MAX_DIM + 1)
    with pytest.raises(ValueError):
        tqmc.sobol_uniforms(torch.Generator(), 8, 2, mode="bogus")
