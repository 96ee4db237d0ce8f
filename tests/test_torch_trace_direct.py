"""Port parity: the closed-form direct sampler, fed JAX's own uniforms, is
elementwise equal to ``altair_tpu``'s ``trace_rays_direct`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SOURCE_V1, TraceConfig
from altair_tpu.core.trace_direct import trace_rays_direct as j_direct
from altair_tpu_torch import convert
from altair_tpu_torch.core.trace import EXITED, SUSPENDED, _source_rays
from altair_tpu_torch.core.trace_direct import (trace_direct_from_uniforms,
                                                trace_rays_direct)

torch.set_num_threads(1)

N = 16_384
CASES = {
    "production": (SCENE_OPTIMIZE.with_(exact_rim=False, max_bounces=4096),
                   SOURCE_OVERNIGHT),
    # a low cap and a lossless wall: many SUSPENDED lanes
    "suspending": (SCENE_OPTIMIZE.with_(exact_rim=False, max_bounces=24,
                                        reflectance=1.0, theta_max_deg=175.0),
                   SOURCE_V1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_sampler_elementwise(case):
    """Status and bounce counts exact on every lane; on EXITED lanes the
    last point and segment start within 1e-3 cm and the direction within
    1e-5 (float32 trig and log differ by an ulp or two between XLA and
    torch; the exit points lie ~300 cm out).  SUSPENDED directions are not
    compared: trace_direct.py:50-56 documents them as a different
    marginal, so no consumer reads them."""
    scene, source = CASES[case]
    key = jax.random.key(2024)
    ref = j_direct(key, scene, source, N, TraceConfig())
    u = np.array(jax.random.uniform(key, (7, N), jnp.float32))
    pos0, dir0 = _source_rays(convert.source(source), N, torch.float32, "cpu")
    out = trace_direct_from_uniforms(torch.from_numpy(u), convert.scene(scene),
                                     pos0, dir0,
                                     torch.zeros(N, dtype=torch.int32))
    status = np.asarray(ref.status)
    np.testing.assert_array_equal(out.status.numpy(), status)
    np.testing.assert_array_equal(out.n_bounces.numpy(),
                                  np.asarray(ref.n_bounces))
    ex = status == EXITED
    assert ex.sum() > 500
    for field, tol in (("last_point", 1e-3), ("seg_start", 1e-3),
                       ("direction", 1e-5)):
        for c in "xyz":
            a = getattr(getattr(out, field), c).numpy()[ex]
            b = np.asarray(getattr(getattr(ref, field), c))[ex]
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=f"{field}.{c}")
    if case == "suspending":
        assert (status == SUSPENDED).sum() > 100


def test_direct_engine_draws_its_own_stream():
    """``trace_rays_direct`` with a torch key: the exit fraction within 4
    sigma of JAX's, reproducible from the seed."""
    scene, source = CASES["production"]
    ref = j_direct(jax.random.key(1), scene, source, N, TraceConfig())
    run = lambda s: trace_rays_direct(
        torch.Generator().manual_seed(s), convert.scene(scene),
        convert.source(source), N, device="cpu")
    a, b = run(5), run(5)
    np.testing.assert_array_equal(a.status.numpy(), b.status.numpy())
    f_t = float((a.status == EXITED).float().mean())
    f_j = float((np.asarray(ref.status) == EXITED).mean())
    sigma = np.sqrt(2 * f_j * (1 - f_j) / N)
    assert abs(f_t - f_j) < 4 * sigma


def test_direct_guards():
    scene, source = CASES["production"]
    s, so = convert.scene(scene), convert.source(source)
    g = torch.Generator()
    with pytest.raises(NotImplementedError):
        trace_rays_direct(g, s.with_(exact_rim=True), so, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        trace_rays_direct(g, s.with_(surface_model=1), so, 8, device="cpu")
    from altair_tpu_torch.config import TraceConfig as TCfg

    # QMC draws run (tests/test_torch_qmc.py holds them against JAX)
    out = trace_rays_direct(g, s, so, 8, TCfg(qmc=1), device="cpu")
    assert out.status.shape == (8,)
