"""Port parity: the trace-once scorer on one shared trace, and the deferred
rim post-pass's exit fractions, against ``altair_tpu`` on the CPU."""

import jax
import numpy as np
import pytest
import torch

import altair_tpu.core.score as jscore
import altair_tpu_torch.core.score as tscore
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid, TraceConfig
from altair_tpu.core.trace import trace_rays_rim_deferred as j_rim
from altair_tpu.core.trace_direct import trace_rays_direct as j_direct
from altair_tpu_torch import convert
from altair_tpu_torch.core.route import trace_rays_rim_deferred
from altair_tpu_torch.core.trace import (EXITED, _put, lossless,
                                         rim_deferred_capacity_shift)
from altair_tpu_torch.core.trace_direct import trace_rays_direct

torch.set_num_threads(1)

N = 20_000
SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096)


@pytest.fixture(scope="module")
def shared():
    """One JAX trace (direct engine + rim post-pass), held by both."""
    res, _ = j_rim(jax.random.key(0), SCENE, SOURCE_OVERNIGHT, N,
                   TraceConfig(), capacity_shift=4, main_tracer=j_direct)
    return res, convert.trace_result(res, "cpu")


@pytest.mark.parametrize("method", ["mxu", "exact"])
def test_scorer_on_shared_trace(shared, method):
    """Tolerances of tests/test_score.py::TestMxuScorer: the two packages
    round pairs on the disk edge differently (float32 matmul summation
    order), so at most 3 flips per position and the total within 1e-4."""
    jres, tres = shared
    grid = DetectorGrid(n_theta=45, n_phi=30)
    j = np.asarray(jscore.fluxmap_trace_once(jres, grid, method=method),
                   np.int64)
    t = tscore.fluxmap_trace_once(tres, convert.grid(grid),
                                  method=method).numpy().astype(np.int64)
    assert t.shape == (45, 30) and j.sum() > 1000
    diff = t - j
    assert np.abs(diff).max() <= 3, np.abs(diff).max()
    assert abs(diff.sum()) / max(j.sum(), 1) < 1e-4


def test_compact_scorer_and_capacity(shared):
    jres, tres = shared
    grid = DetectorGrid(n_theta=12, n_phi=6)
    cap = jscore.exit_capacity(SCENE, N)
    assert tscore.exit_capacity(convert.scene(SCENE), N) == cap
    jc, jo = jscore.fluxmap_trace_once_compact(jres, grid, cap)
    tc, to = tscore.fluxmap_trace_once_compact(tres, convert.grid(grid), cap)
    assert int(jo) == int(to) == 0
    assert np.abs(tc.numpy().astype(np.int64)
                  - np.asarray(jc, np.int64)).max() <= 3
    # an undersized capacity reports exactly the unscored exits
    n_exit = int(tres.exited_port_mask().sum())
    _, ovf = tscore.fluxmap_trace_once_compact(tres, convert.grid(grid),
                                               n_exit - 100)
    assert int(ovf) == 100


@pytest.mark.parametrize("pos_chunk", [1, 7, 64, 1349, 5000])
def test_plain_counts_do_not_depend_on_pos_chunk(shared, pos_chunk):
    """On the CPU ``pos_chunk`` only bounds the plain path's working set:
    every chunking of the 1,350 positions (a last chunk of 1, of 6, one
    chunk of all) gives the counts of the default 1,080."""
    _, tres = shared
    grid = convert.grid(DetectorGrid(n_theta=45, n_phi=30))
    ref = tscore.fluxmap_trace_once(tres, grid)
    assert int(ref.sum()) > 1000
    assert torch.equal(tscore.fluxmap_trace_once(tres, grid,
                                                 pos_chunk=pos_chunk), ref)


def _plucker_operands(n=64, p=10):
    g = torch.Generator().manual_seed(0)
    return dict(E_rel=torch.randn(n, 3, generator=g),
                D=torch.randn(n, 3, generator=g),
                rowmask=torch.ones(n, dtype=torch.bool),
                W=torch.randn(p, 21, generator=g),
                Nrm=torch.randn(p, 3, generator=g))


def _score_launches():
    from altair_tpu_torch.io import profiling

    return profiling.records()["totals"].get("kernel.score.launches", 0)


@pytest.mark.parametrize("bad,error", [
    (dict(E_rel=torch.zeros(64, 3, dtype=torch.float64)), TypeError),
    (dict(W=torch.zeros(10, 20)), ValueError),
    (dict(Nrm=torch.zeros(11, 3)), ValueError),
    (dict(D=torch.zeros(3, 64).T), ValueError),
    (dict(rowmask=torch.ones(64, dtype=torch.int32)), ValueError),
    (dict(rowmask=torch.ones(63, dtype=torch.bool)), ValueError),
    (dict(n_rows=torch.tensor(5)), ValueError),
    (dict(n_rows=torch.tensor([5], dtype=torch.int32)), ValueError),
    (dict(W=torch.zeros(10, 21, device="meta")), ValueError),
    (dict(W=torch.zeros(0, 21), Nrm=torch.zeros(0, 3)), ValueError),
])
def test_plucker_counts_checks_its_arguments(bad, error):
    """The wrapper refuses a wrong dtype, shape, contiguity or device
    before it dispatches, so the kernel never sees them."""
    before = _score_launches()
    with pytest.raises(error):
        tscore.plucker_counts(**{**_plucker_operands(), **bad})
    assert _score_launches() == before


def test_cpu_tensors_take_the_plain_path(shared, monkeypatch):
    """CPU tensors run ``_hits_block_mxu``: the kernel's wrapper is never
    called, ``kernel.score.launches`` stays 0 and the ``score`` span says
    ``engine="torch"``; a row count drops the rows at and past it."""
    from altair_tpu_torch.io import profiling

    def no_kernel(*a, **k):
        raise AssertionError("the CPU path launched the kernel")

    monkeypatch.setattr(tscore, "_plucker_counts_cuda", no_kernel)
    _, tres = shared
    grid = convert.grid(DetectorGrid(n_theta=12, n_phi=6))
    profiling.clear()
    with profiling.tracing():
        counts, ovf = tscore.fluxmap_trace_once_compact(tres, grid, N)
    rec = profiling.records()
    assert int(ovf) == 0 and int(counts.sum()) > 100
    assert rec["totals"].get("kernel.score.launches", 0) == 0
    (sp,) = [s for s in rec["spans"] if s["name"] == "score"]
    assert sp["attrs"]["engine"] == "torch"
    assert not [s for s in rec["spans"] if s["name"] == "kernel.score"]
    ops = _plucker_operands()
    full = tscore.plucker_counts(**ops)
    cut = tscore.plucker_counts(**ops, n_rows=torch.tensor(
        40, dtype=torch.int32))
    ops["rowmask"][40:] = False
    assert torch.equal(cut, tscore.plucker_counts(**ops))
    assert int(full.sum()) > int(cut.sum()) > 0


def test_grid_centers_normals_match():
    grid = DetectorGrid(n_theta=18, n_phi=9)
    jc, jn = jscore.grid_centers_normals(grid)
    tc, tn = tscore.grid_centers_normals(convert.grid(grid))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-6)


def test_scorer_refuses_tf32(shared):
    _, tres = shared
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            tscore.fluxmap_trace_once(tres, convert.grid(DetectorGrid(4, 4)))
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("port", [160.0, 164.0, 170.0])
def test_rim_deferred_exit_fraction(port):
    """Exit fraction of the deferred rim post-pass (direct main trace,
    hybrid continuation) within 4 sigma of JAX's (independent streams),
    no overflow, and rim-face kills beyond the inner radius."""
    scene = SCENE.with_(theta_max_deg=port)
    shift = rim_deferred_capacity_shift(convert.scene(scene))
    jr, jo = j_rim(jax.random.key(1), scene, SOURCE_OVERNIGHT, N,
                   TraceConfig(), capacity_shift=shift, main_tracer=j_direct)
    tr, to = trace_rays_rim_deferred(
        torch.Generator().manual_seed(1), convert.scene(scene),
        convert.source(SOURCE_OVERNIGHT), N, capacity_shift=shift,
        main_tracer=lossless(trace_rays_direct), device="cpu")
    assert int(jo) == int(to) == 0
    f_j = float(jr.exited_port_mask().sum()) / N
    f_t = float(tr.exited_port_mask().sum()) / N
    sigma = np.sqrt(2 * f_j * (1 - f_j) / N)
    assert abs(f_t - f_j) < 4 * sigma, (f_t, f_j)
    st = tr.status.numpy()
    r = np.linalg.norm(tr.last_point.stack().numpy()[st == 2], axis=1)
    assert (r > 100.1 + 1e-3).any()


@pytest.mark.parametrize("path", ["in_loop_rim", "deferred_mixed_brdf"])
def test_eager_rim_paths_exit_fraction(path):
    """The exact-rim paths the Lambertian slice does not reach:
    ``trace_rays`` with the rim in the loop, and the deferred post-pass of
    a MIXED_BRDF scene, whose continuation runs the finish kernel's
    exact-rim step (its plain version here) to extinction.  Exit fraction
    within 4 sigma of JAX's, no overflow."""
    from altair_tpu.config import SurfaceModel
    from altair_tpu.core.trace import trace_rays as j_trace
    from altair_tpu_torch.core.trace import trace_rays

    n = 8192
    scene = SCENE.with_(max_bounces=256)
    g = torch.Generator().manual_seed(4)
    src = convert.source(SOURCE_OVERNIGHT)
    if path == "in_loop_rim":
        jr = j_trace(jax.random.key(4), scene, SOURCE_OVERNIGHT, n)
        tr = trace_rays(g, convert.scene(scene), src, n, device="cpu")
    else:
        scene = scene.with_(surface_model=SurfaceModel.MIXED_BRDF)
        jr, jo = j_rim(jax.random.key(4), scene, SOURCE_OVERNIGHT, n,
                       TraceConfig(), capacity_shift=4)
        tr, to = trace_rays_rim_deferred(g, convert.scene(scene), src, n,
                                         capacity_shift=4, device="cpu")
        assert int(jo) == int(to) == 0
    f_j = float(jr.exited_port_mask().sum()) / n
    f_t = float(tr.exited_port_mask().sum()) / n
    assert abs(f_t - f_j) < 4 * np.sqrt(2 * f_j * (1 - f_j) / n), (f_t, f_j)
    st = tr.status.numpy()
    r = np.linalg.norm(tr.last_point.stack().numpy()[st == 2], axis=1)
    assert (r > 100.1 + 1e-3).any()      # some kills on the rim face


def test_put_drops_the_sink_index():
    dst = torch.arange(5, dtype=torch.int32)
    out = _put(dst, torch.tensor([4, 5, 1, 5]),
               torch.tensor([40, 99, 10, 98], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), [0, 10, 2, 3, 40])
    assert int((out == EXITED).sum()) == 0
