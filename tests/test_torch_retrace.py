"""Port parity of the retrace flux-map path and the exit histograms
(``altair_tpu_torch/core/score.py``) against ``altair_tpu`` on the CPU:
the scorer's anchoring order, ``pi_hat``, the binomial retrace's contract
(as ``tests/test_retrace_binomial.py``), the honest retrace, the position
assignment, the single-detector count and the histograms."""

import functools

import jax
import numpy as np
import pytest
import torch

import altair_tpu.core.score as jscore
import altair_tpu_torch.core.score as tscore
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid, TraceConfig
from altair_tpu.core.geometry import detector_position as j_detector_position
from altair_tpu.core.trace_waves import trace_rays_auto as j_auto
from altair_tpu_torch import convert
from altair_tpu_torch import TraceConfig as TCfg
from altair_tpu_torch.core.geometry import Vec3, detector_position
from altair_tpu_torch.core.trace import EXITED, TraceResult, fold_in
from altair_tpu_torch.core.trace_waves import trace_rays_auto

torch.set_num_threads(1)

SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096)
GRID = DetectorGrid(n_theta=6, n_phi=4)
N_PER_POS = 1_000
OVERSAMPLE = 16
# JAX's test takes 40 maps; 20 keep the variance band's chi2 noise at ~10%
# over the bright cells (see test_binomial_variance_contract)
N_REPS = 20


# the same configuration as the port's objects
T_SCENE = convert.scene(SCENE)
T_SOURCE = convert.source(SOURCE_OVERNIGHT)
T_GRID = convert.grid(GRID)


@functools.cache
def _shared_trace():
    """One JAX trace of 200k rays (direct engine + rim post-pass), held by
    both packages."""
    res = j_auto(jax.random.key(7), SCENE, SOURCE_OVERNIGHT, 200_000,
                 TraceConfig())
    return res, convert.trace_result(res, "cpu")


@functools.cache
def _reference_map():
    """JAX's trace-once probability map of the shared trace: the
    ground-truth pi_p of tests/test_retrace_binomial.py."""
    return np.asarray(jscore.fluxmap_trace_once(_shared_trace()[0],
                                                GRID)) / 200_000


@functools.cache
def _binomial_reps():
    """``N_REPS`` independent binomial-engine maps of the port."""
    return np.stack([tscore.fluxmap_retrace_binomial(
        torch.Generator().manual_seed(100 + i), T_SCENE, T_SOURCE,
        T_GRID, N_PER_POS, oversample=OVERSAMPLE, device="cpu").numpy()
        for i in range(N_REPS)])


def _line_disk_hits_f64(E, D, C, N, R):
    """``[n_rays, n_pos]`` line/disk test in float64 (``line_hits_disk``'s
    arithmetic)."""
    dot = D @ N.T
    rel_n = E @ N.T - (C * N).sum(1)[None, :]
    t = -rel_n / np.where(dot == 0, 1.0, dot)
    hit = E[:, None, :] + t[:, :, None] * D[:, None, :] - C[None, :, :]
    perp = np.cross(N[None, :, :], hit)
    return (np.abs(dot) >= 1e-10) & ((perp ** 2).sum(-1) <= R * R)


def test_scorer_anchors_in_the_trace_dtype():
    """The Plucker scorer subtracts the port anchor in the trace's own
    dtype and then casts (``altair_tpu/core/score.py:210-215``).  A float64
    batch near a port at z = -1e5 cm, where float32 rounds z to 2^-8 cm:
    every line passes 1e-3 cm inside or outside a disk edge, so rounding E
    before the subtraction moves hits across the edge, while the f32
    matmul's own error stays far below 1e-3.  The counts equal a float64
    reference on the inputs the JAX order gives the matmul (E - anchor and
    D rounded to float32); the cast-then-subtract order, reproduced by
    handing the scorer E already in float32, does not."""
    ez = -1.0e5
    grid = convert.grid(DetectorGrid(n_theta=2, n_phi=4))
    R = grid.width / 2.0
    C32, N32 = tscore.grid_centers_normals(grid, ez)
    C, N = C32.double().numpy(), N32.double().numpy()
    anchor = np.array([0.0, 0.0, ez])
    rng = np.random.default_rng(7)
    per = 256
    E, D = [], []
    for p in range(grid.n_positions):
        e = anchor + np.column_stack([
            rng.uniform(-0.5, 0.5, per), rng.uniform(-0.5, 0.5, per),
            -rng.uniform(0.01, 0.5, per)])
        v = rng.normal(size=(per, 3))
        v -= (v @ N[p])[:, None] * N[p]
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        delta = np.where(rng.random(per) < 0.5, -1e-3, 1e-3)
        h = C[p] + (R + delta)[:, None] * v
        d = h - e
        E.append(e)
        D.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    E, D = np.concatenate(E), np.concatenate(D)

    E_rel32 = (E - anchor).astype(np.float32).astype(np.float64)
    D32 = D.astype(np.float32).astype(np.float64)
    ref = _line_disk_hits_f64(E_rel32, D32, C - anchor, N, R).sum(0)
    assert ref.sum() > 200

    def counts(last_point):
        n = last_point.shape[0]
        res = TraceResult(
            status=torch.full((n,), EXITED, dtype=torch.int32),
            last_point=Vec3(*torch.from_numpy(last_point).unbind(1)),
            seg_start=Vec3(*torch.from_numpy(last_point).unbind(1)),
            direction=Vec3(*torch.from_numpy(D).unbind(1)),
            n_bounces=torch.zeros(n, dtype=torch.int32))
        return tscore.fluxmap_trace_once(res, grid, exit_port_z=ez).reshape(-1)

    np.testing.assert_array_equal(counts(E).numpy(), ref)
    old = counts(E.astype(np.float32)).numpy()
    assert (old != ref).any(), "the batch does not separate the two orders"


def test_pi_hat_equals_jax():
    """Same counts and compaction overflow -> the same float32 pi_hat, bit
    for bit, spread overflow included."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 5000, size=(18, 9)).astype(np.int32)
    M = 128 * 50_000
    for overflow in (0, 7, 16_201):
        jax_p = (jax.numpy.asarray(counts).astype(jax.numpy.float32)
                 + jax.numpy.int32(overflow).astype(jax.numpy.float32)
                 / counts.size) / M
        t = tscore.pi_hat(torch.from_numpy(counts),
                          torch.tensor(overflow, dtype=torch.int32), M,
                          counts.size)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jax_p))


def test_binomial_counts_bounded_and_deterministic():
    reps = _binomial_reps()
    assert reps.dtype == np.int32 and reps.shape == (N_REPS, 6, 4)
    assert (reps >= 0).all() and (reps <= N_PER_POS).all()
    again = tscore.fluxmap_retrace_binomial(
        torch.Generator().manual_seed(100), T_SCENE, T_SOURCE,
        T_GRID, N_PER_POS, oversample=OVERSAMPLE, device="cpu")
    np.testing.assert_array_equal(again.numpy(), reps[0])
    with pytest.raises(ValueError):
        tscore.fluxmap_retrace_binomial(
            torch.Generator(), T_SCENE, T_SOURCE, T_GRID, 100,
            oversample=1, device="cpu")


def test_binomial_mean_matches_jax_trace_once():
    """Cell means over N_REPS seeds agree with JAX's 200k-ray trace-once map
    (tests/test_retrace_binomial.py's tolerance: 4 combined sigmas, >90%
    of cells)."""
    mean_frac = _binomial_reps().mean(axis=0) / N_PER_POS
    pi = _reference_map()
    sem = np.sqrt(np.maximum(pi, 1e-6) * (1 + 1 / OVERSAMPLE)
                  / (N_PER_POS * N_REPS))
    sem_ref = np.sqrt(np.maximum(pi, 1e-6) / 200_000)
    ok = np.abs(mean_frac - pi) < 4.0 * np.hypot(sem, sem_ref) + 1e-4
    assert ok.mean() > 0.9, (mean_frac, pi)


def test_binomial_variance_contract():
    """Pooled bright-cell variance over N_REPS = 20 seeds ~= n pi (1-pi)
    (1 + 1/oversample), in tests/test_retrace_binomial.py's band 0.6-1.6:
    one cell's 20-sample variance has a chi2 noise of ~32%, the sum over
    the bright cells (each ~19 degrees of freedom) ~10%."""
    pi = _reference_map()
    bright = pi * N_PER_POS > 5
    assert bright.sum() >= 4
    emp = _binomial_reps().var(axis=0, ddof=1)[bright]
    theo = (N_PER_POS * pi * (1 - pi) * (1 + 1 / OVERSAMPLE))[bright]
    assert 0.6 < emp.sum() / theo.sum() < 1.6, emp.sum() / theo.sum()


def test_binomial_stats_split_the_call():
    """``stats`` receives the call's own stages and its compaction
    overflow, and leaves the map as it was without them."""
    stats = {}
    cells = tscore.fluxmap_retrace_binomial(
        torch.Generator().manual_seed(100), T_SCENE, T_SOURCE, T_GRID,
        N_PER_POS, oversample=OVERSAMPLE, device="cpu", stats=stats)
    np.testing.assert_array_equal(cells.numpy(), _binomial_reps()[0])
    assert sorted(stats) == ["compaction_overflow", "draw_s", "score_s",
                             "trace_s"]
    assert stats["compaction_overflow"] == 0
    assert all(stats[k] >= 0 for k in ("trace_s", "score_s", "draw_s"))
    cap = tscore.exit_capacity(T_SCENE, 128 * 50_000)
    assert tscore.binomial_pos_chunk(cap) == 256
    assert tscore.binomial_pos_chunk(1 << 40) == 8


def test_retrace_matches_jax():
    """The honest retrace map against JAX's on the same grid: each cell
    within 5 sigma of the difference of two independent Binomial(n, pi)
    draws, pi from the reference map (floored at 1/n)."""
    j = np.asarray(jscore.fluxmap_retrace(
        jax.random.key(3), SCENE, SOURCE_OVERNIGHT, GRID, N_PER_POS,
        TraceConfig()), np.float64)
    t = tscore.fluxmap_retrace(
        torch.Generator().manual_seed(3), T_SCENE, T_SOURCE,
        T_GRID, N_PER_POS, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (6, 4)
    pi = np.maximum(_reference_map(), 1.0 / N_PER_POS)
    sigma = np.sqrt(2 * N_PER_POS * pi * (1 - pi))
    assert (np.abs(t.numpy() - j) < 5 * sigma).all(), (t.numpy(), j)
    assert j.sum() > 100


def _rays(res: TraceResult, sl: slice) -> TraceResult:
    def v(p):
        return Vec3(p.x[sl], p.y[sl], p.z[sl])

    return TraceResult(res.status[sl], v(res.last_point), v(res.seg_start),
                       v(res.direction), res.n_bounces[sl])


def test_retrace_position_assignment():
    """Chunk i traces from fold_in(key, i) and ray j belongs to position
    i*chunk + j // n: each cell equals hits_single_detector on that
    position's own slice of the chunk's rays (pos_chunk=5 also pads the
    last chunk)."""
    n, chunk = 300, 5
    key = torch.Generator().manual_seed(8)
    scene, src, grid = T_SCENE, T_SOURCE, T_GRID
    counts = tscore.fluxmap_retrace(key, scene, src, grid, n,
                                    pos_chunk=chunk, device="cpu").reshape(-1)
    C, Nrm = tscore.grid_centers_normals(grid)
    for i in range(-(-grid.n_positions // chunk)):
        res, _ = trace_rays_auto(fold_in(key, i), scene, src, n * chunk,
                                 TCfg(), device="cpu")
        for j in range(chunk):
            p = i * chunk + j
            if p >= grid.n_positions:
                break
            h = tscore.hits_single_detector(
                _rays(res, slice(j * n, (j + 1) * n)), Vec3(*C[p]),
                Vec3(*Nrm[p]), grid.width / 2.0)
            assert int(h) == int(counts[p]), p
    assert int(counts.sum()) > 50


def test_hits_single_detector_equals_jax():
    jres, tres = _shared_trace()
    for theta, phi in ((2.0, 10.0), (20.0, 200.0), (45.0, 95.0)):
        jc, jn = j_detector_position(jax.numpy.float32(theta),
                                     jax.numpy.float32(phi), 100.0)
        tc, tn = detector_position(torch.tensor(theta), torch.tensor(phi),
                                   100.0)
        j = int(jscore.hits_single_detector(jres, jc, jn, 20.0))
        t = int(tscore.hits_single_detector(tres, tc, tn, 20.0))
        assert t == j and (theta > 30 or j > 100), (theta, phi, t, j)


def test_histograms_equal_jax():
    """The signed exit-angle and cos-z histograms and the exit direction
    payload on one shared trace."""
    jres, tres = _shared_trace()
    j_ang = np.asarray(jscore.exit_angle_histogram(jres))
    t_ang = tscore.exit_angle_histogram(tres)
    assert t_ang.dtype == torch.int32 and t_ang.shape == (180,)
    np.testing.assert_array_equal(t_ang.numpy(), j_ang)
    jm, jx, jy, jz = jscore.exit_directions(jres)
    tm, tx, ty, tz = tscore.exit_directions(tres)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for a, b in ((tx, jx), (ty, jy), (tz, jz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    j_dz = np.asarray(jscore.z_angle_histogram(jz, jm))
    t_dz = tscore.z_angle_histogram(torch.from_numpy(np.array(jz)), tm)
    np.testing.assert_array_equal(t_dz.numpy(), j_dz)
    assert j_ang.sum() == j_dz.sum() == int(np.asarray(jm).sum())
