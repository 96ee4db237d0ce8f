"""The finish kernel's plain version (``trace_cuda.finish_plain``) on the
CPU: the deferred rim post-pass through it against the JAX package's
exact-rim trace, the lanes it must leave or suspend, and the routes that
keep the eager loop.  The CUDA kernel is held against
``finish_plain`` on the card (``tests/test_torch_finish_cuda.py``,
``chip_smoke.py``)."""

import functools

import jax
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
from altair_tpu.core.trace import trace_rays as j_trace
from altair_tpu_torch import TraceConfig, convert
from altair_tpu_torch.core import route, trace_cuda
from altair_tpu_torch.core.geometry import Vec3
from altair_tpu_torch.core.route import trace_rays_rim_deferred
from altair_tpu_torch.core.trace import (ABSORBED, EXITED, RUNNING,
                                         SUSPENDED, _source_rays)
from altair_tpu_torch.io import profiling

torch.set_num_threads(1)

N = 16_384
SCENE = SCENE_OPTIMIZE.with_(max_bounces=256)
R_IN = float(SCENE.inner_radius)
# bounce-count bins of the histogram comparison
EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 257)


def _classes(status, last, seg, bounces):
    """Per ray, the fractions compared with JAX: port exits (segment from
    the inner sphere or the source), rim exits (from the rim face, out of
    the gap), rim-face kills, and the bounce-count histogram."""
    st = np.asarray(status)
    r_seg = np.linalg.norm(np.asarray(seg), axis=1)
    r_last = np.linalg.norm(np.asarray(last), axis=1)
    ex = st == EXITED
    out = {"port_exit": ex & (r_seg <= R_IN + 1e-3),
           "rim_exit": ex & (r_seg > R_IN + 1e-3),
           "rim_kill": (st == ABSORBED) & (r_last > R_IN + 1e-3)}
    b = np.asarray(bounces)
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        out[f"bounces[{lo},{hi})"] = (b >= lo) & (b < hi)
    return out


@functools.cache
def _jax_exact(model):
    """JAX's in-loop exact-rim trace of N rays: the classes' fractions."""
    scene = SCENE.with_(surface_model=model)
    jr = j_trace(jax.random.key(int(model) + 5), scene, SOURCE_OVERNIGHT, N)
    cls = _classes(jr.status, np.asarray(jr.last_point.stack()),
                   np.asarray(jr.seg_start.stack()), jr.n_bounces)
    return {k: float(v.mean()) for k, v in cls.items()}


def _port_deferred(model, seed=3, capacity_shift=4):
    """The port's deferred rim post-pass through the finish kernel's plain
    version (the simulate engine, so a Lambertian scene does not take the
    hybrid)."""
    return trace_rays_rim_deferred(
        torch.Generator().manual_seed(seed),
        convert.scene(SCENE.with_(surface_model=model)),
        convert.source(SOURCE_OVERNIGHT), N, TraceConfig(engine="simulate"),
        capacity_shift=capacity_shift, device="cpu")


@pytest.mark.parametrize("model", [SurfaceModel.LAMBERTIAN,
                                   SurfaceModel.MIXED_BRDF])
def test_rim_deferred_through_finish_matches_jax(model):
    """Exit fraction, port and rim exits, rim-face kills and every bin of
    the bounce histogram within 4 sigma of JAX's exact-rim trace
    (independent streams); no overflow; every ray finished."""
    res, ovf = _port_deferred(model)
    assert int(ovf) == 0 and int(ovf.grouped_drops) == 0
    st = res.status.numpy()
    assert ((st >= EXITED) & (st <= SUSPENDED)).all()
    ref = _jax_exact(model)
    cls = _classes(st, res.last_point.stack().numpy(),
                   res.seg_start.stack().numpy(), res.n_bounces.numpy())
    assert cls["rim_exit"].any() and cls["rim_kill"].any()
    f_t = float(res.exited_port_mask().sum()) / N
    for name, f_j, f_p in ([("exit_fraction", None, f_t)]
                           + [(k, ref[k], float(v.mean()))
                              for k, v in cls.items()]):
        if f_j is None:
            f_j = ref["port_exit"] + ref["rim_exit"]
        sigma = np.sqrt(2 * max(f_j * (1 - f_j), 1.0 / N) / N)
        assert abs(f_p - f_j) < 4 * sigma, (name, f_p, f_j)


@pytest.mark.parametrize("capacity_shift", [2, 4, 6])
def test_rim_pass_loses_no_ray_at_any_fill(monkeypatch, capacity_shift):
    """Buffers from a quarter of the batch down to 256 lanes, filled from
    a few percent of their lanes to most of them: the finish returns every
    lane finished, and RimOverflow.total is exactly the clipped rays the
    buffer could not hold, with nothing from the continuation."""
    seen = {}
    real_finish, real_gather = trace_cuda.finish, route._compact_gather

    def spy_finish(seed, scene_vec, rim_vec, state, model, max_iters,
                   exact_rim):
        out = real_finish(seed, scene_vec, rim_vec, state, model, max_iters,
                          exact_rim)
        seen["finish"] = (int((state[3] == RUNNING).sum()),
                          int((out.status == RUNNING).sum()))
        return out

    def spy_gather(mask, vecs, ints, capacity, n, group_capacity=None):
        seen["clipped"], seen["m"] = int(mask.sum()), capacity
        return real_gather(mask, vecs, ints, capacity, n, group_capacity)

    monkeypatch.setattr(trace_cuda, "finish", spy_finish)
    monkeypatch.setattr(route, "_compact_gather", spy_gather)
    _, ovf = _port_deferred(SurfaceModel.MIXED_BRDF, seed=capacity_shift,
                            capacity_shift=capacity_shift)
    running, left = seen["finish"]
    m, clipped = seen["m"], seen["clipped"]
    assert m == max(256, N >> capacity_shift)
    assert 0 < running <= min(clipped, m) and left == 0
    assert int(ovf) == max(0, clipped - m)
    assert int(ovf.grouped_drops) == 0


def _interior_state(n, bounces=0):
    """n source rays, RUNNING, interior (the bounce-step carry)."""
    pos, d = _source_rays(convert.source(SOURCE_OVERNIGHT), n,
                          torch.float32, "cpu")
    return (pos, d, pos, torch.zeros(n, dtype=torch.int32),
            torch.full((n,), bounces, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool))


@pytest.mark.parametrize("exact_rim", [False, True])
def test_lanes_at_the_cap_come_back_suspended(exact_rim):
    """With the port closed (cos_cap below the sphere) and a wall that
    absorbs nothing, every lane runs max_iters steps and comes back
    SUSPENDED with that many more bounces; max_iters 0 suspends at once
    and moves nothing."""
    scene = convert.scene(SCENE.with_(surface_model=SurfaceModel.MIXED_BRDF))
    sv, _ = trace_cuda.kernel_operands(scene, convert.source(SOURCE_OVERNIGHT),
                                       "cpu")
    sv[1] = -2.0 * sv[0]
    sv[2] = 1.0
    rim = trace_cuda.rim_operand(scene, "cpu")
    state = _interior_state(64, bounces=5)
    for max_iters in (0, 7):
        out = trace_cuda.finish((1, 2), sv, rim, state, 2, max_iters,
                                exact_rim)
        assert (out.status == SUSPENDED).all()
        assert (out.n_bounces == 5 + max_iters).all()
    assert torch.equal(trace_cuda.finish((1, 2), sv, rim, state, 2, 0,
                                         exact_rim).last_point.x,
                       state[0].x)


def test_dead_lanes_pass_through_and_lanes_do_not_interact():
    """Lanes not RUNNING at entry come back as they went in; a lane's
    result does not depend on which other lanes run (its draws are keyed
    by its lane and step)."""
    scene = convert.scene(SCENE.with_(surface_model=SurfaceModel.MIXED_BRDF))
    sv, _ = trace_cuda.kernel_operands(scene, convert.source(SOURCE_OVERNIGHT),
                                       "cpu")
    rim = trace_cuda.rim_operand(scene, "cpu")
    n = 512
    state = _interior_state(n)
    full = trace_cuda.finish((9, 10), sv, rim, state, 2, 256, True)
    half = torch.arange(n) % 2 == 1
    dead = list(state)
    dead[3] = torch.where(half, ABSORBED, 0).to(torch.int32)
    part = trace_cuda.finish((9, 10), sv, rim, tuple(dead), 2, 256, True)
    keep = ~half
    for f in ("status", "n_bounces"):
        assert torch.equal(getattr(part, f)[keep], getattr(full, f)[keep])
    for f in ("last_point", "seg_start", "direction"):
        assert torch.equal(getattr(part, f).stack()[keep],
                           getattr(full, f).stack()[keep])
    assert (part.status[half] == ABSORBED).all()
    for a, b in zip((*part.last_point, *part.seg_start, *part.direction),
                    (*state[0], *state[2], *state[1])):
        assert torch.equal(a[half], b[half])


def _cont_spans():
    spans = profiling.records()["spans"]
    (cont,) = [s for s in spans if s["name"] == "trace.rim.cont"]
    kids = [s["name"] for s in spans if s["parent"] == cont["id"]]
    return cont["attrs"]["kind"], kids


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float64_keeps_the_loops(monkeypatch, dtype):
    """A float64 scene, which the kernels do not take, still runs the
    eager loop under ``trace.rim.cont`` and never the finish; a float32
    one runs one finish there and no loop."""
    calls = []
    real = trace_cuda.finish
    monkeypatch.setattr(trace_cuda, "finish",
                        lambda *a: calls.append(a[-1]) or real(*a))
    scene = convert.scene(SCENE.with_(surface_model=SurfaceModel.MIXED_BRDF,
                                      max_bounces=200))
    profiling.clear()
    with profiling.tracing():
        _, ovf = trace_rays_rim_deferred(
            torch.Generator().manual_seed(7), scene,
            convert.source(SOURCE_OVERNIGHT), 4096, TraceConfig(dtype=dtype),
            device="cpu")
    kind, kids = _cont_spans()
    names = {s["name"] for s in profiling.records()["spans"]}
    profiling.clear()
    assert int(ovf) == 0
    assert "kernel.finish" not in names
    if dtype == torch.float64:
        assert kind == "eager" and kids == ["loop.eager"] and calls == []
    else:
        assert kind == "kernel" and kids == [] and calls == [True]


def test_finish_guards():
    scene = convert.scene(SCENE)
    sv, _ = trace_cuda.kernel_operands(scene, convert.source(SOURCE_OVERNIGHT),
                                       "cpu")
    rim = trace_cuda.rim_operand(scene, "cpu")
    state = _interior_state(8)
    with pytest.raises(ValueError):          # rim_vec of the wrong width
        trace_cuda.finish((1, 2), sv, sv, state, 0, 8, True)
    bad = list(state)
    bad[4] = bad[4].to(torch.int64)
    with pytest.raises(ValueError):          # bounces not int32
        trace_cuda.finish((1, 2), sv, rim, tuple(bad), 0, 8, True)
    with pytest.raises(ValueError):          # one seed word
        trace_cuda.finish((1,), sv, rim, state, 0, 8, True)
    with pytest.raises(ValueError):          # no such law
        trace_cuda.finish((1, 2), sv, rim, state, 7, 8, True)
    with pytest.raises(ValueError):
        trace_cuda.finish((1, 2), sv.to(torch.float64), rim, state, 0, 8,
                          True)
    assert isinstance(state[0], Vec3)


# the H100's resident threads for a finish instantiation of 4 blocks of
# 256 a multiprocessor, and for 8
SLOTS_4, SLOTS_8 = 132 * 4 * 256, 132 * 8 * 256


@pytest.mark.parametrize("n,slots,depth,threads", [
    (1, SLOTS_4, 1, 256),
    (6_250, SLOTS_4, 1, 6_400),              # map100k's rim continuation
    (40_960, SLOTS_4, 1, 40_960),            # trace4M's straggler finish
    (SLOTS_4, SLOTS_4, 1, SLOTS_4),
    (SLOTS_4 + 1, SLOTS_4, 2, SLOTS_4),
    (262_144, SLOTS_4, 2, SLOTS_4),          # trace4M's rim continuation
    (262_144, SLOTS_8, 1, 262_144),
    (800_000, SLOTS_4, 6, SLOTS_4),          # the in-sphere sweep's chunk
    (800_000, SLOTS_8, 3, SLOTS_8),
])
def test_finish_pool_engages_above_the_resident_threads(n, slots, depth,
                                                        threads):
    """The finish launch's pool depth is ceil(n / slots): 1 (one lane a
    thread, a grid of whole blocks over the buffer) at or below the card's
    resident threads, and above them the resident grid, whose threads take
    the lanes left over."""
    assert trace_cuda.finish_lanes_per_thread(n, slots) == depth
    assert trace_cuda.finish_grid_threads(n, slots) == threads
    assert threads % trace_cuda.FINISH_THREADS == 0
    assert threads * depth >= n


@pytest.mark.parametrize("threads", [1_024, 2_048])
def test_finish_schedule_hands_out_every_lane_once(threads):
    """The lane-use model of a pooled launch (``profile_finish.schedule``)
    spends each lane's steps on one thread: the warps' iterations cover
    every lane-step, a warp runs no shorter than its longest lane, and one
    lane a thread gives each warp its longest lane."""
    from altair_tpu_torch import profile_finish

    rng = np.random.default_rng(3)
    steps = rng.geometric(1 / 40, size=5_000)
    steps[::7] = 0                                # lanes dead at entry
    warps = profile_finish.schedule(steps, threads)
    assert warps.shape == (threads // 32,)
    assert 32 * warps.sum() >= steps.sum()
    assert warps.max() >= steps.max()
    use, longest = profile_finish.lane_use(steps, threads)
    assert 0 < use <= 1 and longest == warps.max()
    static = profile_finish.schedule(steps, 5_024)
    padded = np.concatenate([steps, np.zeros(24, dtype=steps.dtype)])
    assert np.array_equal(static, padded.reshape(-1, 32).max(axis=1))
    # the pool keeps more of its thread-iterations stepping than one lane
    # a thread over the same buffer
    assert use > profile_finish.lane_use(steps, 5_024)[0]


def test_finish_schedule_is_the_kernels_order():
    """One warp, two rows: the threads free at one iteration take the next
    lanes of the warp's pool in thread order."""
    from altair_tpu_torch import profile_finish

    steps = np.ones(64, dtype=np.int64)
    steps[:32] = np.arange(1, 33)                 # thread j frees at j + 1
    steps[32:] = np.arange(32, 0, -1)             # lane 32 + j: 32 - j steps
    # thread j takes lane 32 + j at iteration j + 1 and ends at 33
    assert profile_finish.schedule(steps, 32).tolist() == [33]
    assert profile_finish.schedule(steps, 64).tolist() == [32, 32]
    # a trailing row with no live lane leaves the pool: no thread spends
    # an iteration on it
    steps[32:] = 0
    assert profile_finish.schedule(steps, 32).tolist() == [32]
