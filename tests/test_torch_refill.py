"""Port parity: the refill kernel's plain PyTorch version against the Pallas
``_refill_kernel`` run in the TPU interpreter, and the port's
``trace_rays_refill`` (tail handoff + straggler finish) against JAX's.

Without the handoff both sides draw from the counter-based hash generator
(``hw_prng=False`` / ``rng="hash"``) with the same key words, and
``refill_plain`` takes Pallas's 16384-lane block, so the comparison is per
slot.  With the handoff the unit-wide loop exit and the continuation's
streams differ, so that path is held statistically.  The CUDA kernel is
held against ``refill_plain`` on the card (``tests/test_torch_refill_cuda.py``,
``chip_smoke.py``).

``refill_plain`` is the kernel's loop written out step by step over
``[units, threads]`` (threads taking lanes from their unit's pool); the
warp schedule (32 threads a unit) and the lane-static one (a thread per
lane) run different steps and must give the same slots without the
handoff.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel, TraceConfig
from altair_tpu.core.trace_pallas import BLOCK, trace_rays_refill as j_refill
from altair_tpu_torch import convert
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.core.geometry import Vec3, sphere_hit
from altair_tpu_torch.core.trace import EXITED, RUNNING, cos_theta_max
from altair_tpu_torch.io import profiling

torch.set_num_threads(1)

N = 32_768
BUDGET = 2
MAX_BOUNCES = 64
HANDOFF = 0.4
SCENE_H = SCENE_OPTIMIZE.with_(max_bounces=512, exact_rim=False)


def _scene(model, max_bounces=MAX_BOUNCES):
    return SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False,
                                surface_model=model)


def _operands(model, max_bounces=MAX_BOUNCES):
    return trace_cuda.kernel_operands(
        convert.scene(_scene(model, max_bounces)),
        convert.source(SOURCE_OVERNIGHT), "cpu")


@functools.cache
def _pallas_ref(model):
    """The Pallas refill kernel in the interpreter (hash stream, no
    handoff) at N rays, budget 2: ``(key, TraceResult)``, cached per law
    because the interpreter takes seconds a run."""
    key = jax.random.key(int(model) + 31)
    return key, j_refill(key, _scene(model), SOURCE_OVERNIGHT, N,
                         TraceConfig(), rays_per_lane=BUDGET, interpret=True,
                         hw_prng=False)


def launches(kernel: str) -> int:
    """The kernel's launches in this process (the tracer's process total)."""
    return profiling.records()["totals"].get(f"kernel.{kernel}.launches", 0)


def _hash_plain(model):
    """The port's refill on CPU tensors (its plain version) with the words
    of ``_pallas_ref``'s key and Pallas's lane block.  Unfinished slots
    read RUNNING here and SUSPENDED in ``trace_rays_refill``'s result."""
    key, _ = _pallas_ref(model)
    sv, srcv = _operands(model)
    before = launches("refill")
    res, live = trace_cuda.refill(convert.seed_words(jax.random.key_data(key)),
                                  sv, srcv, N, int(model), MAX_BOUNCES,
                                  BUDGET, 0, rng="hash", lane_block=BLOCK)
    assert launches("refill") == before  # CPU: plain path
    assert live is None
    return res._replace(status=torch.where(res.status == RUNNING, 3,
                                           res.status))


def _assert_exit_geometry(res):
    """Every exit's segment start lies on its escape line: the line meets
    the shell in the port cap (``sphere_hit``, as the rim post-pass reads
    it), and the last point is on the world box."""
    scene = convert.scene(SCENE_H)
    st = res.status.numpy()
    ex = torch.from_numpy(st == EXITED)
    q = sphere_hit(Vec3(*(c[ex] for c in res.seg_start)),
                   Vec3(*(c[ex] for c in res.direction)),
                   float(scene.inner_radius))
    assert ex.sum() > 0
    assert (q.z.numpy() < cos_theta_max(scene) * scene.inner_radius
            + 1e-3).all()
    box = np.max(np.abs(np.stack([c.numpy()[st == EXITED]
                                  for c in res.last_point])), axis=0)
    np.testing.assert_allclose(box, scene.world_half, rtol=1e-5)


def _assert_same_law(a_status, a_bounces, b_status, b_bounces, k=4.0):
    """Exit fraction and mean bounce count within k sigma (the standard
    error of a difference of two independent means)."""
    for name, a, b in (("exit fraction", a_status == EXITED,
                        b_status == EXITED),
                       ("mean bounces", a_bounces, b_bounces)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        sigma = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= k * sigma, \
            (name, a.mean(), b.mean(), sigma)


@pytest.mark.parametrize("model", [SurfaceModel.LAMBERTIAN,
                                   SurfaceModel.MIXED_BRDF,
                                   SurfaceModel.COS_N_LOBE])
def test_plain_refill_matches_pallas_per_slot(model):
    """Status and bounce count agree on >= 99.9% of slots; on those,
    positions within 1e-2 cm on >= 99% (XLA's and torch's float32 trig
    differ by ulps, which accumulate bounce by bounce)."""
    _, ref = _pallas_ref(model)
    out = _hash_plain(model)
    agree = ((out.status.numpy() == np.asarray(ref.status))
             & (out.n_bounces.numpy() == np.asarray(ref.n_bounces)))
    assert agree.mean() >= 0.999, agree.mean()
    for field in ("last_point", "seg_start"):
        err = np.max([np.abs(getattr(getattr(out, field), c).numpy()
                             - np.asarray(getattr(getattr(ref, field), c)))
                      for c in "xyz"], axis=0)[agree]
        assert (err <= 1e-2).mean() >= 0.99, (field, np.quantile(err, 0.99))
    assert (out.status.numpy() == EXITED).mean() > 0.2


def test_plain_refill_specular_matches_pallas():
    """SPECULAR's near-mirror chains amplify the ulp drift into status
    flips (as for the bounce kernel): >= 99% of slots agree, and the exit
    fraction and mean bounces are within 4 sigma."""
    _, ref = _pallas_ref(SurfaceModel.SPECULAR)
    out = _hash_plain(SurfaceModel.SPECULAR)
    agree = ((out.status.numpy() == np.asarray(ref.status))
             & (out.n_bounces.numpy() == np.asarray(ref.n_bounces)))
    assert agree.mean() >= 0.99, agree.mean()
    _assert_same_law(out.status.numpy(), out.n_bounces.numpy(),
                     np.asarray(ref.status), np.asarray(ref.n_bounces))


@pytest.mark.parametrize("model", list(SurfaceModel))
def test_philox_refill_physics(model):
    """The production stream at the port's lane block: every slot filled,
    exits on their escape lines, the exit fraction and mean bounces within
    4 sigma of the Pallas kernel's (hash stream)."""
    sv, srcv = _operands(model)
    res, _ = trace_cuda.refill((5, 6), sv, srcv, N, int(model), MAX_BOUNCES,
                               BUDGET, 0, rng="philox")
    st = res.status.numpy()
    assert set(np.unique(st)) <= {1, 2, 3}
    _assert_exit_geometry(res)
    _, ref = _pallas_ref(model)
    _assert_same_law(st, res.n_bounces.numpy(), np.asarray(ref.status),
                     np.asarray(ref.n_bounces))


def test_lane_block_only_moves_slots():
    """Without the handoff a lane's rays do not depend on its block: the
    same lanes at lane blocks 256 and 16384 give the same slots, each at
    the flat index its layout says."""
    sv, srcv = _operands(SurfaceModel.LAMBERTIAN)
    a, _ = trace_cuda.refill((1, 2), sv, srcv, N, 0, MAX_BOUNCES, BUDGET,
                             rng="hash", lane_block=256)
    b, _ = trace_cuda.refill((1, 2), sv, srcv, N, 0, MAX_BOUNCES, BUDGET,
                             rng="hash", lane_block=BLOCK)
    lane = np.arange(N // BUDGET)

    def flat(lanes, slot, lb):
        return (lanes // lb) * BUDGET * lb + slot * lb + lanes % lb

    for slot in range(BUDGET):
        ia, ib = flat(lane, slot, 256), flat(lane, slot, BLOCK)
        for fa, fb in ((a.status, b.status), (a.n_bounces, b.n_bounces),
                       (a.last_point.x, b.last_point.x),
                       (a.seg_start.z, b.seg_start.z),
                       (a.direction.y, b.direction.y)):
            np.testing.assert_array_equal(fa.numpy()[ia], fb.numpy()[ib])


@functools.cache
def _jax_handoff():
    return j_refill(jax.random.key(0), SCENE_H, SOURCE_OVERNIGHT, N,
                    TraceConfig(), rays_per_lane=BUDGET, interpret=True,
                    hw_prng=False, handoff_frac=HANDOFF)


@functools.cache
def _port_handoff(seed=0, n=N):
    return trace_cuda.trace_rays_refill(
        torch.Generator().manual_seed(seed), convert.scene(SCENE_H),
        convert.source(SOURCE_OVERNIGHT), n, rays_per_lane=BUDGET,
        handoff_frac=HANDOFF, device="cpu")


def test_handoff_no_running_slots():
    res, ovf = _port_handoff()
    st = res.status.numpy()
    assert ((st >= 1) & (st <= 3)).all()
    assert int(ovf) == 0


def test_handoff_physics_matches_jax():
    """Exit fraction and mean bounces within 5 sigma of JAX's refill with
    the same handoff fraction (independent streams)."""
    res, _ = _port_handoff()
    ref = _jax_handoff()
    _assert_same_law(res.status.numpy(), res.n_bounces.numpy(),
                     np.asarray(ref.status), np.asarray(ref.n_bounces), k=5)


def test_handoff_exits_on_escape_line():
    """Kernel exits carry the cap crossing as the segment start, straggler
    exits the last wall point: both lie on the escape line, and most exits
    end beyond the port plane (a grazing exit can meet a side of the box
    above it, as in the reference)."""
    res, _ = _port_handoff()
    _assert_exit_geometry(res)
    st = res.status.numpy()
    assert (res.last_point.z.numpy()[st == EXITED] < -100.0).mean() > 0.99
    r = np.linalg.norm(np.stack([c.numpy() for c in res.seg_start]), axis=0)
    assert (r[st == EXITED] <= 100.1 + 1e-2).all()


def test_handoff_deterministic():
    a, _ = _port_handoff()
    b, _ = trace_cuda.trace_rays_refill(
        torch.Generator().manual_seed(0), convert.scene(SCENE_H),
        convert.source(SOURCE_OVERNIGHT), N, rays_per_lane=BUDGET,
        handoff_frac=HANDOFF, device="cpu")
    np.testing.assert_array_equal(a.status.numpy(), b.status.numpy())
    np.testing.assert_array_equal(a.n_bounces.numpy(), b.n_bounces.numpy())
    np.testing.assert_array_equal(a.last_point.x.numpy(),
                                  b.last_point.x.numpy())


def test_handoff_two_block_grid():
    """Two blocks at the port's lane block: the pending slots are exactly
    each lane's slots from its ``ray_idx`` on (the (block, slot, lane)
    decode), at most ``thresh`` per block, and the slots the kernel
    finished before its exit equal those of a run without the handoff."""
    lanes = trace_cuda.REFILL_LANES
    n = 2 * lanes * BUDGET
    thresh = int(HANDOFF * lanes * BUDGET)
    sv, srcv = _operands(SurfaceModel.LAMBERTIAN, 512)
    res, live = trace_cuda.refill((3, 4), sv, srcv, n, 0, 512, BUDGET,
                                  thresh, rng="philox")
    full, _ = trace_cuda.refill((3, 4), sv, srcv, n, 0, 512, BUDGET, 0,
                                rng="philox")
    pending = res.status.numpy() == RUNNING
    f = np.arange(n)
    blk = f // (BUDGET * lanes)
    slot = (f % (BUDGET * lanes)) // lanes
    lane = blk * lanes + f % lanes
    np.testing.assert_array_equal(pending,
                                  slot >= live.ray_idx.numpy()[lane])
    per_block = np.bincount(blk[pending], minlength=2)
    assert per_block.max() <= thresh and per_block.min() > 0
    done = ~pending
    for a, b in ((res.status, full.status), (res.n_bounces, full.n_bounces),
                 (res.last_point.z, full.last_point.z)):
        np.testing.assert_array_equal(a.numpy()[done], b.numpy()[done])
    # the whole path: every slot finished, exits on their escape lines
    out, ovf = _port_handoff(seed=3, n=n)
    st = out.status.numpy()
    assert ((st >= 1) & (st <= 3)).all() and int(ovf) == 0
    _assert_exit_geometry(out)


def test_refill_guards():
    sv, srcv = _operands(SurfaceModel.LAMBERTIAN)
    with pytest.raises(ValueError):        # not a block multiple
        trace_cuda.refill((1, 2), sv, srcv, 1000, 0, 16, 2)
    with pytest.raises(ValueError):
        trace_cuda.refill((1, 2), sv, srcv, 1024, 0, 16, 0)
    with pytest.raises(ValueError):
        trace_cuda.refill((1, 2), sv, srcv, 1024, 0, 16, 2, thresh=-1)
    with pytest.raises(ValueError):
        trace_cuda.refill((1, 2), sv, srcv, 1024, 0, 16, 2, rng="threefry")
    with pytest.raises(ValueError):
        trace_cuda.refill_plain((1, 2), sv, srcv, 1024, 0, 16, 2,
                                threads_per_unit=0)
    scene = convert.scene(SCENE_H)
    src = convert.source(SOURCE_OVERNIGHT)
    with pytest.raises(ValueError):
        trace_cuda.trace_rays_refill(torch.Generator(), scene, src, 1000,
                                     rays_per_lane=2, device="cpu")
    with pytest.raises(NotImplementedError):
        trace_cuda.trace_rays_refill(torch.Generator(),
                                     scene.with_(exact_rim=True), src, 512,
                                     rays_per_lane=2, device="cpu")
    empty, _ = trace_cuda.refill((1, 2), sv, srcv, 0, 0, 16, 2, thresh=3)
    assert empty.status.shape == (0,)


# ---------------------------------------------------------------------------
# The warp schedule: threads taking lanes from their unit's pool
# ---------------------------------------------------------------------------

POOL = 128          # lanes of a unit in the schedule tests
N_POOL = 4 * POOL * BUDGET
CAP_POOL = 24       # the bounce cap there: short lanes, many suspended


def _assert_same_refill(a, b):
    """Two refill results equal plane for plane (and their live states)."""
    (ra, la), (rb, lb) = a, b
    for fa, fb in zip(_planes(ra), _planes(rb)):
        assert torch.equal(fa, fb)
    assert (la is None) == (lb is None)
    if la is not None:
        for fa, fb in zip((*la.pos, *la.direction, la.ray_idx, la.bounces),
                          (*lb.pos, *lb.direction, lb.ray_idx, lb.bounces)):
            assert torch.equal(fa, fb)


def _planes(res):
    return (res.status, *res.last_point, *res.seg_start, *res.direction,
            res.n_bounces)


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_warp_and_block_schedules_agree_without_handoff(model, rng):
    """At thresh 0 a lane's slots do not depend on which thread takes it
    or when: the warp schedule (32 threads a unit, each taking 4 lanes in
    turn) and the lane-static block schedule (a thread per lane, all from
    step 0) give every slot plane bit for bit."""
    sv, srcv = _operands(model, CAP_POOL)
    args = ((7, 9), sv, srcv, N_POOL, int(model), CAP_POOL, BUDGET, 0, rng,
            POOL)
    warp = trace_cuda.refill_plain(*args, threads_per_unit=32)
    block = trace_cuda.refill_plain(*args, threads_per_unit=POOL)
    _assert_same_refill(warp, block)
    assert set(np.unique(warp[0].status.numpy())) <= {1, 2, 3}


@pytest.mark.parametrize("threads", [32, POOL])
def test_handoff_schedule_matches_the_kernel_loop(threads):
    """With the handoff the kernel's loop leaves each unit with at most
    ``thresh`` rays pending, most units with some; the pending slots are
    exactly each lane's from its live ``ray_idx`` on, the finished ones
    are those of the run without the handoff (a lane's rays do not depend
    on where its unit stops), and a rerun gives the same result.
    ``threads == lanes`` is the lane-static schedule; 32 the warp's."""
    thresh = int(HANDOFF * POOL * BUDGET)
    sv, srcv = _operands(SurfaceModel.LAMBERTIAN)
    args = ((5, 8), sv, srcv, N_POOL, 0, MAX_BOUNCES, BUDGET, thresh,
            "philox", POOL)
    plain = trace_cuda.refill_plain(*args, threads_per_unit=threads)
    _assert_same_refill(plain, trace_cuda.refill_plain(
        *args, threads_per_unit=threads))
    res, live = plain
    pending = res.status == RUNNING
    per_unit = pending.view(-1, POOL * BUDGET).sum(1)
    assert int(per_unit.max()) <= thresh
    assert (per_unit > 0).float().mean() >= 0.75
    f = torch.arange(N_POOL)
    unit, slot = f // (BUDGET * POOL), (f % (BUDGET * POOL)) // POOL
    assert torch.equal(pending,
                       slot >= live.ray_idx[unit * POOL + f % POOL])
    full, _ = trace_cuda.refill_plain(*args[:7], 0, *args[8:],
                                      threads_per_unit=threads)
    for a, b in zip(_planes(res), _planes(full)):
        assert torch.equal(a[~pending], b[~pending])


def test_live_planes_hold_the_three_lane_kinds():
    """After a handoff exit under the warp schedule each lane is one of:
    never taken (ray_idx 0 and no bounce: a lane in flight on its first
    ray has bounced at least once; the source ray, every slot pending),
    spent (ray_idx == budget, the source ray, no slot pending) or in
    flight (its slots from ray_idx on pending); all three occur, the lanes
    never taken are the end of their unit's pool, and the decode the
    straggler finish uses holds."""
    lanes, budget = trace_cuda.REFILL_LANES, 4
    n = 4 * lanes * budget
    thresh = int(0.4 * lanes * budget)
    sv, srcv = _operands(SurfaceModel.LAMBERTIAN)
    res, live = trace_cuda.refill((2, 3), sv, srcv, n, 0, MAX_BOUNCES,
                                  budget, thresh, rng="philox")
    f = np.arange(n)
    unit, slot = f // (budget * lanes), (f % (budget * lanes)) // lanes
    lane = unit * lanes + f % lanes
    ray_idx = live.ray_idx.numpy()
    pending = res.status.numpy() == RUNNING
    np.testing.assert_array_equal(pending, slot >= ray_idx[lane])
    src = srcv.numpy()
    at_src = np.all([c.numpy() == src[i] for i, c in
                     enumerate((*live.pos, *live.direction))], axis=0)
    spent = ray_idx == budget
    never = (ray_idx == 0) & (live.bounces.numpy() == 0)
    flight = ~never & ~spent
    n_pend = np.bincount(lane[pending], minlength=n // budget)
    assert never.any() and spent.any() and flight.any()
    assert at_src[never].all() and at_src[spent].all()
    assert (live.bounces.numpy()[never | spent] == 0).all()
    assert (n_pend[never] == budget).all() and (n_pend[spent] == 0).all()
    assert (n_pend[flight] == budget - ray_idx[flight]).all()
    assert not at_src[flight].all()
    # untaken lanes come after every taken one in their unit's pool
    taken = (~never).reshape(-1, lanes)
    assert all(t[:t.sum()].all() for t in taken)


@pytest.mark.parametrize("threads", [32, trace_cuda.REFILL_LANES])
def test_handoff_continuation_matches_jax(monkeypatch, threads):
    """The whole handoff path under the warp schedule and the lane-static
    one: no slot left RUNNING, no overflow, and the exit fraction and mean
    bounces within 4 sigma of JAX's refill with the same handoff fraction
    (independent streams)."""
    monkeypatch.setattr(trace_cuda, "REFILL_THREADS", threads)
    res, ovf = trace_cuda.trace_rays_refill(
        torch.Generator().manual_seed(11), convert.scene(SCENE_H),
        convert.source(SOURCE_OVERNIGHT), N, rays_per_lane=BUDGET,
        handoff_frac=HANDOFF, device="cpu")
    st = res.status.numpy()
    assert ((st >= 1) & (st <= 3)).all() and int(ovf) == 0
    ref = _jax_handoff()
    _assert_same_law(st, res.n_bounces.numpy(), np.asarray(ref.status),
                     np.asarray(ref.n_bounces), k=4)


def test_sass_step_mix_counts_one_step():
    """The per-step instruction count behind the kernels' bounds, on a
    listing shaped like cuobjdump's: the innermost loop holding the
    Philox multiplies is the step; a slow path jumped over around a
    nested loop and a finished ray's stores are left out of it; register
    moves (also as IMAD.MOV) and the warp's vote and lane count are told
    apart from the arithmetic."""
    from altair_tpu_torch.profile_refill import step_mix_of_sass

    body = ["MOV R0, RZ", "FADD R1, R1, R2"]      # before the loop: 0x00-0x10
    loop = (["IMAD.WIDE.U32 R4, R5, 0x3, RZ", "IMAD.HI.U32 R6, R7, 0x5, RZ"]
            * 10 + ["FFMA R1, R2, R3, R4", "LOP3.LUT R8, R8, R9, RZ, 0x96, !PT",
                    "MUFU.RSQ R2, R3", "IMAD.MOV.U32 R9, RZ, RZ, R8",
                    "VOTE.ANY R3, PT, P0", "POPC R4, R3"])
    n0 = len(body)
    lines = body + loop
    skip_at = len(lines)                          # jump over a slow path
    slow = ["IADD3 R1, R1, 1, RZ", "ISETP.NE.AND P0, PT, R1, RZ, PT"]
    lines += ["BRA 0x{:x}".format((skip_at + 1 + len(slow) + 1) * 16)]
    lines += slow + ["@P0 BRA 0x{:x}".format((skip_at + 1) * 16)]
    done_at = len(lines)                          # jump over the stores
    lines += ["@!P1 BRA 0x{:x}".format((done_at + 4) * 16),
              "FMUL R3, R3, R3", "STG.E desc[UR4][R10.64], R3",
              "STG.E desc[UR4][R12.64], R3"]
    lines += ["FADD R2, R2, R1", "@P2 BRA 0x{:x}".format(n0 * 16), "EXIT"]
    text = "\n\t\tFunction : _Z13refill_kernelILi0ELb0EEv\n" + "\n".join(
        "        /*{:04x}*/                   {} ;".format(16 * i, ins)
        for i, ins in enumerate(lines))
    mix = step_mix_of_sass(text, "refill_kernelILi0ELb0E")
    assert mix["unroll"] == 1
    # 20 multiplies + FFMA + LOP3 + MUFU + the move + VOTE and POPC + the
    # skip branch + FADD + the back branch + the stores' guard branch
    assert mix["per_step"] == {"imad": 20, "fp32": 2, "alu": 1, "xu": 1,
                               "move": 1, "warp": 2, "control": 3}
    assert mix["per_finished_ray"] == 3
    assert len(mix["slow_paths_left_out"]) == 1


def test_ops_bound_takes_the_slowest_arithmetic_pipe():
    """The operations bound is the slowest of the arithmetic pipes (FP32
    and IMAD sharing the FMA pipes); control, moves, uniform and warp code
    only enter the issue-slot time reported beside it."""
    from altair_tpu_torch.profile_refill import ops_bound_ms, pipe_ms

    crd = {"sms": 100, "max_sm_clock_mhz": 1000.0}
    steps = 100 * 1_000_000            # one step per SM per microsecond
    mix = {"per_step": {"fp32": 100, "imad": 28, "alu": 32, "xu": 8,
                        "control": 500, "move": 40, "uniform": 20,
                        "warp": 2}}
    ms, pipe = ops_bound_ms(mix, steps, crd)
    assert pipe == "fp32+imad" and ms == pytest.approx(1.0)
    mix["per_step"]["alu"] = 96        # 1.5 clocks a step on the ALU
    assert ops_bound_ms(mix, steps, crd) == (pytest.approx(1.5), "alu")
    assert pipe_ms(mix, steps, crd)["issue"] == pytest.approx(794 / 128)
