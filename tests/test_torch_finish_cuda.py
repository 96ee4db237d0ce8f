"""The CUDA finish kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file
imports neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on
that machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_finish_cuda.py -q
"""

import pytest
import torch

from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel,
                              TraceConfig, trace_rays_auto)
from altair_tpu_torch import profile_finish
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.io import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def totals(name: str) -> int:
    return profiling.records()["totals"].get(name, 0)


@pytest.mark.parametrize("entry", ["state", "source"])
@pytest.mark.parametrize("exact_rim", [True, False])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_kernel_matches_plain(cuda, model, exact_rim, entry):
    """Built with -fmad=false, the kernel does the plain version's float
    operations with the same CUDA math library: on a state with lanes in
    the gap, interior, dead and (at a 256-step cap) suspended, and on the
    thick-rim route's entry (20,000 source rays of the 105 cm shell, the
    same cap), status and bounce count are equal on every lane, positions
    and directions within 1e-3 cm (NaN where both are NaN)."""
    if entry == "state":
        call = profile_finish.mixed_entry_state(cuda, model)
        kinds = profile_finish.lane_kinds(call["state"])
        assert min(kinds.values()) > 0, kinds
    else:
        call = profile_finish.source_entry_call(cuda, model, n=20_000,
                                                max_iters=256)
        assert profile_finish.lane_kinds(call["state"])["interior"] == 20_000
    call["exact_rim"] = exact_rim
    n = call["state"][3].shape[0]
    launches, rays = totals("kernel.finish.launches"), totals(
        "kernel.finish.rays")
    k = trace_cuda.finish(**call)
    torch.cuda.synchronize()
    assert totals("kernel.finish.launches") == launches + 1
    assert totals("kernel.finish.rays") == rays + n
    p = trace_cuda.finish_plain(**call)
    assert torch.equal(k.status, p.status)
    assert torch.equal(k.n_bounces, p.n_bounces)
    assert (k.status == 3).any() and not (k.status == 0).any()
    # dead padding lanes pass their state through, NaN directions and all
    for f in ("last_point", "seg_start", "direction"):
        for a, b in zip(getattr(k, f), getattr(p, f)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3,
                                       equal_nan=True, msg=f)


def slots(device, model, exact_rim=True) -> int:
    """The card's resident threads for the instantiation (law, physics)."""
    return trace_cuda.finish_slots(device, int(model), exact_rim)


def bits(res):
    """Every output plane of a ``TraceResult`` as its raw 32-bit words."""
    return [t.view(torch.int32) for t in (res.status, *res.last_point,
                                          *res.seg_start, *res.direction,
                                          res.n_bounces)]


def traced_finish(call):
    """``trace_cuda.finish(**call)`` with the tracer on: the result, the
    launch's ``lanes_per_thread`` and its ``kernel.finish.pooled`` count."""
    profiling.clear()
    with profiling.tracing():
        res = trace_cuda.finish(**call)
    rec = profiling.records()
    profiling.clear()
    (sp,) = [s for s in rec["spans"] if s["name"] == "kernel.finish"]
    return (res, sp["attrs"]["lanes_per_thread"],
            rec["totals"]["kernel.finish.pooled"])


def wide_call(device, model, exact_rim, entry):
    """``finish`` arguments wider than the card's resident threads: the
    105 cm shell's source rays; the same with every lane past the first
    half of the resident threads dead, as a compacted state buffer holds
    its live lanes first; or a mixed state (gap, dead and interior lanes)
    padded with interior source rays; 256 steps at most."""
    width = 2 * slots(device, model, exact_rim) + 4_321
    if entry in ("source", "live_first"):
        call = profile_finish.source_entry_call(device, model, n=width,
                                                max_iters=256)
        if entry == "live_first":
            status = call["state"][3].clone()
            status[slots(device, model, exact_rim) // 2:] = 2  # ABSORBED
            call["state"] = (*call["state"][:3], status, *call["state"][4:])
    else:
        call = profile_finish.mixed_entry_state(device, model,
                                                n_interior=width - 20_000)
    call["exact_rim"] = exact_rim
    return call


@pytest.mark.parametrize("entry", ["state", "source", "live_first"])
@pytest.mark.parametrize("exact_rim", [True, False])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_pooled_launch_matches_plain(cuda, model, exact_rim, entry):
    """A buffer wider than the card's resident threads takes the pool
    (threads take the next lanes as theirs stop; pool rows with no live
    lane pass through at once): the launch says so on its span and
    counter, and every lane is the plain version's, status and bounce
    count equal, positions and directions within 1e-3 cm."""
    call = wide_call(cuda, model, exact_rim, entry)
    n = call["state"][3].shape[0]
    k, depth, pooled = traced_finish(call)
    torch.cuda.synchronize()
    assert depth == trace_cuda.finish_lanes_per_thread(
        n, slots(cuda, model, exact_rim)) > 1
    assert pooled == 1
    p = trace_cuda.finish_plain(**call)
    assert torch.equal(k.status, p.status)
    assert torch.equal(k.n_bounces, p.n_bounces)
    assert (k.status == 3).any() and not (k.status == 0).any()
    for f in ("last_point", "seg_start", "direction"):
        for a, b in zip(getattr(k, f), getattr(p, f)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3,
                                       equal_nan=True, msg=f)


@pytest.mark.parametrize("entry", ["state", "source"])
def test_pooled_launches_repeat_bit_for_bit(cuda, entry):
    """Two pooled launches of one call (the same seed) give the same bits
    on every lane, whichever thread ran it when."""
    call = wide_call(cuda, SurfaceModel.MIXED_BRDF, True, entry)
    a = bits(trace_cuda.finish(**call))
    b = bits(trace_cuda.finish(**call))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_at_the_resident_threads_is_one_lane_a_thread(cuda):
    """A buffer at or below the card's resident threads runs one lane a
    thread (``lanes_per_thread`` 1, not counted as pooled); one lane more
    takes the pool at two lanes a thread."""
    width = slots(cuda, SurfaceModel.LAMBERTIAN)
    depths = [traced_finish(profile_finish.source_entry_call(
        cuda, n=n, max_iters=64))[1:] for n in (6_250, width, width + 1)]
    assert depths == [(1, 0), (1, 0), (2, 1)]


@pytest.mark.parametrize("n,finishes", [(100_000, [True]),
                                        (1 << 20, [False, True])])
def test_main_paths_launch_finish(cuda, n, finishes):
    """The simulate engine of an exact-rim MIXED_BRDF scene runs the rim
    continuation, and above REFILL_MIN first the straggler finish, as one
    finish launch each, and no eager or waves loop under them."""
    scene = SCENE_OPTIMIZE.with_(max_bounces=4096,
                                 surface_model=SurfaceModel.MIXED_BRDF)
    profiling.clear()
    with profiling.tracing():
        res, ovf = trace_rays_auto(torch.Generator().manual_seed(4), scene,
                                   SOURCE_OVERNIGHT, n,
                                   TraceConfig(engine="simulate"),
                                   device=cuda)
    assert int(ovf) == 0 and not bool((res.status == 0).any())
    spans = profiling.records()["spans"]
    profiling.clear()
    assert [s["attrs"]["exact_rim"] for s in spans
            if s["name"] == "kernel.finish"] == finishes
    assert not [s for s in spans if s["name"] in ("loop.eager", "loop.waves")]
    assert {s["attrs"]["entry"] for s in spans
            if s["name"] == "kernel.finish"} == {"state"}


def test_thick_rim_launches_finish_from_the_source(cuda):
    """A thick rim (the in-sphere sweep's 105 cm shell) runs the route
    ``finish``: one finish launch of the whole batch from the source, exact
    rim, and no eager or waves loop; every ray finished."""
    from altair_tpu_torch import SCENE_INSPHERE, SOURCE_DEMO

    profiling.clear()
    with profiling.tracing():
        res, ovf = trace_rays_auto(torch.Generator().manual_seed(6),
                                   SCENE_INSPHERE, SOURCE_DEMO, 200_000,
                                   TraceConfig(), device=cuda)
    assert int(ovf) == 0 and not bool((res.status == 0).any())
    spans = profiling.records()["spans"]
    profiling.clear()
    assert [s["attrs"]["route"] for s in spans if s["name"] == "trace"] == [
        "finish"]
    assert [(s["attrs"]["n"], s["attrs"]["exact_rim"], s["attrs"]["entry"])
            for s in spans if s["name"] == "kernel.finish"] == [
        (200_000, True, "source")]
    assert not [s for s in spans if s["name"] in ("loop.eager", "loop.waves")]
