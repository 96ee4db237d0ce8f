"""The CUDA refill kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file
imports neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on
that machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_refill_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.io import profiling

pytestmark = pytest.mark.cuda

LANES = trace_cuda.REFILL_LANES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(device, model=SurfaceModel.LAMBERTIAN, max_bounces=256):
    scene = SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False,
                                 surface_model=model)
    return trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)


def _assert_matches_plain(k, k_live, p, p_live):
    """Built with -fmad=false, the kernel does the plain version's float
    operations: status and bounce count agree on >= 99.9% of slots,
    positions within 1e-3 cm on those, the live planes are equal."""
    agree = (k.status == p.status) & (k.n_bounces == p.n_bounces)
    assert agree.float().mean().item() >= 0.999
    for f in ("last_point", "seg_start", "direction"):
        for c in "xyz":
            d = (getattr(getattr(k, f), c) - getattr(getattr(p, f), c)).abs()
            assert d[agree].max().item() <= 1e-3, (f, c)
    assert (k_live is None) == (p_live is None)
    if k_live is not None:
        for a, b in zip((*k_live.pos, *k_live.direction, k_live.ray_idx,
                         k_live.bounces),
                        (*p_live.pos, *p_live.direction, p_live.ray_idx,
                         p_live.bounces)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("handoff", [0.0, 0.4])
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_kernel_matches_plain(cuda, model, rng, handoff):
    n, budget, max_bounces = 32_768, 4, 256
    thresh = int(handoff * LANES * budget)
    sv, srcv = _operands(cuda, model, max_bounces)
    args = ((11, 22), sv, srcv, n, int(model), max_bounces, budget, thresh)
    profiling.clear()
    with profiling.tracing():
        k, k_live = trace_cuda.refill(*args, rng=rng)
    torch.cuda.synchronize()
    rec = profiling.records()
    assert rec["totals"]["kernel.refill.launches"] == 1
    assert [s["attrs"]["n"] for s in rec["spans"]
            if s["name"] == "kernel.refill"] == [n]
    p, p_live = trace_cuda.refill_plain(*args, rng=rng)
    _assert_matches_plain(k, k_live, p, p_live)
    if thresh:
        assert (k.status == 0).any()        # the handoff left stragglers


@pytest.mark.parametrize("handoff", [0.0, 0.01, 0.4])
@pytest.mark.parametrize("units", [1, 5, 64])
def test_kernel_matches_plain_at_unit_multiples(cuda, units, handoff):
    """The warp schedule at 1, 5 and 64 units (one warp each), without
    and with the handoff: slots and live planes equal the plain version's,
    and each unit leaves with at most ``thresh`` rays pending."""
    budget = trace_cuda._REFILL_BUDGET
    n = units * LANES * budget
    thresh = int(handoff * LANES * budget)
    sv, srcv = _operands(cuda, max_bounces=512)
    args = ((5, 6), sv, srcv, n, 0, 512, budget, thresh)
    k, k_live = trace_cuda.refill(*args, rng="philox")
    p, p_live = trace_cuda.refill_plain(*args, rng="philox")
    _assert_matches_plain(k, k_live, p, p_live)
    pending = (k.status == 0).view(units, -1).sum(1)
    assert int(pending.max()) <= thresh


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_kernel_equals_the_lane_static_schedule(cuda, model, rng):
    """Without the handoff the kernel's slots are those of the lane-static
    schedule (``threads_per_unit == LANES``: a thread per lane, all from
    step 0), which the plain loop runs in other steps than the kernel's
    warp schedule: a lane's draws are keyed by its own step count."""
    n, budget, max_bounces = 32_768, 4, 256
    sv, srcv = _operands(cuda, model, max_bounces)
    args = ((13, 14), sv, srcv, n, int(model), max_bounces, budget, 0)
    k, _ = trace_cuda.refill(*args, rng=rng)
    p, _ = trace_cuda.refill_plain(*args, rng=rng, threads_per_unit=LANES)
    _assert_matches_plain(k, None, p, None)


def test_handoff_at_production_size(cuda):
    """The tail handoff at 2^20 rays with the dispatch's constants, which
    the TPU hardware tests never ran: the kernel matches its plain version
    per slot, and after the straggler finish every slot is done, nothing
    overflowed, and the exit fraction is the production scene's."""
    n, budget = 1 << 20, trace_cuda._REFILL_BUDGET
    thresh = int(trace_cuda._REFILL_HANDOFF * LANES * budget)
    sv, srcv = _operands(cuda, max_bounces=512)
    args = ((3, 4), sv, srcv, n, 0, 512, budget, thresh)
    k, k_live = trace_cuda.refill(*args, rng="philox")
    p, p_live = trace_cuda.refill_plain(*args, rng="philox")
    _assert_matches_plain(k, k_live, p, p_live)
    pending = (k.status == 0).view(-1, budget * LANES).sum(1)
    assert 0 < int(pending.max()) <= thresh
    scene = SCENE_OPTIMIZE.with_(max_bounces=4096, exact_rim=False)
    res, ovf = trace_cuda.trace_rays_refill(
        torch.Generator().manual_seed(5), scene, SOURCE_OVERNIGHT, n,
        rays_per_lane=budget, handoff_frac=trace_cuda._REFILL_HANDOFF,
        device=cuda)
    st = res.status.cpu().numpy()
    assert int(ovf) == 0 and set(np.unique(st)) <= {1, 2, 3}
    frac = float(res.exited_port_mask().float().mean())
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, cuda)
    ref = trace_cuda.bounce((6, 7), sv, srcv, n, 0, 4096)
    f_ref = float(ref.exited_port_mask().float().mean())
    assert abs(frac - f_ref) < 4 * math.sqrt(2 * f_ref * (1 - f_ref) / n)


def test_kernel_takes_any_block_multiple(cuda):
    sv, srcv = _operands(cuda, max_bounces=64)
    for budget in (1, 2, 4, 8):
        for blocks in (1, 3, 7):
            n = blocks * LANES * budget
            out, live = trace_cuda.refill((1, 2), sv, srcv, n, 0, 64, budget,
                                          thresh=1)
            st = out.status.cpu().numpy()
            assert st.shape == (n,) and set(np.unique(st)) <= {0, 1, 2, 3}
            assert live.ray_idx.shape == (n // budget,)
    with pytest.raises(ValueError):
        trace_cuda.refill((1, 2), sv, srcv, LANES * 4 + 1, 0, 64, 4)
    with pytest.raises(ValueError):
        trace_cuda.refill((1, 2), sv, srcv, 1 << 16, 0, 64, 4,
                          lane_block=16384)
