"""The CUDA Plucker scorer kernel against its plain PyTorch version, on the
card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file
imports neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on
that machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_score_cuda.py -q

The kernel and ``_hits_block_mxu`` sum the 21 terms of ``s`` in different
orders (the plain version's is cuBLAS's), so a pair can come out on either
side of 0 only where ``s`` lies within float32 rounding of it.  Recomputed
in float64 from the same float32 operands, such a pair has

    |s64| <= C_S * eps * sum_k Phibar_k |W_k|,

eps = 2^-23, Phibar the features with each moment component replaced by
the sum of its cross product's two |products| (the cancellation in E x D
is where the features lose digits), C_S = 32: 21 roundings of the sum and
about 5 of each feature, with room.  The guard is ambiguous the same way
where |dn64| lies within 4 eps sum_i |D_i n_i| of PARALLEL_EPS.  So:
where a pair's hit differs, it is ambiguous (the per-pair tests); and a
position's kernel and plain counts may each differ from the float64 count
by at most its number of ambiguous pairs.  That is the per-position
tolerance of the count tests, which holds the kernel's counts against the
float64 test and not only against the plain version.  The band is a worst
case, so the count tests also hold kernel and plain to the JAX package's
scorer tolerance: at most 3 flips a position, the totals within 1e-4.
"""

import pytest
import torch

from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid,
                              TraceConfig, trace_rays_auto)
from altair_tpu_torch import profile_score
from altair_tpu_torch.core import score
from altair_tpu_torch.core.geometry import Vec3
from altair_tpu_torch.core.trace import TraceResult, f32
from altair_tpu_torch.io import profiling

pytestmark = pytest.mark.cuda

C_S = 32.0
EPS = 2.0 ** -23
MAX_BOUNCES = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def launches() -> int:
    return profiling.records()["totals"].get("kernel.score.launches", 0)


def _features64(E_rel, D):
    """Float64 features of the float32 operands, and their magnitudes."""
    e, d = E_rel.double(), D.double()
    m = torch.linalg.cross(e, d, dim=1)
    mbar = torch.stack([
        (e[:, 1] * d[:, 2]).abs() + (e[:, 2] * d[:, 1]).abs(),
        (e[:, 2] * d[:, 0]).abs() + (e[:, 0] * d[:, 2]).abs(),
        (e[:, 0] * d[:, 1]).abs() + (e[:, 1] * d[:, 0]).abs()], dim=1)
    iu0, iu1 = torch.triu_indices(6, 6, device=e.device)
    r6 = torch.cat([m, d], dim=1)
    r6bar = torch.cat([mbar, d.abs()], dim=1)
    return r6[:, iu0] * r6[:, iu1], r6bar[:, iu0] * r6bar[:, iu1]


def _pair_tests64(Phi, Phibar, D, W, Nrm):
    """``[N, P]`` float64 hits and ambiguity of one position block."""
    s = Phi @ W.double().T
    s_tol = C_S * EPS * (Phibar @ W.double().abs().T)
    dn = D.double() @ Nrm.double().T
    dn_tol = 4 * EPS * (D.double().abs() @ Nrm.double().abs().T)
    hit = (s <= 0) & (dn.abs() >= score.PARALLEL_EPS)
    amb = (s.abs() <= s_tol) | ((dn.abs() - score.PARALLEL_EPS).abs()
                                <= dn_tol)
    return hit, amb


def _valid(call):
    mask = call["rowmask"]
    if call["n_rows"] is not None:
        mask = mask & (torch.arange(mask.shape[0], device=mask.device)
                       < call["n_rows"])
    return mask


def counts64(call, chunk=128):
    """Per position: the float64 test's hit count over the valid rows and
    the number of ambiguous pairs."""
    valid = _valid(call)
    E_rel, D = call["E_rel"][valid], call["D"][valid]
    Phi, Phibar = _features64(E_rel, D)
    hits, amb = [], []
    for i in range(0, call["W"].shape[0], chunk):
        h, a = _pair_tests64(Phi, Phibar, D, call["W"][i:i + chunk],
                             call["Nrm"][i:i + chunk])
        hits.append(h.sum(0))
        amb.append(a.sum(0))
    return torch.cat(hits), torch.cat(amb)


def kernel(call):
    return score.plucker_counts(call["E_rel"], call["D"], call["rowmask"],
                                call["W"], call["Nrm"], call["n_rows"])


def check_counts(call):
    """The kernel's counts against the plain version's and the float64
    test's, within each position's ambiguous pairs; returns the three."""
    before = launches()
    k = kernel(call).long()
    torch.cuda.synchronize()
    assert launches() == before + 1
    p = profile_score.plain_counts(call).long()
    x, amb = counts64(call)
    assert ((k - x).abs() <= amb).all(), int(((k - x).abs() - amb).max())
    assert ((p - x).abs() <= amb).all(), int(((p - x).abs() - amb).max())
    assert ((k - p).abs() <= amb).all()
    # and at the edge-rounding scale of the JAX package's mxu-vs-exact
    # test (tests/test_score.py::TestMxuScorer): the band above is a
    # worst case (about 1.4% of the hits at the map shapes), the flips
    # are far fewer
    assert int((k - p).abs().max()) <= 3
    assert abs(int((k - p).sum())) <= 1e-4 * max(int(p.sum()), 1)
    return k, p, x


@pytest.mark.parametrize("shape", profile_score.SHAPES)
def test_kernel_matches_plain_at_the_map_shapes(cuda, shape):
    """The binomial map's 6.4M-ray shared sample (~2.7M valid rows of the
    compacted buffer) and a 100,000-ray MIXED_BRDF map (~46k of 100,000),
    each on the full 180x90 grid, as ``fluxmap_trace_once_compact`` hands
    them over (the valid rows a prefix, their count on the device)."""
    call = profile_score.scorer_call(cuda, shape, seed=5)
    assert call["n_rows"] is not None and call["W"].shape[0] == 16_200
    k, _, x = check_counts(call)
    n_valid = int(call["n_rows"])
    expect = (2_500_000, 2_900_000) if shape == "binomial" else (40_000,
                                                                  52_000)
    assert expect[0] < n_valid < expect[1]
    assert x.sum() > 100 * n_valid          # ~260 hits an exit


def _pairs(call):
    """Per-pair hits of the kernel (one launch per row) and of the plain
    version, ``[N, P]``."""
    N = call["E_rel"].shape[0]
    rows = []
    for r in range(N):
        one = torch.zeros(N, dtype=torch.bool, device=call["E_rel"].device)
        one[r] = call["rowmask"][r]
        rows.append(score.plucker_counts(call["E_rel"], call["D"], one,
                                         call["W"], call["Nrm"]))
    k = torch.stack(rows) > 0
    Phi = score._plucker_features(call["E_rel"], call["D"])
    s = Phi @ call["W"].T
    dn = call["D"] @ call["Nrm"].T
    p = (s <= 0) & (dn.abs() >= score.PARALLEL_EPS) & call["rowmask"][:, None]
    return k, p


def _synthetic(n_rows, n_pos, seed):
    """Rays aimed near the rims of grid disks: each row's exit point on
    the port plane, its direction towards a point at a random radius
    between 0.9 and 1.1 of a random disk's half width, in its plane."""
    g = torch.Generator().manual_seed(seed)
    grid = DetectorGrid()
    C, Nrm = score.grid_centers_normals(grid, -100.0)
    pick = torch.randint(0, C.shape[0], (n_pos,), generator=g)
    C, Nrm = C[pick], Nrm[pick]
    half_w = grid.width / 2.0
    aim = torch.randint(0, n_pos, (n_rows,), generator=g)
    u = torch.randn(n_rows, 3, generator=g)
    u = u - (u * Nrm[aim]).sum(1, keepdim=True) * Nrm[aim]
    u = u / u.norm(dim=1, keepdim=True)
    rad = half_w * (0.9 + 0.2 * torch.rand(n_rows, 1, generator=g))
    target = C[aim] + rad * u
    ang = 2 * torch.pi * torch.rand(n_rows, generator=g)
    rr = 5.0 * torch.rand(n_rows, generator=g).sqrt()
    E = torch.stack([rr * ang.cos(), rr * ang.sin(),
                     torch.full((n_rows,), -100.0)], dim=1)
    D = target - E
    D = D / D.norm(dim=1, keepdim=True)
    return E, D, C, Nrm


def _call(E, D, C, Nrm, rowmask=None, n_rows=None, device="cpu"):
    anchor = torch.tensor([0.0, 0.0, f32(-100.0)])
    W = score._plucker_weights(C - anchor, Nrm, DetectorGrid().width / 2.0)
    if rowmask is None:
        rowmask = torch.ones(E.shape[0], dtype=torch.bool)
    call = dict(E_rel=(E - anchor).float(), D=D.float(), rowmask=rowmask,
                W=W.float(), Nrm=Nrm.float(), n_rows=n_rows, pos_chunk=256)
    return {k: v.to(device).contiguous() if torch.is_tensor(v) else v
            for k, v in call.items()}


def _check_pairs(call):
    k, p = _pairs(call)
    diff = k != p
    Phi, Phibar = _features64(call["E_rel"], call["D"])
    _, amb = _pair_tests64(Phi, Phibar, call["D"], call["W"], call["Nrm"])
    assert not (diff & ~amb).any(), int((diff & ~amb).sum())
    return k


@pytest.mark.parametrize("n_rows,n_pos", [(257, 1025), (300, 700),
                                          (31, 5000)])
def test_near_edge_pairs_off_the_tiles(cuda, n_rows, n_pos):
    """Rays aimed within 10% of disk rims, row and position counts that are
    no multiple of the kernel's tiles: where a pair's hit differs from the
    plain version's, its float64 s is within rounding of 0."""
    E, D, C, Nrm = _synthetic(n_rows, n_pos, seed=n_rows)
    k = _check_pairs(_call(E, D, C, Nrm, device=cuda))
    assert k.any(1).float().mean() > 0.3   # the rim rays do hit


def test_edge_on_positions(cuda):
    """Rays in a disk's plane (d.n = 0 exactly) and rays that cross it at
    |d.n| of 1e-11, both refused by the guard whatever s says; rays at
    |d.n| of 1e-3 (the form's rounding swamps s there: every pair is
    ambiguous) and at 45 degrees (taken inside the disk, not outside),
    through points in and outside the disk."""
    n = 192
    g = torch.Generator().manual_seed(3)
    C = torch.tensor([[0.0, 0.0, -200.0]])
    Nrm = torch.tensor([[0.0, 0.0, 1.0]])
    ang = 2 * torch.pi * torch.rand(n, generator=g)
    rad = 30.0 * torch.rand(n, generator=g)       # disk half width 20
    hit_pt = torch.stack([rad * ang.cos(), rad * ang.sin(),
                          torch.full((n,), -200.0)], dim=1)
    tilt = torch.tensor([0.0, 1e-11, 1e-3, 1.0]).repeat(n // 4)
    D = torch.stack([torch.ones(n), torch.zeros(n), tilt], dim=1)
    D = D / D.norm(dim=1, keepdim=True)
    E = hit_pt - 50.0 * D
    call = _call(E, D, C, Nrm, device=cuda)
    k = _check_pairs(call)[:, 0].cpu()
    dn = call["D"][:, 2].cpu()
    assert (dn.abs() < score.PARALLEL_EPS).sum() == n // 2
    assert not k[dn.abs() < score.PARALLEL_EPS].any()
    steep = (tilt == 1.0) & ((rad - 20.0).abs() > 0.5)   # off the rim
    assert torch.equal(k[steep], rad[steep] < 20.0)


def test_row_count_and_mask(cuda):
    """A device row count of 0 scores nothing; one below N drops the last
    valid row; a mask whose valid rows are no prefix (the uncompacted
    caller's) scores exactly its rows."""
    E, D, C, Nrm = _synthetic(4000, 1500, seed=9)
    g = torch.Generator().manual_seed(10)
    mask = torch.rand(4000, generator=g) < 0.45
    zero = torch.zeros((), dtype=torch.int32)
    call = _call(E, D, C, Nrm, n_rows=zero, device=cuda)
    assert int(kernel(call).sum()) == 0
    for n_rows, rowmask in ((torch.tensor(3999, dtype=torch.int32), None),
                            (None, mask),
                            (torch.tensor(2500, dtype=torch.int32), mask)):
        call = _call(E, D, C, Nrm, rowmask=rowmask, n_rows=n_rows,
                     device=cuda)
        check_counts(call)
        k = kernel(call).long()
        # the same rows packed densely at the front, every one valid
        rows = _valid(call)
        dense = dict(call, E_rel=call["E_rel"][rows].contiguous(),
                     D=call["D"][rows].contiguous(),
                     rowmask=torch.ones(int(rows.sum()), dtype=torch.bool,
                                        device=cuda), n_rows=None)
        assert torch.equal(k, kernel(dense).long())


def test_float64_trace(cuda):
    """A float64 trace: ``fluxmap_trace_once`` anchors in float64 and
    hands the kernel float32 operands; its map equals the CPU's plain
    version on the same trace within each position's ambiguous pairs."""
    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES)
    res, _ = trace_rays_auto(torch.Generator().manual_seed(2), scene,
                             SOURCE_OVERNIGHT, 50_000,
                             TraceConfig(dtype=torch.float64), device=cuda)
    assert res.last_point.x.dtype == torch.float64
    grid = DetectorGrid(n_theta=60, n_phi=30)
    before = launches()
    k = score.fluxmap_trace_once(res, grid).long().cpu()
    assert launches() == before + 1
    cpu_res = TraceResult(res.status.cpu(),
                          *(Vec3(*(c.cpu() for c in v)) for v in
                            (res.last_point, res.seg_start, res.direction)),
                          res.n_bounces.cpu())
    p = score.fluxmap_trace_once(cpu_res, grid).long()
    assert launches() == before + 1              # the CPU ran plain
    mask = res.exited_port_mask(scene.exit_port_z)
    anchor = torch.tensor([0.0, 0.0, f32(scene.exit_port_z)],
                          dtype=torch.float64, device=cuda)
    C, Nrm = score.grid_centers_normals(grid, scene.exit_port_z, cuda)
    call = dict(E_rel=(res.last_point.stack() - anchor).float(),
                D=res.direction.stack().float(), rowmask=mask,
                W=score._plucker_weights(C - anchor.float(), Nrm,
                                         grid.width / 2.0),
                Nrm=Nrm, n_rows=None)
    x, amb = counts64(call)
    x, amb = x.cpu().view(grid.n_theta, grid.n_phi), amb.cpu().view(
        grid.n_theta, grid.n_phi)
    assert ((k - x).abs() <= amb).all() and ((p - x).abs() <= amb).all()
    assert x.sum() > 1000

