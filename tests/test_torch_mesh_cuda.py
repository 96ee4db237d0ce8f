"""The multi-device layer on the card: world size 1 over NCCL, in process.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file imports
neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on that
machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q
"""

import pytest
import torch

from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid,
                              TraceConfig, trace_rays_auto)
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.core.score import (exit_capacity,
                                         fluxmap_trace_once_compact)
from altair_tpu_torch.core.trace import fold_in
from altair_tpu_torch.parallel import (demo, init_distributed, make_mesh,
                                       sharded_fluxmap)

pytestmark = pytest.mark.cuda

SCENE = SCENE_OPTIMIZE.with_(max_bounces=2048)
GRID = DetectorGrid(n_theta=18, n_phi=9)
N = 20_000


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    init_distributed(backend="nccl", rank=0, world_size=1,
                     store=dist.HashStore())
    yield make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["auto", "simulate"])
def test_world_of_one_equals_the_single_device_run(mesh, engine):
    """NCCL at world size 1 still runs the collective; the sharded map
    equals, cell for cell, the single-device trace from ``fold_in(key,
    0)`` scored by the compacting scorer.  The simulate engine's run goes
    through the bounce kernel."""
    assert mesh.backend == "nccl" and mesh.world_size == 1
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    cfg = TraceConfig(engine=engine)
    key = torch.Generator().manual_seed(11)
    trace_cuda.reset_launch_counts()
    counts, n_exit = sharded_fluxmap(mesh, key, SCENE, SOURCE_OVERNIGHT, GRID,
                                     N, cfg)
    assert trace_cuda.launch_counts["bounce"] == (engine == "simulate")
    res, rim = trace_rays_auto(fold_in(key, 0), SCENE, SOURCE_OVERNIGHT, N,
                               cfg, device=mesh.device)
    ref, overflow = fluxmap_trace_once_compact(
        res, GRID, exit_capacity(SCENE, N), SCENE.exit_port_z)
    assert int(overflow) == 0 and int(rim) == 0
    assert counts.dtype == torch.int32 and counts.device == mesh.device
    assert torch.equal(counts, ref)
    assert int(n_exit) == int(res.exited_port_mask(SCENE.exit_port_z).sum())
    assert 0.40 < int(n_exit) / N < 0.45


def test_every_route_equals_the_single_device_functions(mesh):
    got = demo.run_routes(mesh, N)
    want = demo.reference(1, N, mesh.device)
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        if name.endswith("_local_exits"):
            ref = ref[0]
        assert got[name].shape == ref.shape and (got[name] == ref).all(), name
