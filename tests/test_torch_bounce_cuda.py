"""The CUDA bounce kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file
imports neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on
that machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_bounce_cuda.py -q
"""

import numpy as np
import pytest
import torch

from altair_tpu_torch import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, SurfaceModel
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.io import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def launches(kernel: str) -> int:
    """The kernel's launches in this process (the tracer's process total)."""
    return profiling.records()["totals"].get(f"kernel.{kernel}.launches", 0)


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("model", list(SurfaceModel))
def test_kernel_matches_plain(cuda, model, rng):
    """Built with -fmad=false, the kernel does the plain version's float
    operations with the same CUDA math library: status and bounce count
    agree on >= 99.9% of lanes, positions within 1e-3 cm on those lanes."""
    n, max_bounces = 20_000, 256
    scene = SCENE_OPTIMIZE.with_(max_bounces=max_bounces, exact_rim=False,
                                 surface_model=model)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, cuda)
    before = launches("bounce")
    k = trace_cuda.bounce((11, 22), sv, srcv, n, int(model), max_bounces, rng)
    torch.cuda.synchronize()
    assert launches("bounce") == before + 1
    p = trace_cuda.bounce_plain((11, 22), sv, srcv, n, int(model),
                                max_bounces, rng)
    agree = (k.status == p.status) & (k.n_bounces == p.n_bounces)
    assert agree.float().mean().item() >= 0.999
    for f in ("last_point", "seg_start", "direction"):
        for c in "xyz":
            d = (getattr(getattr(k, f), c) - getattr(getattr(p, f), c)).abs()
            assert d[agree].max().item() <= 1e-3, (f, c)


def test_kernel_takes_any_n(cuda):
    scene = SCENE_OPTIMIZE.with_(max_bounces=64, exact_rim=False)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, cuda)
    for n in (1, 255, 257, 70_001):
        out = trace_cuda.bounce((1, 2), sv, srcv, n, 0, 64)
        st = out.status.cpu().numpy()
        assert st.shape == (n,) and set(np.unique(st)) <= {1, 2, 3}
