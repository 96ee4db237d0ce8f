"""The single-card studies on the card: the kernel paths of the series, the
in-sphere retrace and the scatter-retrace sweep, path history and the
profiler wrapper.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere.  This file imports
neither JAX nor ``altair_tpu`` (the GPU machine has no JAX), so on that
machine run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_studies_cuda.py -q
"""

import numpy as np
import pytest
import torch

from altair_tpu_torch import (SCENE_OPTIMIZE, SOURCE_DEMO, SOURCE_OVERNIGHT,
                              DetectorGrid, SurfaceModel, TraceConfig)
from altair_tpu_torch.config import expected_exit_fraction
from altair_tpu_torch.core import trace_cuda
from altair_tpu_torch.io import profiling
from altair_tpu_torch import sweep

pytestmark = pytest.mark.cuda

SCENE = SCENE_OPTIMIZE.with_(max_bounces=2048)
GRID = DetectorGrid(n_theta=18, n_phi=9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def launches(kernel: str) -> int:
    """The kernel's launches in this process (the tracer's process total)."""
    return profiling.records()["totals"].get(f"kernel.{kernel}.launches", 0)


def test_series_simulate_members_launch_the_bounce_kernel(cuda):
    """One bounce launch a member, and exit fractions that agree with the
    direct engine's members within 4 sigma."""
    n, ports = 50_000, [164.0, 170.0, 176.0]
    kw = dict(device=cuda, port_angles=ports, n_rays=n, grid=GRID, seed=1)
    _, direct = sweep.run_series_vmapped(SCENE, SOURCE_OVERNIGHT, **kw)
    profiling.clear()
    counts, exits = sweep.run_series_vmapped(
        SCENE, SOURCE_OVERNIGHT, cfg=TraceConfig(engine="simulate"), **kw)
    assert launches("bounce") == len(ports)
    assert counts.shape == (3, 18, 9)
    for p, e, d in zip(ports, exits, direct):
        f = d / n
        assert abs(e / n - f) < 4 * np.sqrt(2 * f * (1 - f) / n)
        assert e / n < expected_exit_fraction(p, 0.99) + 4 * np.sqrt(
            f * (1 - f) / n)


def test_insphere_retrace_chunk_reaches_the_refill_kernel(cuda, monkeypatch):
    """A simulate retrace chunk at or above ``REFILL_MIN`` rays (lowered
    here to keep the batch small) launches the refill kernel once a chunk;
    its fractions agree with a trace-once sweep within 5 sigma."""
    monkeypatch.setattr(trace_cuda, "REFILL_MIN", 1 << 17)
    n = 20_000
    kw = dict(device=cuda, n_rays=n, dtheta=2.0, theta_max=7.0,
              disk_radius=20.0, save_path=None)
    once = sweep.sweep_insphere_detector(SCENE, SOURCE_DEMO, seed=2, **kw)
    profiling.clear()
    re = sweep.sweep_insphere_detector(
        SCENE, SOURCE_DEMO, seed=3, retrace=True, pos_chunk=8,
        cfg=TraceConfig(engine="simulate"), **kw)
    assert (launches("bounce"), launches("refill")) == (0, 2)
    assert re.fractions.shape == (16,)
    pi = np.maximum((re.fractions + once.fractions) / 2, 1 / n)
    z = np.abs(re.fractions - once.fractions) / np.sqrt(2 * pi * (1 - pi) / n)
    assert z.max() < 5, z


def test_scatter_retrace_stage_one_through_the_bounce_kernel(cuda):
    n = 50_000
    profiling.clear()
    res, ovf = sweep.trace_scatter_retrace(
        torch.Generator().manual_seed(4),
        SCENE.with_(surface_model=SurfaceModel.MIXED_BRDF), SOURCE_OVERNIGHT,
        n, device=cuda)
    assert launches("bounce") == 1 and int(ovf) == 0
    assert res.status.device.type == "cuda"
    assert set(res.status.unique().tolist()) <= {1, 2, 3}


def test_history_and_device_trace_on_the_card(cuda, tmp_path):
    """The history buffer is written on the card; ``device_trace`` sees the
    card's activity and writes the chrome trace."""
    from altair_tpu_torch import trace_rays_auto
    from altair_tpu_torch.io import device_busy_s, device_trace

    with device_trace(str(tmp_path)) as log_dir:
        # 64 steps: the profiler's own cost grows with the events it keeps
        res, _ = trace_rays_auto(torch.Generator().manual_seed(5),
                                 SCENE.with_(max_bounces=64),
                                 SOURCE_OVERNIGHT, 200,
                                 TraceConfig(keep_history=64), device=cuda)
        torch.cuda.synchronize()
    assert res.history.device.type == "cuda"
    assert res.history.shape == (64, 200, 3)
    hlen = res.history_len.cpu().numpy()
    last = res.history.cpu().numpy()[hlen - 1, np.arange(200)]
    room = hlen < 64
    np.testing.assert_array_equal(
        last[room], res.last_point.stack().cpu().numpy()[room])
    assert device_busy_s(device_trace.last) > 0
    assert (tmp_path / "trace.json").stat().st_size > 10_000
    assert log_dir == str(tmp_path)
