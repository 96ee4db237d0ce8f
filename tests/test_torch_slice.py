"""Port parity for the whole trace-once flux-map slice: ``trace_rays_auto``
+ ``fluxmap_trace_once_compact`` for both engines, the CSV of
``sweep_detector_trace_once``, and the package's independence from JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import altair_tpu_torch as T
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid, TraceConfig
from altair_tpu.core.score import exit_capacity, fluxmap_trace_once_compact as j_score
from altair_tpu.core.trace_waves import trace_rays_auto as j_auto
from altair_tpu.sweep.observer import sweep_detector_trace_once as j_sweep
from altair_tpu_torch import convert
from altair_tpu_torch.core.geometry import detector_position, line_hits_disk
from altair_tpu_torch.core.score import fluxmap_trace_once_compact as t_score
from altair_tpu_torch.sweep import sweep_detector_trace_once as t_sweep

torch.set_num_threads(1)

N = 32_768
SCENE = SCENE_OPTIMIZE.with_(max_bounces=256)
GRID = DetectorGrid(n_theta=18, n_phi=9)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hits_per_ray(res, grid):
    """[N] count of grid positions each ray's final segment hits: the
    summands of the map total, for its standard error."""
    th = grid.theta_centers().repeat_interleave(grid.n_phi)
    ph = grid.phi_centers().repeat(grid.n_theta)
    c, n = detector_position(th, ph, grid.radius, -100.0)
    mask = res.exited_port_mask()
    lp = res.last_point
    d = res.direction
    col = lambda v: v[:, None]
    row = lambda v: v[None, :]
    hit = line_hits_disk(type(lp)(col(lp.x), col(lp.y), col(lp.z)),
                         type(d)(col(d.x), col(d.y), col(d.z)),
                         type(c)(row(c.x), row(c.y), row(c.z)),
                         type(n)(row(n.x), row(n.y), row(n.z)),
                         grid.width / 2.0)
    return (hit & mask[:, None]).sum(1).double().numpy()


@pytest.mark.parametrize("engine", ["auto", "simulate"])
def test_slice_matches_jax(engine):
    """Exit fraction and map total within 4 sigma of JAX's (independent
    streams), zero compaction and rim overflow."""
    cap = exit_capacity(SCENE, N)
    jr = j_auto(jax.random.key(9), SCENE, SOURCE_OVERNIGHT, N,
                TraceConfig(engine=engine))
    jc, jo = j_score(jr, GRID, cap, SCENE.exit_port_z)
    tr, rim_ovf = T.trace_rays_auto(
        torch.Generator().manual_seed(9), convert.scene(SCENE),
        convert.source(SOURCE_OVERNIGHT), N, T.TraceConfig(engine=engine),
        device="cpu")
    tc, to = t_score(tr, convert.grid(GRID), cap, SCENE.exit_port_z)
    assert int(jo) == int(to) == int(rim_ovf) == 0

    f_j = float(jr.exited_port_mask().sum()) / N
    f_t = float(tr.exited_port_mask().sum()) / N
    assert abs(f_t - f_j) < 4 * np.sqrt(2 * f_j * (1 - f_j) / N), (f_t, f_j)

    h = _hits_per_ray(tr, convert.grid(GRID))
    assert h.sum() == int(tc.sum())            # the scorer counts the same
    sigma_total = np.sqrt(2 * N * h.var())
    assert abs(int(tc.sum()) - int(np.asarray(jc).sum())) < 4 * sigma_total


def test_csv_header_matches_jax(tmp_path):
    """The same header lines (the timestamp line aside) for the same
    configuration, and a map of the same shape."""
    kw = dict(n_rays=4096, grid=GRID, seed=3, verbose=False)
    jp = j_sweep(SCENE, SOURCE_OVERNIGHT, save_folder=str(tmp_path / "j"),
                 **kw)
    tp = t_sweep(convert.scene(SCENE), convert.source(SOURCE_OVERNIGHT),
                 device="cpu", save_folder=str(tmp_path / "t"),
                 **dict(kw, grid=convert.grid(GRID)))
    assert os.path.basename(jp.path) == os.path.basename(tp.path)

    def header(path):
        with open(path) as fh:
            lines = fh.read().splitlines()
        head = lines[:lines.index("theta,phi,fraction") + 1]
        return [ln for ln in head if "Generated:" not in ln], lines

    jh, jl = header(jp.path)
    th, tl = header(tp.path)
    assert th == jh
    assert len(tl) == len(jl)
    assert tp.fluxmap.shape == (18, 9) and tp.n_rays == 4096
    assert 0.38 < tp.n_exited / 4096 < 0.47


def test_unported_branches_raise():
    s = convert.scene(SCENE)
    so = convert.source(SOURCE_OVERNIGHT)
    g = torch.Generator()
    for cfg, scene in ((T.TraceConfig(keep_history=4), s),
                       (T.TraceConfig(), s.with_(outer_radius=110.0)),
                       (T.TraceConfig(engine="direct"),
                        s.with_(surface_model=T.SurfaceModel.MIXED_BRDF)),
                       (T.TraceConfig(engine="simulate"),
                        s.with_(outer_radius=110.0))):
        with pytest.raises(NotImplementedError):
            T.trace_rays_auto(g, scene, so, 64, cfg, device="cpu")


def test_package_imports_no_jax():
    code = ("import sys, altair_tpu_torch, altair_tpu_torch.sweep, "
            "altair_tpu_torch.convert, altair_tpu_torch.core.trace_cuda; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'altair_tpu.'))  or m == 'altair_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
