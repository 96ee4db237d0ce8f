"""Port parity of the sweep entry points (``altair_tpu_torch/sweep``) and the
``altair-tpu-torch`` CLI against ``altair_tpu`` on the CPU: the reference
CSV dialect of every sweep, the replicate statistics, the resume contract,
the distribution run and its writers, and the CLI run in-process."""

import functools
import os

import numpy as np
import pytest
import torch

from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT, DetectorGrid
from altair_tpu import sweep as jsweep
from altair_tpu_torch import cli, convert
from altair_tpu_torch import sweep as tsweep
from altair_tpu_torch.io import read_fluxmap

torch.set_num_threads(1)

SCENE = SCENE_OPTIMIZE.with_(max_bounces=4096)
GRID = DetectorGrid(n_theta=3, n_phi=4)
T_SCENE = convert.scene(SCENE)
T_SOURCE = convert.source(SOURCE_OVERNIGHT)
T_GRID = convert.grid(GRID)


def _dialect(path):
    """(header lines without the timestamp line, data row count, footer
    keys) of a flux-map CSV."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = lines.index("theta,phi,fraction")
    head = [ln for ln in lines[:i + 1] if "Generated:" not in ln]
    rows = [ln for ln in lines[i + 1:] if not ln.startswith("#")]
    foot = [ln.split(":", 1)[0] for ln in lines[i + 1:] if ln.startswith("#")]
    return head, len(rows), foot


SWEEPS = {
    "retrace": (jsweep.sweep_detector_retrace, tsweep.sweep_detector_retrace,
                dict(n_rays_per_pos=300)),
    "binomial": (jsweep.sweep_detector_retrace,
                 tsweep.sweep_detector_retrace,
                 dict(n_rays_per_pos=300, engine="binomial", oversample=8)),
    "twofold": (jsweep.sweep_detector_twofold, tsweep.sweep_detector_twofold,
                dict(n_rays_per_pair=300)),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_writes_reference_dialect(name, tmp_path):
    """The same file name, header (timestamp aside), column header, row
    count and footer keys as the JAX sweep on the same grid; the map in
    [0, 1] and equal to the CSV's rows."""
    j_fn, t_fn, kw = SWEEPS[name]
    jr = j_fn(SCENE, SOURCE_OVERNIGHT, grid=GRID, seed=4,
              save_folder=str(tmp_path / "j"), verbose=False, **kw)
    tr = t_fn(T_SCENE, T_SOURCE, device="cpu", grid=T_GRID, seed=4,
              save_folder=str(tmp_path / "t"), verbose=False, **kw)
    assert os.path.basename(tr.path) == os.path.basename(jr.path)
    assert _dialect(tr.path) == _dialect(jr.path)
    assert _dialect(tr.path)[1] == GRID.n_positions
    assert tr.fluxmap.shape == (3, 4)
    assert (tr.fluxmap >= 0).all() and (tr.fluxmap <= 1).all()
    _, _, frac, meta = read_fluxmap(tr.path)
    np.testing.assert_allclose(frac.reshape(3, 4), tr.fluxmap, atol=5e-7)
    n = kw.get("n_rays_per_pos", kw.get("n_rays_per_pair"))
    assert meta["Total ray hits"] == (
        f"{int(round(tr.fluxmap.sum() * n))} out of {n * GRID.n_positions}")


@pytest.mark.parametrize("trace_once", [True, False])
def test_write_fluxmap_csv_matches_jax_writer(trace_once, tmp_path):
    """The port's one whole-map writer (the CLI's replicates output, the
    trace-once, binomial and twofold sweeps) against the JAX package's
    writer on the same map: the same file name, header (timestamp aside),
    rows and footer keys; without a footer (the replicates file) and with
    one; and nothing written without a folder."""
    from altair_tpu.io import FluxmapWriter, fluxmap_filename
    from altair_tpu.sweep.observer import _metadata

    fm = np.random.default_rng(0).random((3, 4)) * 0.01
    footer = None if trace_once else dict(total_time_s=1.5, total_hits=7,
                                          n_total=3600)
    fname = fluxmap_filename(300, 3, 4, (-60.0, 0.0, -75.0), trace_once)
    with FluxmapWriter(str(tmp_path / "j" / fname),
                       _metadata(SCENE, SOURCE_OVERNIGHT, GRID, 300,
                                 trace_once)) as w:
        w.write_map(np.asarray(GRID.theta_centers()),
                    np.asarray(GRID.phi_centers()), fm)
        if footer is not None:
            w.write_footer(**footer)
        j_path = w.path
    t_path = tsweep.write_fluxmap_csv(str(tmp_path / "t"), T_SCENE, T_SOURCE,
                                      T_GRID, 300, fm, trace_once=trace_once,
                                      footer=footer)
    assert os.path.basename(t_path) == fname
    assert _dialect(t_path) == _dialect(j_path)
    assert bool(_dialect(t_path)[2]) == (footer is not None)
    np.testing.assert_array_equal(read_fluxmap(t_path)[2],
                                  read_fluxmap(j_path)[2])
    assert tsweep.write_fluxmap_csv(None, T_SCENE, T_SOURCE, T_GRID, 300, fm,
                                    trace_once=trace_once) is None


def test_resume_reproduces_full_run(tmp_path):
    """A run killed after one complete theta row and part of the next:
    the resume keeps the first row, redoes the partial one, writes under a
    fresh ``_1`` name, and its rows equal the full run's exactly."""
    kw = dict(device="cpu", n_rays_per_pos=400, grid=T_GRID, seed=6,
              verbose=False)
    full = tsweep.sweep_detector_retrace(T_SCENE, T_SOURCE,
                                         save_folder=str(tmp_path), **kw)
    with open(full.path) as fh:
        lines = fh.read().splitlines()
    i = lines.index("theta,phi,fraction")
    partial = tmp_path / "partial.csv"
    partial.write_text("\n".join(lines[:i + 1 + GRID.n_phi + 2]) + "\n")
    res = tsweep.sweep_detector_retrace(T_SCENE, T_SOURCE, save_folder=None,
                                        resume_path=str(partial), **kw)
    assert res.path == str(tmp_path / "partial_1.csv")
    np.testing.assert_array_equal(res.fluxmap, full.fluxmap)
    t_full = read_fluxmap(full.path)
    t_res = read_fluxmap(res.path)
    for a, b in zip(t_res[:3], t_full[:3]):
        np.testing.assert_array_equal(a, b)


def test_retrace_guards():
    kw = dict(device="cpu", grid=T_GRID, save_folder=None, verbose=False)
    with pytest.raises(ValueError, match="resume"):
        tsweep.sweep_detector_retrace(T_SCENE, T_SOURCE, engine="binomial",
                                      resume_path="x.csv", **kw)
    with pytest.raises(ValueError, match="engine"):
        tsweep.sweep_detector_retrace(T_SCENE, T_SOURCE, engine="nope", **kw)
    with pytest.raises(ValueError, match="multiple of n_phi"):
        tsweep.sweep_detector_retrace(T_SCENE, T_SOURCE, pos_chunk=6, **kw)
    with pytest.raises(ValueError, match="even n_phi"):
        tsweep.sweep_detector_twofold(
            T_SCENE, T_SOURCE, device="cpu",
            grid=convert.grid(DetectorGrid(n_theta=2, n_phi=5)),
            save_folder=None)
    with pytest.raises(ValueError, match="360"):
        tsweep.sweep_detector_twofold(
            T_SCENE, T_SOURCE, device="cpu",
            grid=convert.grid(DetectorGrid(n_theta=2, n_phi=4,
                                           phi_hi=180.0)),
            save_folder=None)


@functools.cache
def _jax_replicates(K, n):
    """JAX's mean map of K pseudorandom replicates of n rays."""
    grid = DetectorGrid(n_theta=6, n_phi=4)
    return np.asarray(jsweep.fluxmap_replicates(
        SCENE, SOURCE_OVERNIGHT, n_rays=n, grid=grid, replicates=K,
        seed=1)[0])


@pytest.mark.parametrize("qmc", [0, 2])
def test_replicates_match_jax(qmc):
    """Mean maps of K = 4 replicates within 5 sigma per cell of JAX's
    pseudorandom ones (two independent means of 4 x 4000 rays, sigma from
    JAX's mean floored at one hit: QMC changes the noise, not the law);
    the standard error is positive where the flux is, so each replicate
    (each Sobol randomisation with qmc) is its own draw."""
    from altair_tpu_torch import TraceConfig as TCfg

    K, n = 4, 4000
    jm = _jax_replicates(K, n)
    tm, ts = tsweep.fluxmap_replicates(
        T_SCENE, T_SOURCE, device="cpu", n_rays=n,
        grid=convert.grid(DetectorGrid(n_theta=6, n_phi=4)), replicates=K,
        seed=1, cfg=TCfg(qmc=qmc))
    assert tm.shape == ts.shape == (6, 4)
    pi = np.maximum(jm, 1.0 / (K * n))
    sigma = np.sqrt(2 * pi * (1 - pi) / (K * n))
    assert (np.abs(tm - jm) < 5 * sigma).all(), (tm, jm)
    bright = jm > 0.005
    assert bright.any() and (ts[bright] > 0).all()
    with pytest.raises(ValueError):
        tsweep.fluxmap_replicates(T_SCENE, T_SOURCE, device="cpu",
                                  replicates=1)


def test_distribution_matches_jax(tmp_path):
    """Exit count within 4 sigma of JAX's, histogram totals equal to it,
    and the two writers byte-equal to JAX's on the same payload."""
    n = 20_000
    jd = jsweep.run_distribution(SCENE, SOURCE_OVERNIGHT, n_rays=n, seed=2)
    td = tsweep.run_distribution(T_SCENE, T_SOURCE, device="cpu", n_rays=n,
                                 seed=2)
    p = jd.n_exited / n
    assert abs(td.n_exited - jd.n_exited) < 4 * np.sqrt(2 * n * p * (1 - p))
    assert td.angle_hist.shape == (180,) and td.dz_hist.shape == (100,)
    assert td.angle_hist.sum() == td.dz_hist.sum() == td.n_exited
    assert td.directions.shape == (td.n_exited, 3)
    assert [a.shape for a in td.direction_histograms_2d()] == [
        a.shape for a in jd.direction_histograms_2d()]
    for name, writer_j, writer_t, payload in (
            ("ad", jsweep.write_angular_dist, tsweep.write_angular_dist,
             td.dz_hist),
            ("rl", jsweep.write_ray_log, tsweep.write_ray_log,
             td.directions[:500])):
        writer_j(str(tmp_path / f"{name}_j.txt"), payload)
        writer_t(str(tmp_path / f"{name}_t.txt"), payload)
        assert ((tmp_path / f"{name}_t.txt").read_bytes()
                == (tmp_path / f"{name}_j.txt").read_bytes())


CLI_SMALL = ["--device", "cpu", "--theta-bins", "3", "--phi-bins", "4",
             "--max-bounces", "4096"]
CLI_CASES = {
    "trace-once": (["fluxmap", "--rays", "3000"],
                   "fluxmap_traceonce_3000rays_3x4_src-60_0_-75.csv"),
    "replicates": (["fluxmap", "--rays", "2000", "--replicates", "3",
                    "--qmc", "1"],
                   "fluxmap_traceonce_6000rays_3x4_src-60_0_-75.csv"),
    "retrace": (["fluxmap", "--method", "retrace", "--rays", "300"],
                "fluxmap_300rays_3x4_src-60_0_-75.csv"),
    "binomial": (["fluxmap", "--method", "retrace", "--retrace-engine",
                  "binomial", "--rays", "300", "--oversample", "8",
                  "--notify"],
                 "fluxmap_300rays_3x4_src-60_0_-75.csv"),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_fluxmap_in_process(case, tmp_path, capsys):
    args, fname = CLI_CASES[case]
    assert cli.main(args + CLI_SMALL + ["--out", str(tmp_path)]) == 0
    _, _, frac, _ = read_fluxmap(str(tmp_path / fname))
    assert frac.shape == (12,) and (frac >= 0).all() and frac.sum() > 0
    out = capsys.readouterr().out
    assert ("replicates x" in out) if case == "replicates" else "total" in out


def test_cli_distribution_in_process(tmp_path, capsys):
    rl, ad = tmp_path / "3dRayLog.txt", tmp_path / "angular_dist.txt"
    assert cli.main(["distribution", "--device", "cpu", "--rays", "4000",
                     "--max-bounces", "4096", "--ray-log", str(rl),
                     "--angular-dist", str(ad)]) == 0
    n_exit = int(capsys.readouterr().out.split(":")[-1])
    assert np.loadtxt(rl).shape == (n_exit, 3)
    assert np.loadtxt(ad)[:, 1].sum() == n_exit


def test_cli_cuda_without_a_card_is_an_error(monkeypatch):
    """``--device cuda`` (the default) with no visible card is an error; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["fluxmap", "--rays", "10"], ["distribution", "--rays", "10"],
                 ["fluxmap", "--device", "cuda:0", "--rays", "10"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args)
