"""``mesh=`` on the port's sweeps and ``--mesh`` on its CLI, on the CPU:
two gloo ranks, started once through the package's launcher, run every
sweep that takes a mesh; the CLI runs under ``torchrun``.

Rank 0 alone prints the stamps and writes the files; both ranks return the
same numbers and rank 0's path; a sweep's CSV has the header keys and the
footer fields of the same sweep without a mesh.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from altair_tpu_torch import DetectorGrid
from altair_tpu_torch.io import read_fluxmap
from altair_tpu_torch.parallel import demo
from altair_tpu_torch.sweep import (read_detector_sweep, run_distribution,
                                    sweep_detector_retrace,
                                    sweep_detector_trace_once,
                                    sweep_detector_twofold,
                                    sweep_insphere_detector,
                                    sweep_scatter_retrace)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)
N_RAYS = 2048
NPP = demo.per_pos(N_RAYS)
KW = dict(device="cpu", cfg=demo.CFG, verbose=False)
# the sweeps of demo.run_sweeps without a mesh: name -> (call, grid, rays)
PLAIN = {
    "trace_once": (lambda folder: sweep_detector_trace_once(
        demo.SCENE, demo.SOURCE, n_rays=N_RAYS, grid=demo.GRID, seed=1,
        save_folder=folder, **KW), demo.GRID, N_RAYS),
    "retrace": (lambda folder: sweep_detector_retrace(
        demo.SCENE, demo.SOURCE, n_rays_per_pos=NPP, grid=demo.GRID_SMALL,
        seed=2, save_folder=folder, **KW), demo.GRID_SMALL, NPP),
    "retrace_binomial": (lambda folder: sweep_detector_retrace(
        demo.SCENE, demo.SOURCE, n_rays_per_pos=NPP, grid=demo.GRID_SMALL,
        seed=3, engine="binomial", oversample=demo.OVERSAMPLE,
        save_folder=folder, **KW), demo.GRID_SMALL, NPP),
    "twofold": (lambda folder: sweep_detector_twofold(
        demo.SCENE, demo.SOURCE, n_rays_per_pair=NPP,
        grid=DetectorGrid(n_theta=2, n_phi=4), seed=4, save_folder=folder,
        **KW), DetectorGrid(n_theta=2, n_phi=4), NPP),
}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One two-rank run of every sweep: ``(rank0, rank1, stdout)``."""
    out = tmp_path_factory.mktemp("mesh_sweeps")
    p = subprocess.run(
        [sys.executable, "-m", "altair_tpu_torch.parallel.demo", "--launch",
         "2", "--device", "cpu", "--what", "sweeps", "--rays", str(N_RAYS),
         "--out", str(out)],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    r0, r1 = (dict(np.load(out / f"rank{r}.npz", allow_pickle=True))
              for r in (0, 1))
    return r0, r1, p.stdout


def _sigma_ok(got, ref, n):
    """Two maps of fractions out of ``n`` rays, within 4 sigma per cell."""
    a, b = got * n, ref * n
    return (np.abs(a - b) < 4 * np.sqrt(np.maximum(a + b, 1)) + 10).all()


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_observer_sweep_csv_matches_the_sweep_without_a_mesh(
        name, launched, tmp_path):
    r0, r1, _ = launched
    run, grid, n = PLAIN[name]
    plain = run(str(tmp_path))
    path = str(r0[f"sweep_{name}_path"])
    assert path == str(r1[f"sweep_{name}_path"]) and os.path.exists(path)
    assert os.path.basename(path) == os.path.basename(plain.path)
    th, ph, frac, meta = read_fluxmap(path)
    th_p, ph_p, frac_p, meta_p = read_fluxmap(plain.path)
    # same header keys and footer fields; same positions
    assert list(meta) == list(meta_p)
    for k in meta:
        if not any(w in k.lower() for w in (
                "time", "generated", "completed", "hits", "exiting")):
            assert meta[k] == meta_p[k], k
    np.testing.assert_array_equal(th, th_p)
    np.testing.assert_array_equal(ph, ph_p)
    fm = r0[f"sweep_{name}_fluxmap"]
    np.testing.assert_array_equal(fm, r1[f"sweep_{name}_fluxmap"])
    assert fm.shape == (grid.n_theta, grid.n_phi)
    np.testing.assert_allclose(frac, fm.ravel(), atol=5e-7)   # %.6f rows
    if name != "trace_once":      # the retrace dialects count no exits
        assert int(r0[f"sweep_{name}_n_exited"]) == plain.n_exited == -1
    assert fm.sum() > 0 and _sigma_ok(fm, plain.fluxmap, n)


def test_trace_once_exit_count_is_the_sum_over_ranks(launched):
    r0, r1, _ = launched
    n_exit = int(r0["sweep_trace_once_n_exited"])
    assert n_exit == int(r1["sweep_trace_once_n_exited"])
    assert 0.2 < n_exit / N_RAYS < 0.5
    _, _, _, meta = read_fluxmap(str(r0["sweep_trace_once_path"]))
    assert meta["Total rays exiting port"] == f"{n_exit} out of {N_RAYS}"


def test_rank0_alone_prints_the_stamps(launched):
    out = launched[2]
    for stamp in ("Starting sweep setup", "Tracing all rays once",
                  "Sharded retrace over 2 devices",
                  f"Binomial retrace: sampling {demo.OVERSAMPLE}x{NPP}"):
        assert out.count(stamp) == 1, stamp
    assert out.count("Flux map data saved to") == 3
    assert out.count("theta=") == 2      # twofold: one line a theta row


def test_distribution_gathers_every_ranks_directions(launched):
    r0, r1, _ = launched
    plain = run_distribution(demo.SCENE, demo.SOURCE, device="cpu",
                             n_rays=N_RAYS, seed=5, cfg=demo.CFG)
    for k in ("n_exited", "angle_hist", "dz_hist", "directions"):
        np.testing.assert_array_equal(r0[f"sweep_distribution_{k}"],
                                      r1[f"sweep_distribution_{k}"])
    n_exit = int(r0["sweep_distribution_n_exited"])
    dirs = r0["sweep_distribution_directions"]
    assert dirs.shape == (n_exit, 3)
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-4)
    assert r0["sweep_distribution_dz_hist"].sum() == n_exit
    assert r0["sweep_distribution_angle_hist"].shape == \
        plain.angle_hist.shape == (180,)
    p = plain.n_exited / N_RAYS
    assert abs(n_exit - plain.n_exited) < 4 * np.sqrt(
        2 * p * (1 - p) * N_RAYS)
    assert (np.abs(r0["sweep_distribution_dz_hist"].astype(float)
                   - plain.dz_hist) < 4 * np.sqrt(
                       np.maximum(plain.dz_hist, 1)) + 10).all()


def test_insphere_file_is_rank0s_last_sweep(launched, tmp_path):
    r0, r1, _ = launched
    plain = sweep_insphere_detector(
        demo.SCENE_DISK, demo.SOURCE, device="cpu", n_rays=N_RAYS,
        dtheta=15.0, theta_max=30.0, seed=6, cfg=demo.CFG,
        save_path=str(tmp_path / "sweep.txt"))
    for k in ("insphere_fractions", "insphere_retrace_fractions"):
        np.testing.assert_array_equal(r0[f"sweep_{k}"], r1[f"sweep_{k}"])
        assert r0[f"sweep_{k}"].shape == plain.fractions.shape == (10,)
    assert _sigma_ok(r0["sweep_insphere_fractions"], plain.fractions, N_RAYS)
    th, ph, frac = read_detector_sweep(str(r0["sweep_insphere_path"]))
    np.testing.assert_array_equal(th, plain.thetas)
    np.testing.assert_array_equal(ph, plain.phis)
    np.testing.assert_allclose(frac, r0["sweep_insphere_retrace_fractions"],
                               rtol=1e-5)


def test_scatter_retrace_map_is_the_same_on_both_ranks(launched):
    r0, r1, _ = launched
    plain = sweep_scatter_retrace(demo.SCENE_BRDF, demo.SOURCE, device="cpu",
                                  n_rays=N_RAYS, grid=demo.GRID_BRDF, seed=7,
                                  cfg=demo.CFG)
    fm = r0["sweep_scatter_retrace_fluxmap"]
    np.testing.assert_array_equal(fm, r1["sweep_scatter_retrace_fluxmap"])
    assert fm.shape == plain.fluxmap.shape == (9, 4)
    assert _sigma_ok(fm, plain.fluxmap, N_RAYS)


# ---------------------------------------------------------------------------
# a write that fails on rank 0 raises on every rank
# ---------------------------------------------------------------------------

# one rank: argv = rank, the FileStore's file, a path below a regular file
FAILING_WRITES = """
import datetime, sys
import torch
import torch.distributed as dist
from altair_tpu_torch.parallel import demo, init_distributed, make_mesh
from altair_tpu_torch.sweep import (sweep_detector_trace_once,
                                    sweep_insphere_detector)

torch.set_num_threads(1)
rank, store, bad = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(rank=rank, world_size=2, store=dist.FileStore(store, 2),
                 timeout=datetime.timedelta(seconds=30), device="cpu")
mesh = make_mesh("cpu")
runs = {
    "trace_once": lambda: sweep_detector_trace_once(
        demo.SCENE, demo.SOURCE, device="cpu", n_rays=512, grid=demo.GRID,
        cfg=demo.CFG, save_folder=bad, verbose=False, mesh=mesh),
    "insphere": lambda: sweep_insphere_detector(
        demo.SCENE_DISK, demo.SOURCE, device="cpu", n_rays=512, dtheta=15.0,
        theta_max=30.0, cfg=demo.CFG, save_path=bad, mesh=mesh),
}
for name, run in runs.items():
    try:
        run()
    except RuntimeError as exc:
        print(f"{name}: {exc}".replace(chr(10), " "), flush=True)
    else:
        print(f"{name}: returned", flush=True)
# the group is still in step after the failures
total = mesh.all_reduce_sum(torch.tensor([rank + 1], dtype=torch.int32))
print(f"sum {int(total)}", flush=True)
dist.destroy_process_group()
"""


def test_failed_write_on_rank0_raises_on_every_rank(tmp_path):
    """Rank 0 cannot write below a regular file.  It sends the failure in
    the place of the path, so the other rank raises with it at once and
    does not wait out the collective's timeout for a value that never
    comes; the next collective finds both ranks in step."""
    (tmp_path / "a_file").write_text("not a folder")
    bad = str(tmp_path / "a_file" / "below")
    procs = [subprocess.Popen(
        [sys.executable, "-c", FAILING_WRITES, str(r),
         str(tmp_path / "rendezvous"), bad],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    try:
        done = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, done):
        assert p.returncode == 0, out[-1000:] + err[-3000:]
    lines = [out.splitlines() for out, _ in done]
    assert lines[0] == lines[1] and len(lines[0]) == 3
    for name, line in zip(("trace_once", "insphere"), lines[0]):
        assert line.startswith(f"{name}: rank 0 failed: NotADirectoryError")
    assert lines[0][2] == "sum 3"


# ---------------------------------------------------------------------------
# the CLI: --mesh under torchrun, and the error outside it
# ---------------------------------------------------------------------------

SCENE_ARGS = ["--device", "cpu", "--max-bounces", "64", "--rays", "1024"]
CLI = {
    "fluxmap": (["--theta-bins", "6", "--phi-bins", "3", "--out", "{d}"],
                None),
    "distribution": (["--ray-log", "{d}/rays.txt", "--angular-dist",
                      "{d}/ang.txt"], "rays.txt"),
    "insphere": (["--dtheta", "15", "--theta-max", "30", "--out-file",
                  "{d}/sweep.txt"], "sweep.txt"),
    "scatter-retrace": (["--theta-bins", "9", "--phi-bins", "4",
                         "--out-file", "{d}/map.csv"], "map.csv"),
}


@pytest.fixture(scope="module")
def torchrun(tmp_path_factory):
    """Each subcommand with ``--mesh`` under ``torchrun --standalone`` with
    two processes, all started together: ``{name: (rc, stdout, stderr,
    dir)}``."""
    procs = {}
    for name, (args, _) in CLI.items():
        d = str(tmp_path_factory.mktemp(f"cli_{name.replace('-', '_')}"))
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node=2", "-m", "altair_tpu_torch.cli", name,
             "--mesh"] + SCENE_ARGS + [a.format(d=d) for a in args],
            cwd=REPO, env=dict(ENV, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), d)
    done = {}
    try:
        for name, (p, d) in procs.items():
            out, err = p.communicate(timeout=240)
            done[name] = (p.returncode, out, err, d)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_mesh_under_torchrun(name, torchrun):
    rc, out, err, d = torchrun[name]
    assert rc == 0, out[-1000:] + err[-3000:]
    wrote = CLI[name][1]
    if wrote is None:
        csvs = [f for f in os.listdir(d) if f.endswith(".csv")]
        assert len(csvs) == 1, csvs          # rank 0 alone wrote
        assert len(read_fluxmap(os.path.join(d, csvs[0]))[2]) == 18
        assert out.count("total ") == 1      # and rank 0 alone printed
    else:
        assert os.path.getsize(os.path.join(d, wrote)) > 0
    if name == "distribution":
        assert out.count("Flux of rays through the exit port") == 1
        n_exit = int(out.split("exit port:")[1].split()[0])
        assert np.loadtxt(os.path.join(d, "rays.txt")).shape == (n_exit, 3)


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_mesh_outside_torchrun_is_an_error(name, tmp_path, monkeypatch):
    """Exit code 1 with the message that says how to start it, before
    anything is traced or written: in this process, and for ``fluxmap``
    as a command too."""
    from altair_tpu_torch import cli

    how = "torchrun --nproc-per-node=N -m altair_tpu_torch.cli " + name
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main([name, "--mesh"] + SCENE_ARGS)
    assert isinstance(exc.value.code, str) and how in exc.value.code
    if name == "fluxmap":
        p = subprocess.run(
            [sys.executable, "-m", "altair_tpu_torch.cli", name, "--mesh"]
            + SCENE_ARGS, cwd=str(tmp_path), capture_output=True, text=True,
            env={k: v for k, v in ENV.items() if k != "RANK"}, timeout=120)
        assert p.returncode == 1 and how in p.stderr
    assert os.listdir(tmp_path) == []
