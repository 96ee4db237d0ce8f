"""Port parity of ``viz``, ``analysis``, ``io.profiling``, ``native`` and the
five later CLI subcommands against ``altair_tpu`` on the CPU.  The numpy
modules are held to the JAX package's outputs on the same inputs
(elementwise, rtol 1e-5; text outputs byte for byte); the CLI subcommands
run in-process with ``--device cpu`` and write their files."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from altair_tpu import analysis as jana
from altair_tpu import native as jnative
from altair_tpu import viz as jviz
from altair_tpu.config import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
from altair_tpu.io import profiling as jprof
from altair_tpu.viz import rays as jrays
import altair_tpu_torch as T
from altair_tpu_torch import analysis as tana
from altair_tpu_torch import cli, convert
from altair_tpu_torch import native as tnative
from altair_tpu_torch import sweep as tsweep
from altair_tpu_torch import viz as tviz
from altair_tpu_torch.io import profiling as tprof
from altair_tpu_torch.io import read_fluxmap
from altair_tpu_torch.viz import rays as trays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_SCENE = convert.scene(SCENE_OPTIMIZE.with_(max_bounces=512))
T_SOURCE = convert.source(SOURCE_OVERNIGHT)


@pytest.fixture(scope="module")
def paths():
    """The port's ray paths of 60 rays, and the same payload as the JAX
    package's ``RayPaths``."""
    tp = tviz.trace_paths(T_SCENE, T_SOURCE, device="cpu", n_rays=60, seed=1,
                          keep_history=48, detector_width=60.0)
    return tp, jrays.RayPaths(**dataclasses.asdict(tp))


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """Three flux-map CSVs written by the port's trace-once sweep (repeats
    of one scene: ``_1``, ``_2`` names), in one folder."""
    root = tmp_path_factory.mktemp("runs")
    tsweep.run_series(T_SCENE, T_SOURCE, device="cpu", port_angles=[170.0],
                      repeats=3, n_rays=4000,
                      grid=T.DetectorGrid(n_theta=9, n_phi=6),
                      save_root=str(root), verbose=False)
    (folder,) = os.listdir(root)
    return str(root / folder)


def test_public_names_match_jax():
    """Every public name of the JAX package's ``sweep``, ``viz``,
    ``analysis``, ``io`` and ``native`` has a counterpart in the port."""
    import altair_tpu.io as jio
    import altair_tpu.sweep as jsweep
    import altair_tpu_torch.io as tio

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    for j, t in ((jsweep, tsweep), (jviz, tviz), (jana, tana), (jio, tio),
                 (jnative, tnative)):
        assert public(j) - public(t) <= {"annotations"}, j.__name__


def test_finite_port_matches_jax():
    th = np.linspace(0.0, 80.0, 9)
    thr = np.deg2rad(th)
    for name, args in (
            ("projection_factor_curve", (th,)),
            ("projection_factor_curve", (th, 1.0, 0.2, 50)),
            ("subtended_flux", (thr, 0.1)),
            ("ideal_cosine_flux", (thr,)),
            ("sphere_multiplier", (0.99, 0.0076)),
            ("port_area_fraction", (np.float64(170.0),)),
            ("expected_exit_fraction", (np.arange(160.0, 179.0), 0.99)),
            ("projection_factor_quad", (0.3, 1.0, 0.1)),
            ("projection_factor_grid", (0.3, 1.0, 0.1, 40))):
        np.testing.assert_allclose(getattr(tana, name)(*args),
                                   getattr(jana, name)(*args), rtol=1e-5)
    # the engine-side scalar twin agrees with the vectorised oracle
    np.testing.assert_allclose(
        T.config.expected_exit_fraction(170.0, 0.99),
        tana.expected_exit_fraction(170.0, 0.99), rtol=1e-12)


def test_flux_analysis_matches_jax_on_a_sweep_file(run_folder):
    """``load``, ``theta_profile``, ``fit_cosine``, ``average_runs`` and
    ``pivot`` on CSVs the port's sweep wrote: equal to the JAX package's
    on the same files."""
    files = tana.collect_files(run_folder)
    assert files == jana.collect_files(run_folder) and len(files) == 3
    td, jd = tana.load(files[0]), jana.load(files[0])
    assert td.filename == jd.filename and td.metadata == jd.metadata
    for a, b in zip((td.theta, td.phi, td.fraction),
                    (jd.theta, jd.phi, jd.fraction)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.fraction, read_fluxmap(files[0])[2])
    for a, b in zip(td.pivot(), jd.pivot()):
        np.testing.assert_array_equal(a, b)
    tp, jp = tana.theta_profile(td), jana.theta_profile(jd)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    tf, jf = tana.fit_cosine(*tp[:2], "x", tp[2]), jana.fit_cosine(
        *jp[:2], "x", jp[2])
    np.testing.assert_allclose(tf.popt, jf.popt, rtol=1e-5)
    np.testing.assert_allclose(tf.r_squared, jf.r_squared, rtol=1e-5)
    ta = tana.average_runs([tana.load(f) for f in files])
    ja = jana.average_runs([jana.load(f) for f in files])
    assert ta.filename == ja.filename == "AVERAGE"
    for a, b in zip((ta.theta, ta.phi, ta.fraction, ta.stderr),
                    (ja.theta, ja.phi, ja.fraction, ja.stderr)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(tana.cosine_func(tp[0], 1.0, 2.0, 0.5),
                               jana.cosine_func(tp[0], 1.0, 2.0, 0.5))
    assert tana.load(os.path.join(run_folder, "missing.csv")) is None


def test_ray_analysis_matches_jax(tmp_path):
    d = tsweep.run_distribution(T_SCENE, T_SOURCE, device="cpu", n_rays=3000)
    tsweep.write_ray_log(str(tmp_path / "3dRayLog.txt"), d.directions)
    tl = tana.load_ray_log(str(tmp_path / "3dRayLog.txt"))
    jl = jana.load_ray_log(str(tmp_path / "3dRayLog.txt"))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tana.z_angle_distribution(tl),
                                  jana.z_angle_distribution(jl))
    assert len(tl) == d.n_exited


def test_ascii_views_match_jax(paths, run_folder):
    tp, jp = paths
    fm = read_fluxmap(tana.collect_files(run_folder)[0])[2].reshape(9, 6)
    for kw in ({}, dict(width=30, height=9)):
        assert tviz.ascii_fluxmap(fm, **kw) == jviz.ascii_fluxmap(fm, **kw)
    assert tviz.ascii_fluxmap(fm * 0) == jviz.ascii_fluxmap(fm * 0)
    for classes in (None, tp.classes):
        assert (tviz.ascii_ray_projection(tp.points, tp.lengths, classes)
                == jviz.ascii_ray_projection(jp.points, jp.lengths, classes))
    assert "*" in tviz.ascii_ray_projection(tp.points, tp.lengths, tp.classes)


def test_html_and_curves_match_jax(paths, tmp_path):
    """The HTML viewer written by both packages from the same payload is
    byte-equal; the detector and port curves are equal."""
    tp, jp = paths
    for only_red in (False, True):
        t_out = tviz.export_html(tp, T_SCENE, str(tmp_path / "t.html"),
                                 only_show_red=only_red)
        jviz.export_html(jp, SCENE_OPTIMIZE, str(tmp_path / "j.html"),
                         only_show_red=only_red)
        assert t_out == str(tmp_path / "t.html")
        html = (tmp_path / "t.html").read_text()
        assert html == (tmp_path / "j.html").read_text()
        assert "<canvas" in html and len(html) > 5000
    for a, b in zip(trays._detector_curves(tp.detector),
                    jrays._detector_curves(jp.detector)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trays._port_circle(T_SCENE),
                                  jrays._port_circle(SCENE_OPTIMIZE))


def test_print_census_and_plot_rays(paths, tmp_path, capsys):
    tp, jp = paths
    tviz.print_census(tp, 60)
    t_out = capsys.readouterr().out
    jviz.print_census(jp, 60)
    assert t_out == capsys.readouterr().out and "Never exits" in t_out
    pytest.importorskip("matplotlib")
    tviz.plot_rays(tp, T_SCENE, save_path=str(tmp_path / "rays.png"),
                   only_show_red=True)
    assert (tmp_path / "rays.png").stat().st_size > 10_000
    d = tsweep.run_distribution(T_SCENE, T_SOURCE, device="cpu", n_rays=3000)
    tviz.plot_distribution_canvas(d, save_path=str(tmp_path / "dist.png"))
    assert (tmp_path / "dist.png").stat().st_size > 10_000


def test_phase_timer_and_device_trace(tmp_path):
    """``PhaseTimer`` reports like the JAX package's; ``device_trace``
    writes a chrome trace of the block with the annotated phase in it."""
    tt, jt = tprof.PhaseTimer(), jprof.PhaseTimer()
    for timer in (tt, jt):
        with timer.phase("trace"):
            pass
        timer.phases["trace"] = 1.25
        timer.phases["score"] = 0.5
    assert tt.report() == jt.report()
    with tprof.device_trace(str(tmp_path / "prof")) as log_dir:
        with tprof.annotate("altair_phase"):
            torch.ones(8).sum()
    assert log_dir == str(tmp_path / "prof")
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "altair_phase" in trace and "traceEvents" in trace
    assert tprof.device_trace.last.key_averages()
    # no card here: the profiler saw no device activity
    assert tprof.device_busy_s(tprof.device_trace.last) is None


def test_native_binding_matches_jax():
    """The same library through both bindings: ``available()`` agrees, and
    where it is built the same seed gives the same rays and map."""
    assert tnative.available() == jnative.available()
    if not tnative.available():
        with pytest.raises(RuntimeError, match="not built"):
            tnative.trace_rays_native(T_SCENE, T_SOURCE, 8)
        return
    assert tnative.num_threads() == jnative.num_threads()
    tr = tnative.trace_rays_native(T_SCENE, T_SOURCE, 2000, seed=3)
    jr = jnative.trace_rays_native(SCENE_OPTIMIZE.with_(max_bounces=512),
                                   SOURCE_OVERNIGHT, 2000, seed=3)
    assert tr.n_exited == jr.n_exited
    np.testing.assert_array_equal(tr.last_point, jr.last_point)
    grid = T.DetectorGrid(n_theta=6, n_phi=4)
    np.testing.assert_array_equal(
        tnative.fluxmap_trace_once_native(tr, grid),
        jnative.fluxmap_trace_once_native(jr, grid))
    td = tnative.trace_rays_native_direct(T_SCENE.with_(exact_rim=False),
                                          T_SOURCE, 500, seed=1)
    assert td.status.shape == (500,)
    with pytest.raises(NotImplementedError):
        tnative.trace_rays_native(
            T_SCENE.with_(surface_model=T.SurfaceModel.SPECULAR), T_SOURCE, 8)


SMALL = ["--device", "cpu", "--max-bounces", "512"]
CLI_CASES = {
    "series": (["series", "--rays", "1500", "--port-angles", "164", "170",
                "--repeats", "2", "--out", "{d}"],
               "portAngleSweep_-60_0_-75_170/"
               "fluxmap_traceonce_1500rays_180x90_src-60_0_-75_1.csv"),
    "series-vmapped": (["series", "--vmapped", "--rays", "1500",
                        "--port-angles", "164", "170", "--out", "{d}"],
                       "series_fluxmaps.npy"),
    "series-sources": (["series", "--vmapped", "--rays", "1500",
                        "--port-angles", "164", "170", "--source-xs", "-60",
                        "-40", "10", "--out", "{d}"], "series_fluxmaps.npy"),
    "insphere": (["insphere", "--rays", "1500", "--dtheta", "15",
                  "--out-file", "{d}/sweep.txt"], "sweep.txt"),
    "insphere-retrace": (["insphere", "--rays", "500", "--dtheta", "22.5",
                          "--retrace", "--disk-radius", "20", "--out-file",
                          "{d}/sweep.txt"], "sweep.txt"),
    "visualize-html": (["visualize", "--rays", "40", "--out-file",
                        "{d}/rays.html"], "rays.html"),
    "visualize-png": (["visualize", "--rays", "40", "--only-red",
                       "--out-file", "{d}/rays.png"], "rays.png"),
    "scatter-retrace": (["scatter-retrace", "--rays", "2000", "--out-file",
                         "{d}/fluxmap_data.csv"], "fluxmap_data.csv"),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_subcommand_writes_its_file(case, tmp_path, capsys):
    """Each later subcommand with ``--device cpu`` exits 0 and writes its
    file, in the shape the JAX CLI gives it."""
    if case == "visualize-png":
        pytest.importorskip("matplotlib")
    args, fname = CLI_CASES[case]
    args = [a.format(d=tmp_path) for a in args]
    assert cli.main(args + SMALL) == 0
    out = capsys.readouterr().out
    path = tmp_path / fname
    assert path.stat().st_size > 0
    if case == "series-vmapped":
        assert np.load(path).shape == (2, 180, 90)
        assert "port 164.0: exit fraction 0." in out
    elif case == "series-sources":
        assert np.load(path).shape == (2, 3, 180, 90)
        assert "port 170.0 srcX -40.0: exit fraction 0." in out
    elif case == "series":
        assert "ALL SWEEP SERIES COMPLETE" in out
        assert read_fluxmap(str(path))[2].shape == (180 * 90,)
    elif case.startswith("insphere"):
        th, ph, fr = tsweep.read_detector_sweep(str(path))
        n = 7 if case == "insphere" else 5
        assert th.shape == (2 * n,) and set(ph) == {0.0, 180.0}
        assert f"{2 * n} positions in" in out
    elif case == "scatter-retrace":
        rows = np.loadtxt(path, delimiter=",", skiprows=1)
        assert rows.shape == (900, 3) and rows[:, 2].sum() > 0
        assert path.read_text().startswith("theta,phi,fraction\n1.000000,")
    else:
        assert "Ray classification:" in out and f"saved {path}" in out


def test_cli_analyze_writes_the_plots(run_folder, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["analyze", run_folder, "--average"]) == 0
    base = os.path.basename(run_folder) + "_averaged"
    assert (tmp_path / f"{base}_theta_comparison.png").exists()
    assert (tmp_path / f"{base}_heatmap_comparison.png").exists()


def test_cli_lists_seven_subcommands_and_needs_a_card(monkeypatch, capsys):
    """``--help`` lists all seven subcommands; every tracing subcommand
    defaults to ``--device cuda`` and without a card that is an error, not
    a fall-back to the CPU."""
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for name in ("fluxmap", "series", "distribution", "insphere", "visualize",
                 "scatter-retrace", "analyze"):
        assert name in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["series", "--rays", "10"], ["series", "--vmapped"],
                 ["insphere", "--rays", "10"], ["visualize"],
                 ["scatter-retrace", "--rays", "10"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args)


def test_html_view_needs_no_matplotlib(tmp_path):
    """``visualize`` with a ``.html`` output, ``import altair_tpu_torch.viz``
    and the ASCII views run where matplotlib cannot be imported (and
    without JAX)."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "from altair_tpu_torch import cli, viz\n"
        f"rc = cli.main(['visualize', '--device', 'cpu', '--rays', '20', "
        f"'--max-bounces', '256', '--out-file', r'{tmp_path}/v.html'])\n"
        "import numpy as np\n"
        "assert viz.ascii_fluxmap(np.eye(4))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'altair_tpu' or m.startswith('altair_tpu.')]\n"
        "sys.exit(rc or len(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "v.html").stat().st_size > 5000
