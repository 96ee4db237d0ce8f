"""The multi-device layer of the port (``altair_tpu_torch.parallel``) on the
CPU: two gloo ranks, started once through the package's launcher, run every
sharded route at a small size.

* every reduced output equals, exactly, the sum of the single-process
  calls on ``fold_in(key, rank)`` with ``n / world_size`` rays
  (``demo.reference``, the single-device functions, no process group);
* both ranks hold the same reduced outputs (the binomial cells too) and
  their own exit counts differ;
* the argument checks raise ``ValueError`` before any collective (the mesh
  handle of these cases has no process group behind it);
* three routes agree with the JAX ``sharded_*`` functions on the 8-device
  CPU mesh, same scene and total ray count, within ``4*sqrt(max(ref, 1)) +
  10`` per cell (the streams differ, so parity is statistical), at a ray
  count where a cell holds hundreds of hits (tens for the binomial map),
  and each map's total within 4 sigma of the JAX total, which a zero map
  or one scaled by 2 misses by far.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import altair_tpu.parallel as jpar
from altair_tpu import (SCENE_OPTIMIZE as J_SCENE_OPTIMIZE,
                        SOURCE_OVERNIGHT as J_SOURCE, DetectorGrid as JGrid,
                        TraceConfig as JTraceConfig)
from altair_tpu_torch import TraceConfig
from altair_tpu_torch import parallel as tpar
from altair_tpu_torch.parallel import demo
from altair_tpu_torch.sweep import (stack_scenes, stack_sources,
                                    sweep_detector_retrace)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N_RAYS = 65536
REDUCED = [
    "fluxmap_counts", "fluxmap_n_exit", "fluxmap_simulate_counts",
    "fluxmap_simulate_n_exit", "exit_histogram_hist",
    "exit_histogram_n_exit", "trace_score_counts", "trace_score_n_exit",
    "param_sweep_exits", "param_sweep_grid_maps", "param_sweep_grid_exits",
    "param_sweep_sources_exits", "retrace_counts",
    "retrace_binomial_counts_M", "retrace_binomial_cells", "insphere_counts",
    "insphere_retrace_counts", "scatter_retrace_counts", "distribution_ang",
    "distribution_dzh", "twofold_pair_counts",
]
LOCAL = ["trace_score_local_exits", "distribution_local_exits"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' outputs of one launched run, ``[rank0, rank1]``."""
    out = tmp_path_factory.mktemp("mesh_routes")
    p = subprocess.run(
        [sys.executable, "-m", "altair_tpu_torch.parallel.demo", "--launch",
         str(WORLD), "--device", "cpu", "--what", "routes", "--rays",
         str(N_RAYS), "--out", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference():
    return demo.reference(WORLD, N_RAYS, torch.device("cpu"))


def test_every_route_is_checked(ranks, reference):
    assert sorted(reference) == sorted(REDUCED + LOCAL)
    assert sorted(ranks[0]) == sorted(reference)


@pytest.mark.parametrize("name", REDUCED)
def test_reduced_equals_sum_of_single_process_calls(name, ranks, reference):
    got, want = ranks[0][name], reference[name]
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if not name.startswith(("insphere_retrace", "retrace_binomial_cells")):
        assert want.sum() > 0


@pytest.mark.parametrize("name", REDUCED)
def test_ranks_hold_the_same_reduced_output(name, ranks):
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])


@pytest.mark.parametrize("name", LOCAL)
def test_ranks_trace_independent_streams(name, ranks, reference):
    own = np.stack([r[name] for r in ranks])
    np.testing.assert_array_equal(own, reference[name])
    assert own[0] != own[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four ranks that run the routes and the sweeps and then check
    themselves (``--check``): ``(rc, stdout, stderr)``."""
    p = subprocess.run(
        [sys.executable, "-m", "altair_tpu_torch.parallel.demo", "--device",
         "cpu", "--out", str(tmp_path_factory.mktemp("four_ranks")),
         "--launch", "4", "--rays", "1024", "--check"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr


def test_four_ranks_equal_the_single_device_functions(four_ranks):
    """World size 4: rank 0 holds every route's output against the sum of
    four single-process calls and exits 1 on a difference.  The check
    comes after the sweeps, so no rank waits in a collective for it."""
    import json

    rc, out, err = four_ranks
    assert rc == 0, out[-1000:] + err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [ln["world_size"] for ln in lines[:-1]] == [4] * len(demo.SEEDS)
    assert lines[-1]["differ"] == [] and lines[-1]["outputs"] == 23
    assert out.index("Flux map data saved to") < out.index('{"check"')


# ---------------------------------------------------------------------------
# argument checks: ValueError on every rank, before the first collective
# ---------------------------------------------------------------------------

def _handle():
    """A mesh handle with no process group behind it: a route that reached
    a collective with it would raise a RuntimeError, not a ValueError."""
    return tpar.Mesh(rank=1, world_size=WORLD, device=torch.device("cpu"))


def _gen():
    return torch.Generator().manual_seed(0)


ODD = N_RAYS + 1
C, NRM = (t.numpy() for t in demo.disks("cpu"))
BAD_CALLS = {
    "fluxmap_n": lambda m: tpar.sharded_fluxmap(
        m, _gen(), demo.SCENE, demo.SOURCE, demo.GRID, ODD, demo.CFG),
    "exit_histogram_n": lambda m: tpar.sharded_exit_histogram(
        m, _gen(), demo.SCENE, demo.SOURCE, ODD, demo.CFG),
    "trace_n": lambda m: tpar.sharded_trace(
        m, _gen(), demo.SCENE, demo.SOURCE, ODD, demo.CFG),
    "trace_keep_history": lambda m: tpar.sharded_trace(
        m, _gen(), demo.SCENE, demo.SOURCE, N_RAYS,
        TraceConfig(keep_history=4)),
    "param_sweep_n": lambda m: tpar.sharded_param_sweep(
        m, _gen(), stack_scenes(demo.SCENE, theta_max_deg=[164.0, 170.0]),
        demo.SOURCE, ODD, demo.CFG),
    "param_sweep_lengths": lambda m: tpar.sharded_param_sweep(
        m, _gen(), stack_scenes(demo.SCENE, theta_max_deg=[170.0]),
        demo.SOURCE, N_RAYS, demo.CFG,
        sources=stack_sources(demo.SOURCE, x=[-50.0, -40.0])),
    "param_sweep_source_outside": lambda m: tpar.sharded_param_sweep(
        m, _gen(), demo.SCENE, demo.SOURCE, N_RAYS, demo.CFG,
        sources=stack_sources(demo.SOURCE, x=[-60.0, -80.0])),
    "retrace_n": lambda m: tpar.sharded_retrace(
        m, _gen(), demo.SCENE, demo.SOURCE, demo.GRID_SMALL, 33, demo.CFG),
    "binomial_oversample": lambda m: tpar.sharded_retrace_binomial(
        m, _gen(), demo.SCENE, demo.SOURCE, demo.GRID_SMALL, 32, demo.CFG,
        oversample=1),
    "binomial_M": lambda m: tpar.sharded_retrace_binomial(
        m, _gen(), demo.SCENE, demo.SOURCE, demo.GRID_SMALL, 33, demo.CFG,
        oversample=3),
    "insphere_n": lambda m: tpar.sharded_insphere(
        m, _gen(), demo.SCENE_DISK, demo.SOURCE, C, NRM, 5.0, ODD, demo.CFG),
    "scatter_retrace_n": lambda m: tpar.sharded_scatter_retrace(
        m, _gen(), demo.SCENE_BRDF, demo.SOURCE, demo.GRID_BRDF, ODD,
        demo.CFG),
    "distribution_n": lambda m: tpar.sharded_distribution(
        m, _gen(), demo.SCENE, demo.SOURCE, ODD, demo.CFG),
    "twofold_pair_n": lambda m: tpar.sharded_twofold_pair(
        m, _gen(), demo.SCENE, demo.SOURCE, demo.GRID, ODD, demo.CFG, 45.0,
        0.0),
    "sweep_resume_path": lambda m: sweep_detector_retrace(
        demo.SCENE, demo.SOURCE, device="cpu", n_rays_per_pos=32,
        grid=demo.GRID_SMALL, resume_path="partial.csv", mesh=m,
        save_folder=None),
    "sweep_binomial_resume_path": lambda m: sweep_detector_retrace(
        demo.SCENE, demo.SOURCE, device="cpu", n_rays_per_pos=32,
        grid=demo.GRID_SMALL, resume_path="partial.csv", mesh=m,
        engine="binomial", save_folder=None),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_argument_checks_raise_before_any_collective(case):
    with pytest.raises(ValueError):
        BAD_CALLS[case](_handle())


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed.*torchrun"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="init_distributed.*torchrun"):
        tpar.make_mesh("cpu")


def test_no_card_is_an_error_not_a_cpu_run(monkeypatch):
    """The default device is the card: without one neither call goes on
    to the CPU, and no process group is left behind."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.init_distributed(rank=0, world_size=1, store=dist.HashStore())
    assert not dist.is_initialized()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh("cuda:0")


def test_init_distributed_outside_torchrun_says_how_to_start(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        tpar.init_distributed()


def test_counts_are_summed_as_integers():
    with pytest.raises(TypeError):
        _handle().all_reduce_sum(torch.zeros(3, dtype=torch.bool))
    with pytest.raises(TypeError):
        _handle().all_reduce_sum(torch.zeros(3))


def test_device_of_a_sweep_must_be_the_meshs():
    _handle().check_device("cpu")
    with pytest.raises(ValueError):
        _handle().check_device("cuda")


def test_public_names_of_the_jax_layer_have_counterparts():
    """Every public function of ``altair_tpu.parallel`` (``RAY_AXIS`` and
    ``scene_spec`` are ``shard_map`` plumbing without one)."""
    names = [n for n in dir(jpar) if not n.startswith("_")
             and callable(getattr(jpar, n)) and n != "scene_spec"]
    assert len(names) == 14
    for n in names:
        assert callable(getattr(tpar, n)), n


# ---------------------------------------------------------------------------
# against the JAX layer on the 8-device CPU mesh: statistical
# ---------------------------------------------------------------------------

J_SCENE = J_SCENE_OPTIMIZE.with_(max_bounces=demo.MAX_BOUNCES)
J_CFG = JTraceConfig(block_iters=16)


def _within_4_sigma(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) < 4 * np.sqrt(np.maximum(ref, 1)) + 10).all()


# The variance of a flux map's total over its Poisson variance.  The hits
# of one ray come together: a ray that leaves near the axis lands on a whole
# ring of overlapping cells.  Measured at this size over 6 to 8 seeds on
# either package: 6.5 to 14.
OVERLAP = 12.0


def _totals_within_4_sigma(got, ref, inflate=1.0):
    """Two independent totals of hits, the variance of each ``inflate``
    times its Poisson variance."""
    got, ref = float(np.sum(got)), float(np.sum(ref))
    assert ref > 500
    assert abs(got - ref) < 4 * np.sqrt(inflate * (got + ref))


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8
    return jpar.make_mesh()


def test_fluxmap_matches_jax_sharded(ranks, jmesh):
    counts, n_exit = jpar.sharded_fluxmap(
        jmesh, jax.random.key(0), J_SCENE, J_SOURCE,
        JGrid(n_theta=18, n_phi=9), N_RAYS, J_CFG)
    _within_4_sigma(ranks[0]["fluxmap_counts"], counts)
    p = int(n_exit) / N_RAYS
    assert abs(int(ranks[0]["fluxmap_n_exit"]) - int(n_exit)) < 4 * np.sqrt(
        2 * p * (1 - p) * N_RAYS)
    _totals_within_4_sigma(ranks[0]["fluxmap_counts"], counts, OVERLAP)


def test_retrace_binomial_matches_jax_sharded(ranks, jmesh):
    npp = demo.per_pos(N_RAYS)
    cells = jpar.sharded_retrace_binomial(
        jmesh, jax.random.key(1), J_SCENE, J_SOURCE,
        JGrid(n_theta=6, n_phi=3), npp, J_CFG, oversample=demo.OVERSAMPLE)
    got = ranks[0]["retrace_binomial_cells"]
    assert (got >= 0).all() and (got <= npp).all()
    _within_4_sigma(got, cells)
    # the draw's Poisson variance plus the shared sample's, which is a
    # map total's over ``oversample`` times the rays
    inflate = 1 + OVERLAP / demo.OVERSAMPLE
    _totals_within_4_sigma(got, cells, inflate)
    # the shared sample's counts give the same rates as the JAX cells
    _totals_within_4_sigma(
        ranks[0]["retrace_binomial_counts_M"] / demo.OVERSAMPLE, cells,
        inflate)


def test_distribution_matches_jax_sharded(ranks, jmesh):
    ang, dzh, mask, *_ = jpar.sharded_distribution(
        jmesh, jax.random.key(2), J_SCENE, J_SOURCE, N_RAYS, J_CFG)
    _within_4_sigma(ranks[0]["distribution_ang"], ang)
    _within_4_sigma(ranks[0]["distribution_dzh"], dzh)
    _totals_within_4_sigma(ranks[0]["distribution_ang"], ang)
    n_exit = int(np.asarray(mask).sum())
    assert ranks[0]["distribution_dzh"].sum() == \
        ranks[0]["distribution_local_exits"] + ranks[1][
            "distribution_local_exits"]
    p = n_exit / N_RAYS
    assert abs(int(ranks[0]["distribution_dzh"].sum()) - n_exit) < 4 * np.sqrt(
        2 * p * (1 - p) * N_RAYS)
