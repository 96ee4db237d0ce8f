"""The in-sphere disk sweep cell (``insphere105.disk_retrace``) on the CPU at
a tiny size: the sound program reads ``correct`` true; the aim-at-port
disk normal, one chunk's counts zeroed, half the rays absorbed and the
control (the reference tracer in bfloat16) each read false; and the
reference's disk test equals the port's ray for ray.  The harness's look
for a card is skipped: ``run_cell`` runs on the CPU."""

import numpy as np
import pytest
import torch

from altair_tpu_torch.core import ABSORBED, EXITED
from altair_tpu_torch.core.geometry import Vec3
from altair_tpu_torch.core.score import (insphere_disk_hit_mask,
                                         insphere_disk_position)
from altair_tpu_torch.core.trace import TraceResult
from altair_tpu_torch.sweep import insphere as sweep_insphere
from portbench import harness, reference
from portbench import reference_insphere as RI
from portbench.jobs import insphere_retrace

from .conftest import ROOT

CPU = torch.device("cpu")
SEED = 2 ** 33 + 29
CELL = "insphere105.disk_retrace"


@pytest.fixture
def tiny():
    """The cell cut to a size the CPU runs in seconds: 26 disks of 40 cm
    (theta steps of 7.5 degrees), 2,000 rays a disk, a 100-step bounce
    limit (about half the rays reach it, in the program and in the
    reference alike), 60,000 reference rays.  The limits are the cell's
    own."""
    cell = harness.load_cell(ROOT, CELL)
    cfg = cell["config_data"]
    cfg["scene"]["max_bounces"] = 100
    cfg["disks"].update(radius=40.0, dtheta=7.5)
    cell["traffic_data"].update(rays_per_position=2000, positions=26)
    cell["ref_rays"] = 60000
    cell["sample_jobs"] = 8
    return cell


def run(cell, side="Program", seconds=2.0):
    return harness.run_cell(cell, SEED, seconds, False, CPU, side=side,
                            log=lambda *a, **k: None)


def test_sound_program_is_correct(tiny):
    """A window of several sweeps: ``cell_z2_dev`` over one sweep's 26
    disks spreads too widely to hold to the cell's limit."""
    r = run(tiny, seconds=24.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0


def test_aimed_normal_is_not_correct(tiny, monkeypatch):
    """The aim-at-port normal of the macro's comment in place of the
    tilted one its rotation gives (wider wings)."""
    original = insphere_retrace.Program.__init__

    def aimed(self, cell, device):
        original(self, cell, device)
        self.disks["aimed"] = True

    monkeypatch.setattr(insphere_retrace.Program, "__init__", aimed)
    assert not run(tiny)["correct"]


def test_one_chunk_zeroed_is_not_correct(tiny, monkeypatch):
    """The counts of one chunk of 8 disks lost."""
    original = insphere_retrace.Program.run

    def broken(self, gen, i, spans):
        out = original(self, gen, i, spans)
        out.payload = out.payload.clone()
        out.payload[8:16] = 0
        return out

    monkeypatch.setattr(insphere_retrace.Program, "run", broken)
    assert not run(tiny)["correct"]


def test_half_the_rays_absorbed_is_not_correct(tiny, monkeypatch):
    """Every other ray of each traced chunk absorbed where it is traced."""
    original = sweep_insphere.trace_rays_auto

    def broken(*a, **k):
        res, rim = original(*a, **k)
        status = res.status.clone()
        status[::2] = ABSORBED
        return res._replace(status=status), rim

    monkeypatch.setattr(sweep_insphere, "trace_rays_auto", broken)
    assert not run(tiny)["correct"]


def test_control_is_not_correct(tiny):
    r = run(tiny, side="Control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("radius", [5.0, 30.0])
def test_reference_disk_test_is_the_ports(radius):
    """On the same float64 exit segments (a reference trace of the thick
    shell) and the same disks, the reference's disk test and the port's
    ``insphere_disk_hit_mask`` agree on every ray and disk; the two
    placements agree to 1e-9 cm."""
    cell = harness.load_cell(ROOT, CELL)
    cfg = cell["config_data"]
    scene = dict(cfg["scene"], max_bounces=200)
    ex = reference.trace(scene, cfg["source_point"], 20000,
                         torch.Generator().manual_seed(3))
    k = ex.seg_start.shape[0]
    disks = dict(cfg["disks"], radius=radius)
    c, n = RI.disk_positions(disks, -100.0)
    th, ph = RI.disk_angles(disks)
    pc, pn = insphere_disk_position(torch.from_numpy(th), torch.from_numpy(ph),
                                    200.0, -100.0)
    np.testing.assert_allclose(pc.stack().numpy(), c.numpy(), atol=1e-9)
    np.testing.assert_allclose(pn.stack().numpy(), n.numpy(), atol=1e-9)

    def vec(t):
        return Vec3(t[:, 0], t[:, 1], t[:, 2])

    res = TraceResult(torch.full((k,), EXITED, dtype=torch.int32),
                      vec(ex.last_point), vec(ex.seg_start),
                      vec(ex.direction), ex.n_bounces)
    hits = 0
    for i in range(c.shape[0]):
        cen = Vec3(*c[i].unbind(0))
        nrm = Vec3(*n[i].unbind(0))
        port = insphere_disk_hit_mask(res, cen, nrm, radius)
        ref = RI.hit(ex.seg_start, ex.direction, c[i], n[i], radius)
        assert torch.equal(port, ref), i
        hits += int(ref.sum())
    assert hits > (200 if radius == 5.0 else 20000)
    counts, per_ray = RI.score(ex.seg_start, ex.direction, c, n, radius,
                               pair_block=1 << 16)
    assert int(counts.sum()) == int(per_ray.sum()) == hits
