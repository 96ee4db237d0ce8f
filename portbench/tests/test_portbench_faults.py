"""A run with the timed path broken underneath reads ``correct`` false;
the control (the reference in bfloat16 and TF32 in the program's place)
does too; the sound program at the same tiny size reads true.  The
harness's look for a card is skipped: ``run_cell`` runs on the CPU."""

import pytest
import torch

from altair_tpu_torch.core import ABSORBED, EXITED, SUSPENDED
from altair_tpu_torch.core.geometry import Vec3
from portbench import harness
from portbench.jobs import binomial_map, trace, trace_once_map

CPU = torch.device("cpu")
SEED = 2 ** 33 + 17
MAP_CELLS = ["mixedbrdf170.map100k"]


def run(cell, side="Program", seconds=2.0):
    return harness.run_cell(cell, SEED, seconds, False, CPU, side=side,
                            log=lambda *a, **k: None)


def unchanged(res):
    """The trace hands back its start: every ray at the source, none
    moved (the state a step that returns its input leaves)."""
    src = Vec3(*(res.seg_start.x * 0 + v for v in (-60.0, 0.0, -75.0)))
    return res._replace(status=torch.full_like(res.status, SUSPENDED),
                        last_point=src, seg_start=src,
                        n_bounces=torch.zeros_like(res.n_bounces))


def half_left_out(res):
    half = res.status.shape[0] // 2
    status = res.status.clone()
    status[half:] = ABSORBED
    return res._replace(status=status)


def one_exit_altered(res):
    """One exit's last point moved 1 cm along x where it is produced."""
    i = int(torch.nonzero(res.status == EXITED)[0])
    x = res.last_point.x.clone()
    x[i] += 1.0
    return res._replace(last_point=Vec3(x, res.last_point.y,
                                        res.last_point.z))


def patch_trace(monkeypatch, module, fault):
    original = module.Program.trace

    def broken(self, gen):
        res, rim = original(self, gen)
        return fault(res), rim

    monkeypatch.setattr(module.Program, "trace", broken)


@pytest.mark.parametrize("name", MAP_CELLS + ["mixedbrdf170.trace4M"])
def test_sound_program_is_correct(tiny_cell, name):
    r = run(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   one_exit_altered])
@pytest.mark.parametrize("name", MAP_CELLS + ["mixedbrdf170.trace4M"])
def test_broken_trace_is_not_correct(tiny_cell, monkeypatch, name, fault):
    module = trace if name.endswith("trace4M") else trace_once_map
    patch_trace(monkeypatch, module, fault)
    assert not run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("fault", ["half_the_exits", "one_cell_altered"])
def test_broken_scorer_is_not_correct(tiny_cell, monkeypatch, fault):
    original = trace_once_map.Program.score

    def broken(self, res):
        if fault == "half_the_exits":
            res = half_left_out(res)
        counts, overflow = original(self, res)
        if fault == "one_cell_altered":
            counts = counts.clone()
            counts.view(-1)[int(counts.argmax())] *= 2
        return counts, overflow

    monkeypatch.setattr(trace_once_map.Program, "score", broken)
    assert not run(tiny_cell("mixedbrdf170.map100k"))["correct"]


@pytest.mark.parametrize("name", MAP_CELLS + ["mixedbrdf170.trace4M",
                                              "optimize170.binomial"])
def test_control_is_not_correct(tiny_cell, name):
    r = run(tiny_cell(name), side="Control")
    assert not r["correct"], r["checks"]


def binomial_fault(fault):
    def broken(self, gen, i, spans):
        out = original_run(self, gen, i, spans)
        cells = out.payload.clone()
        if fault == "unchanged":
            cells.zero_()
        elif fault == "half_left_out":
            cells = torch.binomial(cells.double(),
                                   torch.full_like(cells.double(), 0.5),
                                   generator=torch.Generator().manual_seed(i)
                                   ).to(cells.dtype)
        elif fault == "one_cell_altered":
            cells.view(-1)[int(cells.argmax())] *= 2
        elif fault == "draw_left_out":
            cells = self.expected.to(cells.dtype)
        out.payload = cells
        return out
    return broken


original_run = binomial_map.Program.run


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "one_cell_altered", "draw_left_out"])
def test_broken_binomial_map_is_not_correct(tiny_cell, monkeypatch, fault):
    cell = tiny_cell("optimize170.binomial")
    if fault == "draw_left_out":
        # the mean of the draw in the draw's place: n x the reference's p
        from portbench import judge, reference

        cfg = cell["config_data"]
        ex = reference.trace(cfg["scene"], cfg["source_point"], 400_000,
                             torch.Generator().manual_seed(4))
        seg, _, d, _ = judge.exits_from_reference(ex, -100.0)
        counts, _ = reference.score(seg, d, cfg["grid"], -100.0)
        expected = torch.round(counts.double() / 400_000
                               * cell["traffic_data"]["rays_per_position"])
        monkeypatch.setattr(binomial_map.Program, "expected", expected,
                            raising=False)
    monkeypatch.setattr(binomial_map.Program, "run", binomial_fault(fault))
    assert not run(cell)["correct"]
