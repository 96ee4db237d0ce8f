"""A binomial retrace map: ``core.score.fluxmap_retrace_binomial`` (one
shared Sobol trace of ``oversample x n_per_pos`` rays with its rim
post-pass, the scorer over the whole grid, one binomial draw per cell).
The job ends in the readback of the map.  Only the traced run passes
``stats=``, whose laps (each ended by a device sync) are its spans."""

from __future__ import annotations

import torch

from .. import judge as J
from .. import reference
from . import Out, device_generator


class Program:
    def __init__(self, cell: dict, device):
        from altair_tpu_torch.core.score import fluxmap_retrace_binomial

        from . import program_objects

        t = cell["traffic_data"]
        self.scene, self.source, self.grid, self.cfg = program_objects(cell)
        self.n_per_pos = int(t["rays_per_position"])
        self.oversample = int(t["oversample"])
        self.rays = self.n_per_pos * self.oversample
        self.device = device
        self._map = fluxmap_retrace_binomial

    def run(self, gen, i, spans) -> Out:
        import time

        stats = {} if spans.active else None
        t0 = time.perf_counter()
        cells = self._map(gen, self.scene, self.source, self.grid,
                          self.n_per_pos, self.cfg, oversample=self.oversample,
                          device=self.device, stats=stats).cpu()
        if stats is not None:
            t_tr = t0 + stats["trace_s"]
            t_sc = t_tr + stats["score_s"]
            spans.add("trace", i, t0, t_tr)
            spans.add("score", i, t_tr, t_sc, rays=self.rays,
                      positions=self.grid.n_positions)
            spans.add("draw", i, t_sc, t_sc + stats["draw_s"])
            if stats["compaction_overflow"]:
                return Out(False, self.rays, 0, cells,
                           f"compaction overflow {stats['compaction_overflow']}")
        return Out(True, self.rays, 0, cells)

    def neutral(self, payload):
        return {"cells": payload}


class Control:
    """The reference in the program's place: the shared trace in bfloat16,
    its scorer in float32 with TF32 inputs, then the same binomial draw
    per cell."""

    def __init__(self, cell: dict, device):
        t = cell["traffic_data"]
        self.cfg = cell["config_data"]
        self.n_per_pos = int(t["rays_per_position"])
        self.rays = self.n_per_pos * int(t["oversample"])
        self.port_z = float(self.cfg["scene"]["exit_port_z"])
        self.device = device

    def run(self, gen, i, spans) -> Out:
        from . import reference_exits

        dgen = device_generator(gen, self.device)
        ex = reference.trace(self.cfg["scene"], self.cfg["source_point"],
                             self.rays, dgen, torch.bfloat16, self.device)
        x = reference_exits(ex, self.port_z)
        counts, _ = reference.score(x["seg"].float(), x["dir"].float(),
                                    self.cfg["grid"], self.port_z,
                                    dtype=torch.float32, tf32=True)
        p = (counts.to(torch.float32) / self.rays).clamp(0.0, 1.0)
        cells = torch.binomial(torch.full_like(p, float(self.n_per_pos)), p,
                               generator=dgen)
        return Out(True, self.rays, 0, cells.to(torch.int32).cpu())

    def neutral(self, payload):
        return {"cells": payload}


def judge(cell, outs, sampled, gen, device):
    """The sampled jobs' maps against the reference's per-cell probability
    from ``ref_rays`` rays (``judge.binomial_numbers``), and
    ``failed_jobs``."""
    cfg = cell["config_data"]
    t = cell["traffic_data"]
    port_z = float(cfg["scene"]["exit_port_z"])
    n_ref = int(cell["ref_rays"])
    ex = reference.trace(cfg["scene"], cfg["source_point"], n_ref, gen,
                         torch.float64, device)
    seg, _, d, _ = J.exits_from_reference(ex, port_z)
    counts, per_ray = reference.score(seg, d, cfg["grid"], port_z,
                                      pair_block=1 << 26)
    pi_ref = counts.to(torch.float64) / n_ref
    h = per_ray.to(torch.float64)
    hits_var = float((h * h).sum()) / n_ref - (float(h.sum()) / n_ref) ** 2
    m_shared = int(t["rays_per_position"]) * int(t["oversample"])
    good = [o for o in outs if o.ok]
    numbers = {"failed_jobs": float(len(outs) - len(good)),
               "total_z": None, "cell_z2_dev": None,
               "cell_max_surprise": None}
    if sampled:
        (numbers["total_z"], numbers["cell_z2_dev"],
         numbers["cell_max_surprise"]) = (
            J.binomial_numbers([x["cells"] for x in sampled], pi_ref,
                               int(t["rays_per_position"]), m_shared, n_ref,
                               hits_var))
    facts = {"exit_fraction_ref": seg.shape[0] / n_ref}
    return numbers, facts
