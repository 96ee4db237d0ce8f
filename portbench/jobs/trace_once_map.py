"""A trace-once flux map: ``trace_rays_auto``, then
``core.score.fluxmap_trace_once_compact`` over the whole grid, the pair
``sweep_detector_trace_once`` calls, without its CSV.  The job ends in
the readback of the map, the exit count and both overflow counts."""

from __future__ import annotations

import torch

from .. import reference
from . import Out, device_generator, judge_trace, program_exits


class Program:
    def __init__(self, cell: dict, device):
        from altair_tpu_torch import trace_rays_auto
        from altair_tpu_torch.core.score import (exit_capacity,
                                                 fluxmap_trace_once_compact)

        from . import program_objects

        self.scene, self.source, self.grid, self.cfg = program_objects(cell)
        self.rays = int(cell["traffic_data"]["rays"])
        self.cap = exit_capacity(self.scene, self.rays)
        self.device = device
        self.port_z = float(self.scene.exit_port_z)
        self._trace = trace_rays_auto
        self._score = fluxmap_trace_once_compact

    def trace(self, gen):
        return self._trace(gen, self.scene, self.source, self.rays, self.cfg,
                           device=self.device)

    def score(self, res):
        return self._score(res, self.grid, self.cap, self.port_z)

    def run(self, gen, i, spans) -> Out:
        res, rim = spans.timed("trace", i, self.trace, gen)
        if spans.active:
            spans.items[-1][4]["bounce_steps"] = int(
                res.n_bounces.to(torch.int64).sum())
        counts, overflow = spans.timed("score", i, self.score, res)
        n_exit = res.exited_port_mask(self.port_z).sum()
        counts_host = counts.cpu()
        n_exit, overflow, rim = int(n_exit), int(overflow), int(rim.total)
        if spans.active:
            spans.items[-1][4]["pairs"] = n_exit * self.grid.n_positions
        ok = overflow == 0 and rim == 0
        return Out(ok, self.rays, n_exit, (res, counts_host),
                   None if ok else f"overflow {overflow}, rim {rim}")

    def neutral(self, payload) -> dict:
        res, counts = payload
        x = program_exits(res, self.port_z)
        x["counts"] = counts
        return x


class Control:
    """The reference in the program's place: its tracer in bfloat16 and
    its scorer in float32 with TF32 inputs."""

    def __init__(self, cell: dict, device):
        self.cell = cell
        self.cfg = cell["config_data"]
        self.rays = int(cell["traffic_data"]["rays"])
        self.port_z = float(self.cfg["scene"]["exit_port_z"])
        self.device = device

    def run(self, gen, i, spans) -> Out:
        ex = reference.trace(self.cfg["scene"], self.cfg["source_point"],
                             self.rays, device_generator(gen, self.device),
                             torch.bfloat16, self.device)
        from . import reference_exits

        x = reference_exits(ex, self.port_z)
        x["counts"], _ = reference.score(
            x["seg"].float(), x["dir"].float(), self.cfg["grid"],
            self.port_z, dtype=torch.float32, tf32=True)
        return Out(True, self.rays, x["seg"].shape[0], x)

    def neutral(self, payload) -> dict:
        return payload


def judge(cell, outs, sampled, gen, device):
    return judge_trace(cell, outs, sampled, gen, device, with_map=True)
