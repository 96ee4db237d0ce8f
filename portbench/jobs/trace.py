"""A large-batch trace: ``trace_rays_auto`` alone, with no scoring.  The job
ends in the readback of its port-exit count and its overflow count."""

from __future__ import annotations

import torch

from .. import reference
from . import Out, device_generator, judge_trace, program_exits


class Program:
    def __init__(self, cell: dict, device):
        from altair_tpu_torch import trace_rays_auto

        from . import program_objects

        self.scene, self.source, _, self.cfg = program_objects(cell)
        self.rays = int(cell["traffic_data"]["rays"])
        self.device = device
        self.port_z = float(self.scene.exit_port_z)
        self._trace = trace_rays_auto

    def trace(self, gen):
        return self._trace(gen, self.scene, self.source, self.rays, self.cfg,
                           device=self.device)

    def run(self, gen, i, spans) -> Out:
        res, rim = spans.timed("trace", i, self.trace, gen)
        if spans.active:
            spans.items[-1][4]["bounce_steps"] = int(
                res.n_bounces.to(torch.int64).sum())
        n_exit, rim = int(res.exited_port_mask(self.port_z).sum()), int(
            rim.total)
        return Out(rim == 0, self.rays, n_exit, res,
                   None if rim == 0 else f"rim {rim}")

    def neutral(self, payload) -> dict:
        return program_exits(payload, self.port_z)


class Control:
    """The reference tracer in bfloat16 in the program's place."""

    def __init__(self, cell: dict, device):
        self.cfg = cell["config_data"]
        self.rays = int(cell["traffic_data"]["rays"])
        self.port_z = float(self.cfg["scene"]["exit_port_z"])
        self.device = device

    def run(self, gen, i, spans) -> Out:
        from . import reference_exits

        ex = reference.trace(self.cfg["scene"], self.cfg["source_point"],
                             self.rays, device_generator(gen, self.device),
                             torch.bfloat16, self.device)
        x = reference_exits(ex, self.port_z)
        return Out(True, self.rays, x["seg"].shape[0], x)

    def neutral(self, payload) -> dict:
        return payload


def judge(cell, outs, sampled, gen, device):
    return judge_trace(cell, outs, sampled, gen, device, with_map=False)
