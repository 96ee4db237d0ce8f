"""An in-sphere detector-disk sweep with fresh rays for every disk:
``sweep.sweep_insphere_detector(retrace=True)`` (``integratingSphere
DetectorSweep.C``'s method), chunks of the sweep's own size, each traced
by ``trace_rays_auto`` and scored against its disks.  The job ends in the
readback of the disks' counts.  Only the traced run passes a ``stats``
dict, whose laps (each ended by a device sync) are its spans; the other
runs pass ``stats=None``."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import judge as J
from .. import reference_insphere as RI
from . import Out, device_generator


def _scene(cfg: dict):
    from altair_tpu_torch import SphereScene, Source, SurfaceModel

    scene_kw = dict(cfg["scene"])
    law = SurfaceModel[scene_kw.pop("surface_model")]
    return SphereScene(surface_model=law, **scene_kw), Source(
        **cfg["source_point"])


def _positions(cell: dict) -> int:
    n = len(RI.disk_angles(cell["config_data"]["disks"])[0])
    if n != int(cell["traffic_data"]["positions"]):
        raise ValueError(f"the disks give {n} positions, the traffic "
                         f"{cell['traffic_data']['positions']}")
    return n


class Program:
    def __init__(self, cell: dict, device):
        from altair_tpu_torch import TraceConfig
        from altair_tpu_torch.sweep import sweep_insphere_detector

        cfg = cell["config_data"]
        if cfg["dtype"] != "float32":
            raise ValueError("the cells run the port's float32 path")
        self.scene, self.source = _scene(cfg)
        self.cfg = TraceConfig(dtype=torch.float32)
        self.disks = dict(cfg["disks"])
        self.n_per_pos = int(cell["traffic_data"]["rays_per_position"])
        self.rays = self.n_per_pos * _positions(cell)
        self.device = device
        self._sweep = sweep_insphere_detector

    def run(self, gen, i, spans) -> Out:
        d = self.disks
        stats = {} if spans.active else None
        seed = int(torch.randint(0, 1 << 62, (1,), generator=gen))
        r = self._sweep(self.scene, self.source, device=self.device,
                        disk_radius=d["radius"], n_rays=self.n_per_pos,
                        dtheta=d["dtheta"], theta_max=d["theta_max"],
                        dphi=d["dphi"],
                        placement_radius=d["placement_radius"], seed=seed,
                        cfg=self.cfg, retrace=True, save_path=None,
                        aimed=bool(d["aimed"]), stats=stats)
        counts = torch.from_numpy(
            np.rint(r.fractions * self.n_per_pos).astype(np.int64))
        if stats is not None:
            for lap in stats["trace"]:
                spans.add("trace", i, lap["start"], lap["end"],
                          rays=lap["rays"], bounce_steps=lap["bounce_steps"])
            for lap in stats["score"]:
                spans.add("score", i, lap["start"], lap["end"],
                          disks=lap["disks"], rays=lap["rays"])
        return Out(True, self.rays, int(counts.sum()), counts)

    def neutral(self, payload):
        return {"counts": payload}


class Control:
    """The reference in the program's place: the macro's sweep traced by
    the reference tracer in bfloat16, each disk's hits from its own fresh
    rays by the reference's disk test."""

    def __init__(self, cell: dict, device):
        self.cfg = cell["config_data"]
        self.n_per_pos = int(cell["traffic_data"]["rays_per_position"])
        self.rays = self.n_per_pos * _positions(cell)
        self.device = device

    def run(self, gen, i, spans) -> Out:
        counts = RI.sweep(self.cfg["scene"], self.cfg["source_point"],
                          self.cfg["disks"], self.n_per_pos,
                          device_generator(gen, self.device), torch.bfloat16,
                          self.device).cpu()
        return Out(True, self.rays, int(counts.sum()), counts)

    def neutral(self, payload):
        return {"counts": payload}


def judge(cell, outs, sampled, gen, device):
    """The sampled jobs' disk counts against the reference's per-disk hit
    probability from ``ref_rays`` rays (``judge.binomial_numbers``: each
    count Binomial(rays per position, p), the positions independent, so no
    shared-trace term), and ``failed_jobs``."""
    cfg = cell["config_data"]
    n_ref = int(cell["ref_rays"])
    p, hits_var, exit_fraction = RI.probabilities(
        cfg["scene"], cfg["source_point"], cfg["disks"], n_ref, gen, device)
    good = [o for o in outs if o.ok]
    numbers = {"failed_jobs": float(len(outs) - len(good)),
               "total_z": None, "cell_z2_dev": None,
               "cell_max_surprise": None}
    if sampled:
        (numbers["total_z"], numbers["cell_z2_dev"],
         numbers["cell_max_surprise"]) = J.binomial_numbers(
            [x["counts"] for x in sampled], p,
            int(cell["traffic_data"]["rays_per_position"]), math.inf, n_ref,
            hits_var)
    return numbers, {"exit_fraction_ref": exit_fraction}
