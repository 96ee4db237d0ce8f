"""Job kinds: what one job of a traffic mix runs, and how the jobs of a
window are judged.  A traffic file names its kind (``"job"``); the
harness imports ``portbench.jobs.<kind>``, which defines

- ``Program(cell, device)``: the program's side.  ``rays`` is the rays
  one job traces; ``run(gen, i, spans)`` runs job ``i`` from the CPU key
  ``gen`` through the port's library entries and returns an ``Out``;
  ``neutral(payload)`` turns a sampled job's payload into plain tensors.
- ``Control(cell, device)``: the reference in the nearest lower precision
  in the program's place, with the same interface (for the calibration
  runs and the tests; the benchmark's runs never build it).
- ``judge(cell, outs, sampled, gen, device) -> (numbers, facts)``: the
  numbers compared with the cell's limits, and what the per-layer readers
  may take from the check (the reference's exit fraction).

This module holds what the kinds share: the configuration's program
objects, the port-exit extraction and the trace-once judgement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import judge as J
from .. import reference


@dataclasses.dataclass
class Out:
    """One job's record: whether it passed its own checks (no overflow,
    no exception), the rays it traced, its port exits, and what a sampled
    job keeps for the judgement."""

    ok: bool
    rays: int
    n_exit: int = 0
    payload: Any = None
    error: str | None = None
    repeat: bool = False     # a pool's job run again in this window


def program_objects(cell: dict):
    """The port's scene, source, grid and trace configuration of the
    cell's configuration file."""
    from altair_tpu_torch import (DetectorGrid, SphereScene, Source,
                                  SurfaceModel, TraceConfig)

    cfg = cell["config_data"]
    scene_kw = dict(cfg["scene"])
    law = SurfaceModel[scene_kw.pop("surface_model")]
    scene = SphereScene(surface_model=law, **scene_kw)
    source = Source(**cfg["source_point"])
    grid = DetectorGrid(**cfg["grid"])
    if cfg["dtype"] != "float32":
        raise ValueError("the cells run the port's float32 path")
    return scene, source, grid, TraceConfig(dtype=torch.float32)


def program_exits(res, port_z: float) -> dict:
    """A program ``TraceResult``'s port exits as plain ``[k, 3]`` tensors
    (the reference's exit test: EXITED with the last point below the
    port plane)."""
    from altair_tpu_torch.core import EXITED

    mask = (res.status == EXITED) & (res.last_point.z < port_z)
    return {"seg": res.seg_start.stack()[mask],
            "last": res.last_point.stack()[mask],
            "dir": res.direction.stack()[mask],
            "nb": res.n_bounces[mask]}


def reference_exits(ex: reference.Exits, port_z: float) -> dict:
    seg, last, d, nb = J.exits_from_reference(ex, port_z)
    return {"seg": seg, "last": last, "dir": d, "nb": nb}


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of the CPU key."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def judge_trace(cell: dict, outs, sampled, gen, device, with_map: bool):
    """The trace layer's numbers (and the scorer's, ``with_map``) for a
    window of trace-once maps or traces: ``exit_z`` over every distinct job,
    ``exit_chi2_z``, ``segment_err_cm`` and ``map_cell_diff`` over the
    sampled ones, ``failed_jobs``."""
    cfg = cell["config_data"]
    port_z = float(cfg["scene"]["exit_port_z"])
    ref = reference.trace(cfg["scene"], cfg["source_point"],
                          int(cell["ref_rays"]), gen, torch.float64, device)
    rx = reference_exits(ref, port_z)
    good = [o for o in outs if o.ok]
    numbers = {"failed_jobs": float(len(outs) - len(good))}
    # each distinct job once: a pool's repeat draws the same rays
    good = [o for o in good if not o.repeat]
    n_p = sum(o.rays for o in good)
    numbers["exit_z"] = (J.exit_z(sum(o.n_exit for o in good), n_p,
                                  rx["seg"].shape[0], ref.n_rays)
                         if n_p else None)
    segs, dirs, seg_err, diff = [], [], 0.0, 0.0
    for x in sampled:
        segs.append(x["seg"])
        dirs.append(x["dir"])
        seg_err = max(seg_err, J.segment_err_cm(
            x["seg"], x["last"], x["dir"], x["nb"], cfg["scene"],
            cfg["source_point"]))
        if with_map:
            counts, _ = reference.score(x["seg"], x["dir"], cfg["grid"],
                                        port_z, pair_block=1 << 26)
            diff = max(diff, J.map_cell_diff(x["counts"], counts))
    if sampled:
        cap_z = float(cfg["scene"]["inner_radius"]) * math.cos(
            math.radians(float(cfg["scene"]["theta_max_deg"])))
        numbers["exit_chi2_z"] = J.exit_chi2_z(torch.cat(segs),
                                               torch.cat(dirs), rx["seg"],
                                               rx["dir"], cap_z)
    else:
        numbers["exit_chi2_z"] = None
    numbers["segment_err_cm"] = seg_err if sampled else None
    if with_map:
        numbers["map_cell_diff"] = diff if sampled else None
    facts = {"exit_fraction_ref": rx["seg"].shape[0] / ref.n_rays}
    return numbers, facts
