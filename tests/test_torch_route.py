"""The port's route table (``core/route.py::plan``): the route of each
benchmark cell's configuration at its traffic's size, and of the scenes
and settings no cell runs (float64, a scatter callable about the waves
threshold, path history, a thick rim under each engine, a series whose
members plan different rim capacities)."""

import json
import os

import pytest
import torch

from altair_tpu_torch import SphereScene, SurfaceModel, TraceConfig
from altair_tpu_torch.core.route import WAVES_MIN, Route, plan
from altair_tpu_torch.core.sampling import cosine_hemisphere

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench", "configs")


def _scene(name, **kw):
    with open(os.path.join(CONFIGS, f"{name}.json")) as fh:
        fields = dict(json.load(fh)["scene"])
    law = SurfaceModel[fields.pop("surface_model")]
    return SphereScene(surface_model=law, **fields).with_(**kw)


def _callable_law(gen, incident, normal, scene):
    return cosine_hemisphere(gen, normal)


F64 = TraceConfig(dtype=torch.float64)
OPT = _scene("optimize170")
MIX = _scene("mixedbrdf170")
THICK = OPT.with_(outer_radius=110.0)
HOOK = MIX.with_(surface_model=_callable_law)


@pytest.mark.parametrize("scenes,cfg,n,want", [
    # the cells: binomial (6.4M shared rays), map100k, trace4M and a
    # disk_retrace chunk of 8 disks x 100k rays
    ([OPT], TraceConfig(), 6_400_000, Route("direct", 4, "hybrid")),
    ([OPT], TraceConfig(), 100_000, Route("direct", 4, "hybrid")),
    ([MIX], TraceConfig(), 100_000, Route("bounce", 4, "kernel")),
    ([MIX], TraceConfig(), 4_194_304, Route("refill", 4, "kernel")),
    ([_scene("insphere105")], TraceConfig(), 800_000,
     Route("finish", None, None)),
    # float64: the direct sampler keeps the hybrid, the rest the loops
    ([OPT], F64, 100_000, Route("direct", 4, "hybrid")),
    ([MIX], F64, 100_000, Route("eager", 4, "eager")),
    ([MIX.with_(exact_rim=False)], F64, 100_000, Route("eager", None, None)),
    # a scatter callable: the waves tracer from WAVES_MIN rays
    ([HOOK], TraceConfig(), WAVES_MIN, Route("waves", 4, "eager")),
    ([HOOK], TraceConfig(), WAVES_MIN - 1, Route("eager", 4, "eager")),
    # history: the eager trace_rays, rim in the loop
    ([OPT], TraceConfig(keep_history=4), 64, Route("eager", None, None)),
    ([MIX], TraceConfig(keep_history=4, engine="simulate"), 64,
     Route("eager", None, None)),
    # a thick rim: one finish launch from the source, or the loops
    ([THICK], TraceConfig(), 100_000, Route("finish", None, None)),
    ([THICK], TraceConfig(engine="simulate"), 100_000,
     Route("finish", None, None)),
    ([THICK], F64, WAVES_MIN, Route("waves", None, None)),
    ([OPT], TraceConfig(engine="simulate"), 100_000,
     Route("bounce", 4, "kernel")),
    # a series: the largest rim buffer any member plans; a thick member
    # sends every member to the in-loop rim
    ([OPT, OPT.with_(theta_max_deg=178.0)], TraceConfig(), 100_000,
     Route("direct", 4, "hybrid")),
    ([OPT.with_(theta_max_deg=178.0)], TraceConfig(), 100_000,
     Route("direct", 5, "hybrid")),
    ([MIX, MIX.with_(outer_radius=110.0)], TraceConfig(), 100_000,
     Route("finish", None, None)),
], ids=["optimize170.binomial", "optimize170.100k", "mixedbrdf170.map100k",
        "mixedbrdf170.trace4M", "insphere105.disk_retrace", "float64.direct",
        "float64.eager", "float64.simple", "callable.waves",
        "callable.eager", "history.auto", "history.simulate", "thick.auto",
        "thick.simulate", "thick.float64", "simulate.lambertian",
        "series.shifts", "optimize178", "series.thick_member"])
def test_plan(scenes, cfg, n, want):
    assert plan(scenes, cfg, n) == want


@pytest.mark.parametrize("scene,cfg,error", [
    (THICK, TraceConfig(engine="direct"), NotImplementedError),
    (MIX, TraceConfig(engine="direct"), NotImplementedError),
    (OPT, TraceConfig(engine="direct", keep_history=4), ValueError),
    (OPT, TraceConfig(engine="fast"), ValueError),
], ids=["thick", "mixed_brdf", "history", "unknown_engine"])
def test_plan_refuses(scene, cfg, error):
    with pytest.raises(error):
        plan([scene], cfg, 1024)
