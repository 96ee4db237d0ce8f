"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``
from the repository's root.  They import the port (CPU torch) and never
JAX."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_cell():
    """A cell of ``BENCHMARK.json`` cut to a size the CPU runs in
    seconds: an 18 x 9 grid, a few thousand rays a job, 30,000 reference
    rays.  The limits are the cell's own."""
    from portbench.harness import load_cell

    def make(name: str) -> dict:
        cell = load_cell(ROOT, name)
        grid = cell["config_data"]["grid"]
        grid["n_theta"], grid["n_phi"] = 18, 9
        t = cell["traffic_data"]
        if t["job"] == "trace":
            # a whole trace job is one sample of the exit fraction: at
            # 12,000 rays a batch with half its rays dropped reads z ~ 40
            t["rays"] = 12000
        elif "rays" in t:
            t["rays"] = 3000
        else:
            t["rays_per_position"], t["oversample"] = 2000, 4
        cell["ref_rays"] = 30000
        cell["sample_jobs"] = 4
        return cell

    return make
