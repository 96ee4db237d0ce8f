"""Every file of the benchmark parses, names what exists, and keeps to the
characters the benchmark's contract allows."""

import json
import re

import pytest

from portbench.harness import HERE, load_cell, metric_reader

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "map_s", "rays_per_s", "setup_s"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == entry["name"] == entry["file"].split("/")[-1][:-5]
    assert data["source"] == entry["source"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    assert all(NAME.match(k) for k in entry["reduced"])
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = load_cell(ROOT, name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert NAME.match(name) and NAME.match(entry["traffic"])
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert entry["why"] == cell["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    assert (HERE / "jobs" / f"{cell['traffic_data']['job']}.py").exists()
    assert cell["limits"]["failed_jobs"] == 0
    # every cell reports setup_s, another end-to-end metric, and a
    # per-layer metric that moves one of them
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    assert all(m["moves"] in e2e for m in cell["per_layer"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_file(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    reader = metric_reader(m["name"])
    assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
    if "layer" in m:
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert set(m["workloads"]) <= set(CELLS)


def test_layer_names_are_one_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert set(layers) == {"trace", "score", "kernels", "device"}


def test_no_card_no_result(capsys):
    """Without a CUDA card a run exits non-zero and prints no result."""
    from portbench import harness

    rc = harness.main(["--workload", CELLS[0], "--seed", str(2 ** 40),
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_module_after_the_window_no_result(monkeypatch, capsys):
    """A process that holds a JAX module once the window has closed exits
    non-zero, prints no result and names the module."""
    import sys
    import types

    import torch

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def fake_run(*args, **kwargs):
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(harness, "run_cell", fake_run)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    threads = torch.get_num_threads()
    try:
        rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"])
    finally:
        sys.modules.pop("jaxlib", None)
        torch.set_num_threads(threads)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jaxlib" in out.err
