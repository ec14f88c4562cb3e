"""BENCHMARK.json names only what its files hold, in the contract's
shape."""
import json
import re

import pytest
from conftest import REPO

from cardbench.core.specs import Specs

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPECS = Specs([REPO])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_to_its_files(w):
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len(w["why"]) <= 200
    cell = SPECS.json("cells", w["name"])
    SPECS.path("loops", cell["loop"], ".py")
    traffic = SPECS.json("traffic", w["traffic"])
    SPECS.path("traffic", traffic["generator"], ".py")
    cfg = SPECS.json("configs", w["config"])
    SPECS.path("scenes", cfg["scene"]["generator"], ".py")
    assert cfg["name"] == w["config"]
    assert set(cell["check"]["limits"]) <= {"t_gap", "claim_gap",
                                            "missed_by", "bary_gap",
                                            "tri_gap"}


# The traffic parameter that counts a loop's slots: a query loop cycles
# through its ray batches, a frame loop through its transform sets.
SLOTS = {"query": "batches", "frame": "sets"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_warms_each_slot_and_traces_enough_calls(w):
    """Set-up visits every slot once, so no window call is the first on
    its slot (the allocator grows its pool there), and the traced part
    spans enough calls to read a per-call figure from."""
    cell = SPECS.json("cells", w["name"])
    slots = SPECS.json("traffic", w["traffic"])["params"][SLOTS[cell["loop"]]]
    assert cell["warm_calls"] >= slots
    assert cell["trace"]["calls"] >= 8


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_resolves_to_its_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"cardbench/configs/{c['name']}.json"
    assert (REPO / c["file"]).is_file()
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert c["reduced"] == json.loads((REPO / c["file"]).read_text())[
        "reduced"]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_resolves_to_its_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(SPECS.module("metrics", m["name"]).read)
    for w in m.get("workloads", []):
        SPECS.workload(w)


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", cells)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in cells:
        assert SPECS.metrics(w, traced=False)
        assert SPECS.metrics(w, traced=True)
