"""Everything BENCHMARK.json names is there, and the file keeps to the
benchmark's contract."""
import importlib
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert NAME.match(conf["name"])
    with open(harness.ROOT / conf["file"]) as fp:
        data = json.load(fp)
    assert data["reduced"] == conf["reduced"]
    assert data["accuracy"] and data["precision"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    _, config, traffic = harness.load_cell(BENCH, cell["name"])
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    for fn in ("setup", "window", "trace_unit", "release", "check",
               "control"):
        assert callable(getattr(entry, fn))
    assert len(cell["why"]) <= 200
    kinds = {"end_to_end": 0, "per_layer": 0}
    for kind in kinds:
        kinds[kind] = len(harness.metrics_of(BENCH, cell["name"], kind))
    assert kinds["end_to_end"] >= 2 and kinds["per_layer"] >= 1


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert callable(harness.load_metric(m["name"]).read)
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "moves" in m:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    if m["name"].endswith("_roofline"):
        kernel = m["name"][:-len("_roofline")]
        assert importlib.import_module(f"portbench.roofline.{kernel}").work


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
